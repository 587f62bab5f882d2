"""Port vs JAX package: the MoE layer (routing, capacity, dispatch, aux).

Both packages run on the CPU on the same weights (drawn by the JAX package,
carried across as numpy arrays) and the same inputs (numpy, from a seed).
The routing decisions JAX makes inside ``moe`` are recomputed here with its
own ops (router einsum, ``jax.nn.softmax``, ``jax.lax.top_k``, the
exclusive cumsum) and must equal the port's exactly; outputs within rtol /
atol 1e-5 in float32, the aux term within rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig
from repro.models.param import tree_materialize as jmaterialize
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig as TConfig

BASE = dict(arch_id="t", family="moe", num_layers=1, d_model=64, num_heads=2,
            num_kv_heads=2, d_ff=64, vocab_size=64, num_experts=8, experts_per_token=2,
            d_ff_expert=48, param_dtype="float32", compute_dtype="float32")


# The reference compiled once per shape, not dispatched op by op.
j_moe = jax.jit(jmoe.moe, static_argnames=("cfg", "mesh"))


def _cfgs(**over):
    kw = {**BASE, **over}
    return JConfig(**kw), TConfig(**kw)


def _t(a) -> torch.Tensor:
    """A host tensor with ``a``'s bits (bfloat16 through int16)."""
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _params(jcfg, seed=0):
    jp = jmaterialize(jmoe.moe_spec(jcfg), jax.random.key(seed))
    return jp, {k: _t(v) for k, v in jp.items()}


def _jax_routing(jp, x, cfg, C):
    """JAX's routing decisions for x (N, D), by the ops ``repro.models.moe.moe`` uses."""
    E = cfg.num_experts
    logits = jnp.einsum("nd,de->ne", x, jp["router"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    top_p, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.experts_per_token)
    flat = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(-1, E)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1).reshape(top_e.shape)
    return logits, top_e, pos, pos < C


@pytest.mark.parametrize("cf,B,S", [(16.0, 2, 8), (0.25, 2, 32), (1.25, 3, 40)])
def test_moe_matches_jax_with_and_without_drops(cf, B, S):
    jcfg, tcfg = _cfgs(moe_capacity_factor=cf)
    jp, tp = _params(jcfg)
    x = (np.random.default_rng(int(cf * 100) + S).standard_normal((B, S, 64)) * 0.5
         ).astype(np.float32)
    out_j, aux_j = j_moe(jp, jnp.asarray(x), jcfg)
    out_t, aux_t = tmoe.moe(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-6)
    assert aux_t.dtype == torch.float32

    C = tmoe.capacity(B * S, tcfg)
    assert C == jmoe.capacity(B * S, jcfg)
    _, top_e, pos, keep = _jax_routing(jp, jnp.asarray(x.reshape(-1, 64)), jcfg, C)
    r = tmoe.route(tp, torch.from_numpy(x.reshape(-1, 64)), tcfg, C)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(r.pos.numpy(), np.asarray(pos))
    np.testing.assert_array_equal(r.keep.numpy(), np.asarray(keep))
    if cf == 0.25:
        assert not bool(r.keep.all()), "the low capacity drops slots"
    if cf == 16.0:
        assert bool(r.keep.all())


def test_bf16_router_logits_keep_the_float32_accumulation():
    jcfg, tcfg = _cfgs(num_experts=128, experts_per_token=8, d_model=512,
                       param_dtype="bfloat16", compute_dtype="bfloat16")
    jp, _ = _params(jcfg, seed=3)
    router = np.asarray(jp["router"])  # float32 in a bf16 model
    assert router.dtype == np.float32
    x = jnp.asarray(np.random.default_rng(4).standard_normal((256, 512)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    logits_j, top_e_j, _, _ = _jax_routing(jp, x, jcfg, 8)
    xt = _t(x)
    router_t = {"router": _t(router)}
    logits_t = tmoe.router_logits(router_t, xt)
    assert logits_t.dtype == torch.float32
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), rtol=1e-6, atol=1e-6)
    r = tmoe.route(router_t, xt, tcfg, 8)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(top_e_j))
    # A product in bf16 would round the logits to bf16 (~3 significant digits).
    rounded = (xt @ router_t["router"].to(torch.bfloat16)).float()
    assert float((rounded - logits_t).abs().max()) > 1e-3


@pytest.mark.parametrize("N", [1, 4, 7, 64, 1000, 8192, 2 ** 20])
@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (16, 2, 0.25), (128, 8, 1.25),
                                    (128, 8, 16.0), (8, 1, 2.0)])
def test_capacity_equals_jax(N, E, K, cf):
    over = dict(num_experts=E, experts_per_token=K, moe_capacity_factor=cf)
    jcfg, tcfg = _cfgs(**over)
    assert tmoe.capacity(N, tcfg) == jmoe.capacity(N, jcfg)
    assert tmoe.capacity(N, tcfg) % 8 == 0 and tmoe.capacity(N, tcfg) >= 8


def test_full_width_capacities():
    """qwen3-moe-30b-a3b's prefill of 4 x 2048 tokens and its decode of 4."""
    from repro_torch.configs import get_config

    cfg = get_config("qwen3-moe-30b-a3b")
    assert tmoe.capacity(4 * 2048, cfg) == 648
    assert tmoe.capacity(4, cfg) == 8
    assert tmoe.capacity(4 * 2048, dataclasses.replace(cfg, moe_capacity_factor=16.0)) > 4 * 2048


def test_moe_gradients_match_jax():
    jcfg, tcfg = _cfgs(moe_capacity_factor=1.25)
    jp, tp = _params(jcfg, seed=5)
    x = (np.random.default_rng(6).standard_normal((2, 16, 64)) * 0.5).astype(np.float32)

    def jloss(p, x_):
        out, aux = j_moe(p, x_, jcfg)
        return jnp.sum(jnp.square(out)) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe(tp, tx, tcfg)
    (torch.sum(out * out) + aux).backward()
    # rtol 1e-4, and atol 1e-6 of the leaf's largest entry: the router's
    # gradient (entries up to ~500) is a float32 sum with cancellations.
    for name, got, want in [(k, tp[k].grad, jg[k]) for k in tp] + [("x", tx.grad, jgx)]:
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()), err_msg=name)
