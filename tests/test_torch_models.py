"""Port vs JAX package: config, parameter plan, layers, attention and model.

Both packages run on the CPU at a narrow qwen3-shaped config built by the
same ``dataclasses.replace``: d_model 256, 10 heads over 2 KV heads
(G = 5, as qwen3-14b's 40 over 8), head_dim 64, qk_norm, d_ff 512, vocab 512,
2 layers, float32. (``reduced()`` would give G = 1.) Weights are the JAX
package's, carried across by ``convert.params_from_arrays``; other inputs
are made with numpy from a seed. Tolerances: the layers rtol 1e-5 /
atol 1e-5; attention, prefill and decode rtol 1e-4 / atol 1e-4 (float32
products summed in other orders, the blocked flash against the plain one).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import param as jparam
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models import param as tparam

NARROW = dict(d_model=256, num_heads=10, num_kv_heads=2, head_dim=64, d_ff=512,
              vocab_size=512, num_layers=2, param_dtype="float32",
              compute_dtype="float32")
RTOL = ATOL = 1e-4


def _cfgs(**extra):
    over = {**NARROW, **extra}
    return (dataclasses.replace(jget_config("qwen3-14b"), **over),
            dataclasses.replace(tget_config("qwen3-14b"), **over))


@pytest.fixture(scope="module")
def narrow():
    jcfg, tcfg = _cfgs()
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(0))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_config_fields_equal_the_jax_config():
    jcfg, tcfg = jget_config("qwen3-14b"), tget_config("qwen3-14b")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert tcfg.stages()[0][1] == jcfg.stages()[0][1] == 40
    assert tcfg.pdtype == torch.bfloat16 and tcfg.cdtype == torch.bfloat16


def test_unported_configs_raise_naming_the_roadmap():
    with pytest.raises(KeyError, match="ROADMAP A7"):
        tget_config("gemma3-27b")
    with pytest.raises(KeyError, match="unknown arch"):
        tget_config("no-such-model")


def test_qwen3_14b_parameter_count_without_allocating():
    spec = tmodel.model_spec(tget_config("qwen3-14b"))
    assert tparam.num_params(spec) == 14_768_307_200
    assert tparam.num_params(spec) == jparam.num_params(
        jmodel.model_spec(jget_config("qwen3-14b")))


def test_parameter_plan_and_init_std_follow_the_jax_rule():
    jcfg, tcfg = _cfgs()
    jflat = dict(jax.tree_util.tree_flatten_with_path(
        jmodel.model_spec(jcfg), is_leaf=lambda x: isinstance(x, jparam.ParamSpec))[0])
    jspecs = {".".join(k.key for k in path): s for path, s in jflat.items()}
    tspecs = dict(tparam.tree_leaves_with_path(tmodel.model_spec(tcfg)))
    assert set(jspecs) == set(tspecs)
    params = tparam.tree_materialize(tmodel.model_spec(tcfg),
                                     torch.Generator().manual_seed(0), "cpu")
    values = dict(tparam.tree_leaves_with_path(params))
    for path, js in jspecs.items():
        ts = tspecs[path]
        assert ts.shape == js.shape and ts.init == js.init and ts.axes == js.axes, path
        if js.init != "normal":
            continue
        fan_in = js.shape[0] if len(js.shape) > 1 else js.shape[-1]
        want = js.scale if js.scale is not None else 1 / math.sqrt(fan_in)
        assert tparam.init_std(ts) == pytest.approx(want, rel=1e-12), path
        got = float(values[path].double().std())
        assert got == pytest.approx(want, rel=0.05), path
    # The stacked leaves draw with the layer count as fan-in (param.py:90).
    assert tparam.init_std(tspecs["stage0.pos0.attn.wq"]) == pytest.approx(2**-0.5)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_params_from_arrays_is_bit_for_bit(pdtype):
    jcfg, tcfg = _cfgs(param_dtype=pdtype)
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(0))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = dict(tparam.tree_leaves_with_path(tp))
    assert len(jleaves) == len(tleaves)
    for path, a in jleaves:
        t = tleaves[".".join(k.key for k in path)]
        a = np.asarray(a)
        if pdtype == "bfloat16" and a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), a)
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_arrays({"embed": jp["embed"]}, tcfg, device="cpu")


def test_rmsnorm_rope_mlp_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    got = tlayers.rmsnorm({"scale": _t(scale)}, _t(x))
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    pos = np.tile(np.arange(7, dtype=np.int32) + 1000, (2, 1))
    got = tlayers.rope(_t(x), _t(pos), 1_000_000.0)
    want = jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    w = {n: rng.standard_normal(s).astype(np.float32) * 0.1
         for n, s in (("gate", (64, 96)), ("up", (64, 96)), ("down", (96, 64)))}
    h = x[:, :, 0]
    got = tlayers.mlp({n: _t(a) for n, a in w.items()}, _t(h))
    want = jlayers.mlp({n: jnp.asarray(a) for n, a in w.items()}, jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_attention_prefill_and_decode_match_jax(narrow):
    jcfg, tcfg, jp, tp = narrow
    ja, ta = jp["stage0"]["pos0"]["attn"], tp["stage0"]["pos0"]["attn"]
    ja = jax.tree.map(lambda a: a[0], ja)
    ta = tparam.tree_map(lambda a: a[0], ta)
    rng = np.random.default_rng(2)
    B, S, S_max = 2, 33, 40
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    out_j, (k_j, v_j) = jattn.attention(ja, jnp.asarray(x), jcfg, positions=jnp.arange(S),
                                        window=None, return_kv=True)
    out_t, (k_t, v_t) = tattn.attention(ta, _t(x), tcfg, positions=torch.arange(S),
                                        window=None, return_kv=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), rtol=RTOL, atol=ATOL)

    # One decode step at position S against a cache holding the prompt.
    pad = ((0, 0), (0, S_max - S), (0, 0), (0, 0))
    kc, vc = np.pad(np.asarray(k_j), pad), np.pad(np.asarray(v_j), pad)
    x1 = rng.standard_normal((B, 1, 256)).astype(np.float32)
    pos = np.full((B, 1), S, np.int32)
    out_j, (kc_j, _) = jattn.attention(ja, jnp.asarray(x1), jcfg, positions=jnp.asarray(pos),
                                       window=None, cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                       cache_len=jnp.int32(S + 1))
    out_t, (kc_t, _) = tattn.attention(ta, _t(x1), tcfg, positions=_t(pos), window=None,
                                       cache=(_t(kc.copy()), _t(vc.copy())),
                                       cache_len=S + 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(kc_t.numpy(), np.asarray(kc_j), rtol=RTOL, atol=ATOL)


def test_windows_and_softcaps_raise_on_every_device(narrow):
    _, tcfg, _, tp = narrow
    ta = tparam.tree_map(lambda a: a[0], tp["stage0"]["pos0"]["attn"])
    x = torch.zeros(1, 4, 256)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        tattn.attention(ta, x, tcfg, positions=torch.arange(4), window=8)
    capped = dataclasses.replace(tcfg, attn_logit_softcap=50.0)
    with pytest.raises(NotImplementedError, match="softcap"):
        tattn.attention(ta, x, capped, positions=torch.arange(4), window=None)


def test_prefill_and_three_decode_steps_match_jax(narrow):
    jcfg, tcfg, jp, tp = narrow
    rng = np.random.default_rng(3)
    B, S, max_seq = 2, 21, 25
    tokens = rng.integers(0, 512, (B, S)).astype(np.int32)
    lj, cj, plen = jmodel.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, max_seq=max_seq)
    lt, ct, plen_t = tmodel.prefill(tp, {"tokens": _t(tokens).long()}, tcfg, max_seq=max_seq)
    assert plen == plen_t == S
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(ct[0]["pos0"], name).numpy(),
                                   np.asarray(getattr(cj[0]["pos0"], name)),
                                   rtol=RTOL, atol=ATOL)
    tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    for i in range(3):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cj = jmodel.decode_step(jp, tok_j, cj, jnp.int32(plen + 1 + i), jcfg)
        lt, ct = tmodel.decode_step(tp, tok_t, ct, plen + 1 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
        tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    np.testing.assert_allclose(ct[0]["pos0"].k.numpy(), np.asarray(cj[0]["pos0"].k),
                               rtol=RTOL, atol=ATOL)


def test_decode_from_empty_caches_matches_a_one_token_prefill(narrow):
    jcfg, tcfg, jp, tp = narrow
    B, max_seq = 2, 6
    jc = jmodel.init_caches(jcfg, B, max_seq, jnp.float32)
    tc = tmodel.init_caches(tcfg, B, max_seq, torch.float32, "cpu")
    assert tc[0]["pos0"].k.shape == jc[0]["pos0"].k.shape == (2, B, max_seq, 2, 64)
    token = np.array([7, 300], np.int32)
    lj, _ = jmodel.decode_step(jp, jnp.asarray(token), jc, jnp.int32(1), jcfg)
    lt, tc = tmodel.decode_step(tp, _t(token).long(), tc, 1, tcfg)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    lp, _, _ = tmodel.prefill(tp, {"tokens": _t(token[:, None]).long()}, tcfg, max_seq=max_seq)
    np.testing.assert_allclose(lt.numpy(), lp.numpy(), rtol=RTOL, atol=ATOL)
    assert float(tc[0]["pos0"].k[:, :, 1:].abs().max()) == 0.0  # only slot 0 written


# ---------------------------------------------------------------------------
# MoE, SSM and hybrid configs (qwen3-moe, mamba2, jamba).
# ---------------------------------------------------------------------------

# Parameter counts of the full configs, from the plans alone.
NEW_ARCH_PARAMS = {"qwen3-moe-30b-a3b": 30_532_122_624, "qwen3-moe-235b-a22b": 235_093_634_560,
                   "mamba2-780m": 857_379_072, "jamba-1.5-large-398b": 397_711_939_584}
SERVED = ["qwen3-moe-30b-a3b", "mamba2-780m", "jamba-1.5-large-398b"]
# The references compiled once per shape, not dispatched op by op.
j_prefill = jax.jit(jmodel.prefill, static_argnames=("cfg", "max_seq", "mesh", "exploit_window"))
j_decode = jax.jit(jmodel.decode_step, static_argnames=("cfg", "mesh"))


@pytest.mark.parametrize("arch", sorted(NEW_ARCH_PARAMS))
def test_moe_and_ssm_configs_equal_the_jax_configs(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    assert [(len(l), n) for l, n in tcfg.stages()] == [(len(l), n) for l, n in jcfg.stages()]
    assert (tcfg.d_inner, tcfg.ssm_heads, tcfg.has_attention()) == (
        jcfg.d_inner, jcfg.ssm_heads, jcfg.has_attention())
    assert tcfg.supports_long_decode() == jcfg.supports_long_decode()
    n = tparam.num_params(tmodel.model_spec(tcfg))
    assert n == NEW_ARCH_PARAMS[arch] == jparam.num_params(jmodel.model_spec(jcfg))


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge", "gemma3-27b"])
def test_frontend_and_window_configs_still_wait_on_the_roadmap(arch):
    with pytest.raises(KeyError, match="ROADMAP A7"):
        tget_config(arch)


def np_params(cfg, seed: int, fan_in: bool = False) -> dict:
    """Weights for both packages drawn with numpy by the init rule (std
    ``init_std``; with ``fan_in``, every stacked ``normal`` leaf at std
    1/sqrt(its second-to-last dim) instead: a well-conditioned point).
    Quicker than the JAX package's leaf-by-leaf draws; float32 configs only."""
    rng = np.random.default_rng(seed)

    def draw(s):
        if s.init != "normal":
            return np.full(s.shape, 0.0 if s.init == "zeros" else 1.0, np.float32)
        std = tparam.init_std(s)
        if fan_in and s.scale is None and len(s.shape) >= 3:  # the stacked leaves
            std = 1.0 / math.sqrt(s.shape[-2])
        return (rng.standard_normal(s.shape) * std).astype(np.float32)

    return tparam.tree_map(draw, tmodel.model_spec(cfg))


@pytest.fixture(scope="module", params=SERVED)
def reduced(request):
    jcfg, tcfg = jget_config(request.param).reduced(), tget_config(request.param).reduced()
    jp = np_params(tcfg, 0)
    tp = convert.params_from_arrays(jp, tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _assert_caches_close(tc, jc):
    """Every cache leaf within rtol 1e-4 and 1e-4 of the leaf's largest entry:
    at the init rule's weights (stacked leaves drawn with std 1/sqrt(layers))
    an SSD state reaches ~1e4, and float32 rounding scales with it."""
    for ts, js in zip(tc, jc):
        assert set(ts) == set(js)
        for key in ts:
            assert type(ts[key]).__name__ == type(js[key]).__name__, key
            for name in ts[key]._fields:
                want = np.asarray(getattr(js[key], name))
                np.testing.assert_allclose(getattr(ts[key], name).numpy(), want, rtol=RTOL,
                                           atol=ATOL * max(1.0, float(np.abs(want).max())),
                                           err_msg=f"{key}.{name}")


def test_reduced_prefill_and_three_decode_steps_match_jax(reduced):
    jcfg, tcfg, jp, tp = reduced
    B, S, max_seq = 2, 21, 25
    tokens = np.random.default_rng(7).integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    lj, cj, _ = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, max_seq=max_seq)
    lt, ct, _ = tmodel.prefill(tp, {"tokens": _t(tokens).long()}, tcfg, max_seq=max_seq)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    _assert_caches_close(ct, cj)
    tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    for i in range(3):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cj = j_decode(jp, tok_j, cj, jnp.int32(S + 1 + i), jcfg)
        lt, ct = tmodel.decode_step(tp, tok_t, ct, S + 1 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
        tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    _assert_caches_close(ct, cj)
    # init_caches gives the JAX package's cache tree (types, shapes, dtypes).
    jc0 = jmodel.init_caches(jcfg, B, max_seq, jnp.float32)
    tc0 = tmodel.init_caches(tcfg, B, max_seq, torch.float32, "cpu")
    for ts, js in zip(tc0, jc0):
        for key in js:
            assert type(ts[key]).__name__ == type(js[key]).__name__
            for a, b in zip(ts[key], js[key]):
                assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-780m"])
def test_params_from_arrays_carries_moe_and_ssm_trees_bit_for_bit(arch):
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), **over)
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(2))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    tleaves = dict(tparam.tree_leaves_with_path(tp))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(jleaves) == len(tleaves)
    f32 = set()
    for path, a in jleaves:
        name = ".".join(k.key for k in path)
        t, a = tleaves[name], np.asarray(a)
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.numpy(), a)
            f32.add(name.split(".")[-1] if "norm" not in name else name.split(".")[-2])
    want = {"router"} if arch.startswith("qwen3") else {"dt_bias", "A_log", "D_skip",
                                                         "conv_w", "conv_b", "norm"}
    assert want <= f32, f32


def test_jamba_train_loss_with_aux_and_a_moe_gradient_match_jax():
    """At a fan-in init (see ``np_params``): the loss within rtol 1e-5, a MoE
    layer's expert gradient within rtol 1e-4 (atol 1e-5 of its scale)."""
    jcfg, tcfg = jget_config("jamba-1.5-large-398b").reduced(), tget_config(
        "jamba-1.5-large-398b").reduced()
    jp = np_params(tcfg, 3, fan_in=True)
    tp = convert.params_from_arrays(jp, tcfg, device="cpu")
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    leaf = ("stage0", "pos1", "moe", "gate")  # a MoE layer's expert weights

    def jloss(p):
        return jmodel.train_loss(p, jb, jcfg, remat=True)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = tparam.tree_map(lambda t: t.requires_grad_(True), tp)
    tb = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    tv = tmodel.train_loss(tp, tb, tcfg, remat=True)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    got, want = tp, jg
    for k in leaf:
        got, want = got[k], want[k]
    want = np.asarray(want)
    np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
    # The aux term is in the loss, with the JAX package's weight.
    with torch.no_grad():
        nll = tmodel.train_loss(tp, tb, tcfg, aux_weight=0.0)
        with_aux = tmodel.train_loss(tp, tb, tcfg)
    assert float(with_aux - nll) > 0.0
    np.testing.assert_allclose(float(with_aux), float(tv.detach()), rtol=1e-6)
