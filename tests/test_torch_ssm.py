"""Port vs JAX package: the Mamba2 (SSD) layer.

Both packages run on the CPU on the JAX package's weights (carried across
as numpy arrays) and inputs made with numpy from a seed: the chunked
``ssm_forward`` with its cache (S below the conv window, ragged, one chunk,
several chunks of 256), three ``ssm_decode_step``s after it, chunk-size
invariance and the chunked form against the recurrence. Tolerances rtol
1e-4 / atol 2e-5, those of the JAX package's own ``tests/test_ssm.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro.models.config import ModelConfig as JConfig
from repro.models.param import tree_materialize as jmaterialize
from repro_torch.models import ssm as tssm
from repro_torch.models.config import ModelConfig as TConfig

RTOL, ATOL = 1e-4, 2e-5
# The references compiled once per shape, not dispatched op by op.
j_forward = jax.jit(jssm.ssm_forward, static_argnames=("cfg", "mesh", "return_cache"))
j_decode = jax.jit(jssm.ssm_decode_step, static_argnames=("cfg", "mesh"))
BASE = dict(arch_id="t", family="ssm", num_layers=1, d_model=64, num_heads=1,
            num_kv_heads=1, d_ff=0, vocab_size=128, ssm_state=16, ssm_expand=2,
            ssm_head_dim=32, param_dtype="float32", compute_dtype="float32")


def _cfgs(**over):
    kw = {**BASE, **over}
    return JConfig(**kw), TConfig(**kw)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _params(jcfg, seed=0):
    """JAX weights with the zero/one-initialized leaves made generic (the
    decay rates, the step bias, the skip and the conv bias), so that every
    term of the layer is exercised."""
    jp = jmaterialize(jssm.ssm_spec(jcfg), jax.random.key(seed))
    rng = np.random.default_rng(seed)
    H, CC = jcfg.ssm_heads, jcfg.d_inner + 2 * jcfg.ssm_state
    jp = dict(jp, A_log=jnp.asarray(rng.uniform(-1.0, 1.0, H).astype(np.float32)),
              dt_bias=jnp.asarray(rng.uniform(-2.0, 0.5, H).astype(np.float32)),
              D_skip=jnp.asarray(rng.uniform(0.5, 1.5, H).astype(np.float32)),
              conv_b=jnp.asarray((rng.standard_normal(CC) * 0.1).astype(np.float32)))
    tp = jax.tree.map(_t, jp)
    return jp, tp


def _x(B, S, D, seed, dtype=np.float32):
    return (np.random.default_rng(seed).standard_normal((B, S, D)) * 0.5).astype(dtype)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("S,chunk", [(2, 256), (3, 256), (21, 8), (64, 64), (64, 8),
                                     (300, 256)])
def test_forward_cache_and_decode_match_jax(S, chunk):
    jcfg, tcfg = _cfgs(ssm_chunk=chunk)
    jp, tp = _params(jcfg, seed=S)
    x = _x(2, S + 3, 64, seed=S + 1)
    yj, cj = j_forward(jp, jnp.asarray(x[:, :S]), jcfg, return_cache=True)
    yt, ct = tssm.ssm_forward(tp, _t(x[:, :S]), tcfg, return_cache=True)
    assert yt.shape == (2, S, 64) and ct.conv.shape == (2, 3, 128 + 32)
    assert ct.state.dtype == torch.float32
    _close(yt, yj)
    _close(ct.conv, cj.conv)
    _close(ct.state, cj.state)
    if S < tcfg.ssm_conv_width - 1:
        assert float(ct.conv[:, :tcfg.ssm_conv_width - 1 - S].abs().max()) == 0.0
    for i in range(3):  # three decode steps from the prefill's cache
        xs = x[:, S + i:S + i + 1]
        yj, cj = j_decode(jp, jnp.asarray(xs), cj, jcfg)
        yt, ct2 = tssm.ssm_decode_step(tp, _t(xs), ct, tcfg)
        assert ct2 is ct  # written in place
        _close(yt, yj)
        _close(ct.conv, cj.conv)
        _close(ct.state, cj.state)


def test_bf16_layer_keeps_the_jax_dtypes():
    """bf16 weights and input: the conv promotes to float32, ``y`` returns to
    bf16 before the gate; output and cache dtypes as JAX's, values within
    bf16 rounding."""
    jcfg, tcfg = _cfgs(param_dtype="bfloat16", compute_dtype="bfloat16", ssm_chunk=16)
    jp, tp = _params(jcfg, seed=11)
    x = jnp.asarray(_x(2, 40, 64, seed=12)).astype(jnp.bfloat16)
    yj, cj = j_forward(jp, x, jcfg, return_cache=True)
    yt, ct = tssm.ssm_forward(tp, _t(x), tcfg, return_cache=True)
    assert yt.dtype == torch.bfloat16 and str(yj.dtype) == "bfloat16"
    assert ct.conv.dtype == torch.bfloat16 and ct.state.dtype == torch.float32
    _close(yt, np.asarray(yj.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
    _close(ct.state, cj.state, rtol=2e-2, atol=2e-3)
    np.testing.assert_array_equal(ct.conv.view(torch.int16).numpy(),
                                  np.asarray(cj.conv).view(np.int16))


def test_softplus_has_no_linear_switch():
    x = torch.tensor([-30.0, -1.0, 0.0, 1.0, 19.0, 25.0, 60.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(tssm._softplus(x).numpy(), want)


def test_chunk_size_invariance():
    x = _t(_x(1, 48, 64, seed=2))
    outs = []
    for chunk in (4, 12, 48):
        jcfg, tcfg = _cfgs(ssm_chunk=chunk)
        outs.append(tssm.ssm_forward(_params(jcfg)[1], x, tcfg))
    for o in outs[1:]:
        _close(o, outs[0].numpy())


def test_chunked_form_equals_the_recurrence():
    jcfg, tcfg = _cfgs(ssm_chunk=8)
    _, tp = _params(jcfg, seed=4)
    x = _t(_x(2, 21, 64, seed=5))
    y_full = tssm.ssm_forward(tp, x, tcfg)
    cache = tssm.ssm_init_cache(tcfg, 2, torch.float32, torch.device("cpu"))
    ys = [tssm.ssm_decode_step(tp, x[:, t:t + 1], cache, tcfg)[0] for t in range(21)]
    _close(torch.cat(ys, 1), y_full.numpy())
    with pytest.raises(ValueError, match="one token"):
        tssm.ssm_decode_step(tp, x[:, :2], cache, tcfg)


def test_init_cache_matches_jax():
    jcfg, tcfg = _cfgs()
    jc = jssm.ssm_init_cache(jcfg, 3, jnp.bfloat16)
    tc = tssm.ssm_init_cache(tcfg, 3, torch.bfloat16, torch.device("cpu"))
    assert tuple(tc.conv.shape) == jc.conv.shape and tc.conv.dtype == torch.bfloat16
    assert tuple(tc.state.shape) == jc.state.shape and tc.state.dtype == torch.float32
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.d_inner, tcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
