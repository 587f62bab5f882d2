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

from repro import configs as jconfigs
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import param as jparam
from repro_torch import configs as tconfigs
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
    """Every config of the JAX package is ported (none waits on the ROADMAP
    any more); an unknown arch still raises."""
    assert tconfigs._WAITING == {}
    assert sorted(tconfigs._MODULES) == sorted(jconfigs._MODULES)
    assert dataclasses.asdict(tget_config("gemma3-27b")) == dataclasses.asdict(
        jget_config("gemma3-27b"))
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
    """Neither a window nor a softcap raises any more: the windowed layer and
    a windowed decode step over a linear cache equal JAX's, and so do the
    layer and the decode step (``attend_cache``) with gemma-2's published
    cap of 50, with and without the window."""
    jcfg, tcfg, jp, tp = narrow
    ja = jax.tree.map(lambda a: a[0], jp["stage0"]["pos0"]["attn"])
    ta = tparam.tree_map(lambda a: a[0], tp["stage0"]["pos0"]["attn"])
    rng = np.random.default_rng(4)
    B, S, W = 2, 29, 8
    x = rng.standard_normal((B, S, 256)).astype(np.float32)
    out_j, (k_j, v_j) = jattn.attention(ja, jnp.asarray(x), jcfg, positions=jnp.arange(S),
                                        window=W, block_q=16, block_k=16, return_kv=True)
    out_t, _ = tattn.attention(ta, _t(x), tcfg, positions=torch.arange(S), window=W,
                               return_kv=True)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    full, _ = tattn.attention(ta, _t(x), tcfg, positions=torch.arange(S), window=None)
    assert not torch.allclose(out_t, full, rtol=RTOL, atol=ATOL)
    pad = ((0, 0), (0, 4), (0, 0), (0, 0))
    kc, vc = np.pad(np.asarray(k_j), pad), np.pad(np.asarray(v_j), pad)
    x1 = rng.standard_normal((B, 1, 256)).astype(np.float32)
    pos = np.full((B, 1), S, np.int32)
    out_j, _ = jattn.attention(ja, jnp.asarray(x1), jcfg, positions=jnp.asarray(pos),
                               window=W, cache=(jnp.asarray(kc), jnp.asarray(vc)),
                               cache_len=jnp.int32(S + 1))
    out_t, _ = tattn.attention(ta, _t(x1), tcfg, positions=_t(pos), window=W,
                               cache=(_t(kc.copy()), _t(vc.copy())), cache_len=S + 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    # The cap at inputs a tenth as large: scores of about +-10 (at the init
    # rule's weights x's scores reach the hundreds, C3, and the layer's
    # outputs ~400, where float32 rounding alone passes 1e-4).
    jcap, tcap = (dataclasses.replace(c, attn_logit_softcap=50.0) for c in (jcfg, tcfg))
    xs, x1s = x * np.float32(0.1), x1 * np.float32(0.1)
    for window in (W, None):
        out_j, (k_j, v_j) = jattn.attention(ja, jnp.asarray(xs), jcap,
                                            positions=jnp.arange(S), window=window,
                                            block_q=16, block_k=16, return_kv=True)
        out_t, _ = tattn.attention(ta, _t(xs), tcap, positions=torch.arange(S), window=window)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
        uncapped, _ = tattn.attention(ta, _t(xs), tcfg, positions=torch.arange(S),
                                      window=window)
        assert not torch.allclose(out_t, uncapped, rtol=RTOL, atol=ATOL)
        kc, vc = np.pad(np.asarray(k_j), pad), np.pad(np.asarray(v_j), pad)
        out_j, _ = jattn.attention(ja, jnp.asarray(x1s), jcap, positions=jnp.asarray(pos),
                                   window=window, cache=(jnp.asarray(kc), jnp.asarray(vc)),
                                   cache_len=jnp.int32(S + 1))
        out_t, _ = tattn.attention(ta, _t(x1s), tcap, positions=_t(pos), window=window,
                                   cache=(_t(kc.copy()), _t(vc.copy())), cache_len=S + 1)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
        uncapped, _ = tattn.attention(ta, _t(x1s), tcfg, positions=_t(pos), window=window,
                                      cache=(_t(kc.copy()), _t(vc.copy())), cache_len=S + 1)
        assert not torch.allclose(out_t, uncapped, rtol=RTOL, atol=ATOL)


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
FRONTEND_WINDOW_PARAMS = {"gemma3-27b": 28_417_621_760, "pixtral-12b": 12_273_996_800,
                          "hubert-xlarge": 1_260_698_880}
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
    """The three configs that waited on ROADMAP A7 until the windows and the
    frontends were ported: each equal to JAX's field for field, under
    ``reduced()`` too, with JAX's stages, windows and parameter count."""
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())
    for t, j in ((tcfg, jcfg), (tcfg.reduced(), jcfg.reduced())):
        assert [([l.window for l in lay], n) for lay, n in t.stages()] == [
            ([l.window for l in lay], n) for lay, n in j.stages()]
        assert (t.frontend, t.num_patch_tokens, t.causal, t.supports_decode(),
                t.supports_long_decode(), t.resolved_head_dim) == (
            j.frontend, j.num_patch_tokens, j.causal, j.supports_decode(),
            j.supports_long_decode(), j.resolved_head_dim)
    n = tparam.num_params(tmodel.model_spec(tcfg))
    assert n == FRONTEND_WINDOW_PARAMS[arch] == jparam.num_params(jmodel.model_spec(jcfg))


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


# ---------------------------------------------------------------------------
# Sliding windows and ring caches (gemma3), the vision and audio frontends
# (pixtral, hubert). Weights by ``np_params`` at the fan-in init; the JAX
# references under ``jax.jit``.
# ---------------------------------------------------------------------------

# gemma3-27b narrowed: 4 heads over 2 KV heads (G = 2, as gemma3's 32 over
# 16), head_dim 64, window 16, 8 layers: a period of 5 local + 1 global and
# a 2-layer local remainder stage, as ModelConfig.stages() cuts 62 layers.
GEMMA_NARROW = dict(d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=512,
                    vocab_size=512, num_layers=8, param_dtype="float32",
                    compute_dtype="float32")


def _gemma_cfgs():
    over = dict(GEMMA_NARROW)
    j, t = jget_config("gemma3-27b"), tget_config("gemma3-27b")
    jl = tuple(dataclasses.replace(l, window=16 if l.window else None) for l in j.layout)
    tl = tuple(dataclasses.replace(l, window=16 if l.window else None) for l in t.layout)
    return dataclasses.replace(j, layout=jl, **over), dataclasses.replace(t, layout=tl, **over)


@pytest.fixture(scope="module")
def gemma():
    jcfg, tcfg = _gemma_cfgs()
    assert [(len(l), n) for l, n in tcfg.stages()] == [(6, 1), (2, 1)]
    jp = np_params(tcfg, 5, fan_in=True)
    return jcfg, tcfg, jp, convert.params_from_arrays(jp, tcfg, device="cpu")


@pytest.mark.parametrize("S,steps", [(21, 3), (10, 7)])
def test_gemma3_prefill_and_decode_past_the_ring_wrap_match_jax(gemma, S, steps):
    """Local layers keep rings of 16 slots (position p in slot p % 16), the
    global layer a linear buffer of max_seq: a 21-token prompt leaves the
    ring wrapped and each step overwrites its oldest slot; a 10-token one
    wraps at the seventh step. Logits, greedy tokens and every ring and
    linear buffer equal JAX's within rtol/atol 1e-4."""
    jcfg, tcfg, jp, tp = gemma
    B, max_seq = 2, S + steps + 1
    tokens = np.random.default_rng(S).integers(0, 512, (B, S)).astype(np.int32)
    lj, cj, _ = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, max_seq=max_seq)
    lt, ct, plen = tmodel.prefill(tp, {"tokens": _t(tokens).long()}, tcfg, max_seq=max_seq)
    assert plen == S
    assert ct[0]["pos0"].k.shape[2] == 16 and ct[0]["pos5"].k.shape[2] == max_seq
    assert ct[1]["pos0"].k.shape[2] == 16
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    _assert_caches_close(ct, cj)
    tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    for i in range(steps):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cj = j_decode(jp, tok_j, cj, jnp.int32(S + 1 + i), jcfg)
        lt, ct = tmodel.decode_step(tp, tok_t, ct, S + 1 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
        tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
    _assert_caches_close(ct, cj)
    jc0 = jmodel.init_caches(jcfg, B, max_seq, jnp.float32)
    tc0 = tmodel.init_caches(tcfg, B, max_seq, torch.float32, "cpu")
    for ts, js in zip(tc0, jc0):
        for key in js:
            for a, b in zip(ts[key], js[key]):
                assert tuple(a.shape) == b.shape


def test_gemma3_ring_decode_equals_a_longer_prefill(gemma):
    """Past the wrap, five decode steps over the rings end where one prefill
    over the whole prompt does, whose windowed layers run the flash path
    with the window."""
    _, tcfg, _, tp = gemma
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, 512, (1, 30))).long()
    whole, _, _ = tmodel.prefill(tp, {"tokens": tokens}, tcfg, max_seq=30)
    logits, caches, plen = tmodel.prefill(tp, {"tokens": tokens[:, :25]}, tcfg, max_seq=30)
    for i in range(plen, 30):
        logits, caches = tmodel.decode_step(tp, tokens[:, i], caches, i + 1, tcfg)
    np.testing.assert_allclose(logits.numpy(), whole.numpy(), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def gemma_reduced():
    jcfg, tcfg = jget_config("gemma3-27b").reduced(), tget_config("gemma3-27b").reduced()
    jp = np_params(tcfg, 6, fan_in=True)
    return jcfg, tcfg, jp, convert.params_from_arrays(jp, tcfg, device="cpu")


def test_gemma3_prefill_without_exploiting_the_window_matches_jax(gemma_reduced):
    """gemma3's ``reduced()`` config (window 64, 12 layers) at an 80-token
    prompt, past the window: ``exploit_window=False`` (JAX's
    ``attend_blocked`` over every key; the port's flash over every key
    block) gives JAX's logits and caches within 1e-4, and the port's
    windowed prefill's exactly (the plain forward is the same on the CPU)."""
    jcfg, tcfg, jp, tp = gemma_reduced
    tokens = np.random.default_rng(8).integers(0, 512, (2, 80)).astype(np.int32)
    lj, cj, _ = j_prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg, max_seq=84,
                          exploit_window=False)
    lt, ct, _ = tmodel.prefill(tp, {"tokens": _t(tokens).long()}, tcfg, max_seq=84,
                               exploit_window=False)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    _assert_caches_close(ct, cj)
    lw, _, _ = tmodel.prefill(tp, {"tokens": _t(tokens).long()}, tcfg, max_seq=84)
    assert torch.equal(lt, lw)


def test_gemma3_train_loss_without_exploiting_the_window_matches_jax(gemma_reduced):
    """``train_loss(..., exploit_window=False)`` at gemma3's ``reduced()``
    config and 80 tokens: the loss within 1e-4 of JAX's (its windowed
    layers through ``attend_blocked`` under autodiff), a windowed layer's
    and the global layer's gradient within 1e-4 (atol 1e-5 of the leaf's
    scale); the loss and gradients within 1e-6 of the port's windowed ones."""
    jcfg, tcfg, jp, tp = gemma_reduced
    rng = np.random.default_rng(12)
    tokens = rng.integers(0, 512, (2, 80)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 80)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(
        p, jb, jcfg, remat=True, exploit_window=False)))(jp)
    tb = {"tokens": _t(tokens).long(), "labels": _t(labels).long()}
    got = {}
    for exploit in (False, True):
        leaves = tparam.tree_map(lambda t: t.clone().requires_grad_(True), tp)
        loss = tmodel.train_loss(leaves, tb, tcfg, remat=True, exploit_window=exploit)
        loss.backward()
        got[exploit] = (loss.detach(), leaves)
    tv, tl = got[False]
    np.testing.assert_allclose(float(tv), float(jv), rtol=RTOL)
    paths = (("stage0", "pos0", "attn", "wq"), ("stage0", "pos5", "attn", "wk"),
             ("embed", "table"))
    for path in paths:
        g, w, gw = tl, jg, got[True][1]
        for k in path:
            g, w, gw = g[k], w[k], gw[k]
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=str(path))
        torch.testing.assert_close(g.grad, gw.grad, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tv, got[True][0], rtol=1e-6, atol=1e-6)


def test_gemma3_train_loss_and_gradients_match_jax(gemma):
    """The windowed layers' custom backward inside the whole stack: the loss
    within rtol 1e-5, the windowed and the global layer's wq and the
    embedding within rtol 1e-4 (atol 1e-5 of the leaf's scale)."""
    jcfg, tcfg, jp, tp = gemma
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 512, (2, 40)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 40)).astype(np.int32)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}

    def jloss(p):
        return jmodel.train_loss(p, jb, jcfg, remat=True)

    jv, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tp = tparam.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tv = tmodel.train_loss(tp, {"tokens": _t(tokens).long(), "labels": _t(labels).long()},
                           tcfg, remat=True)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for path in (("stage0", "pos0", "attn", "wq"), ("stage0", "pos5", "attn", "wk"),
                 ("stage1", "pos1", "attn", "wv"), ("embed", "table")):
        got, want = tp, jg
        for k in path:
            got, want = got[k], want[k]
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=str(path))


@pytest.fixture(scope="module")
def pixtral():
    jcfg, tcfg = jget_config("pixtral-12b").reduced(), tget_config("pixtral-12b").reduced()
    jp = np_params(tcfg, 6, fan_in=True)
    return jcfg, tcfg, jp, convert.params_from_arrays(jp, tcfg, device="cpu")


def test_pixtral_prefill_with_patches_and_decode_match_jax(pixtral):
    """16 patch embeddings before 24 text tokens (S = 40), max_seq = S + 4,
    which fits (ROADMAP C7: JAX's CLI sizes it from the text alone)."""
    jcfg, tcfg, jp, tp = pixtral
    assert "projector" in tmodel.model_spec(tcfg) and "embed" in tmodel.model_spec(tcfg)
    rng = np.random.default_rng(12)
    B, P, T = 2, tcfg.num_patch_tokens, 24
    tokens = rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32)
    patches = rng.standard_normal((B, P, tcfg.d_model)).astype(np.float32)
    max_seq = P + T + 4
    lj, cj, sj = j_prefill(jp, {"tokens": jnp.asarray(tokens),
                                "patch_embeds": jnp.asarray(patches)}, jcfg, max_seq=max_seq)
    lt, ct, st = tmodel.prefill(tp, {"tokens": _t(tokens).long(),
                                     "patch_embeds": _t(patches)}, tcfg, max_seq=max_seq)
    assert st == sj == P + T
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    _assert_caches_close(ct, cj)
    tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    for i in range(3):
        np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))
        lj, cj = j_decode(jp, tok_j, cj, jnp.int32(st + 1 + i), jcfg)
        lt, ct = tmodel.decode_step(tp, tok_t, ct, st + 1 + i, tcfg)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
        tok_j, tok_t = jnp.argmax(lj, -1).astype(jnp.int32), torch.argmax(lt, -1)
    _assert_caches_close(ct, cj)


def test_pixtral_text_only_loss_and_projector_gradient_match_jax(pixtral):
    jcfg, tcfg, jp, tp = pixtral
    rng = np.random.default_rng(13)
    B, P, T = 2, tcfg.num_patch_tokens, 20
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32),
             "labels": rng.integers(0, tcfg.vocab_size, (B, T)).astype(np.int32),
             "patch_embeds": (rng.standard_normal((B, P, tcfg.d_model)) * 0.02).astype(
                 np.float32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(p, jb, jcfg)))(jp)
    tb = {k: _t(v).long() if v.dtype == np.int32 else _t(v) for k, v in batch.items()}
    tp = tparam.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tv = tmodel.train_loss(tp, tb, tcfg)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for path in (("projector", "w"), ("embed", "table"), ("stage0", "pos0", "attn", "wq")):
        got, want = tp, jg
        for k in path:
            got, want = got[k], want[k]
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=str(path))


@pytest.fixture(scope="module")
def hubert():
    """hubert-xlarge reduced, at its own head dim 80 (``reduced()`` sets 64)."""
    jcfg = dataclasses.replace(jget_config("hubert-xlarge").reduced(), head_dim=80)
    tcfg = dataclasses.replace(tget_config("hubert-xlarge").reduced(), head_dim=80)
    jp = np_params(tcfg, 7, fan_in=True)
    return jcfg, tcfg, jp, convert.params_from_arrays(jp, tcfg, device="cpu")


def test_hubert_train_loss_prefill_and_no_decode_match_jax(hubert):
    """Encoder-only at hd 80, not causal: frames through the projector, the
    loss and the projector's and first layer's gradients, prefill's logits
    and caches; decode raises in both packages."""
    jcfg, tcfg, jp, tp = hubert
    spec = tmodel.model_spec(tcfg)
    assert "embed" not in spec and "projector" in spec
    assert tp["stage0"]["pos0"]["attn"]["wq"].shape == (2, 256, 4 * 80)
    rng = np.random.default_rng(14)
    B, S = 2, 37
    frames = (rng.standard_normal((B, S, tcfg.d_model)) * 0.02).astype(np.float32)
    labels = rng.integers(0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jb = {"frame_embeds": jnp.asarray(frames), "labels": jnp.asarray(labels)}
    jv, jg = jax.jit(jax.value_and_grad(lambda p: jmodel.train_loss(p, jb, jcfg)))(jp)
    tq = tparam.tree_map(lambda t: t.clone().requires_grad_(True), tp)
    tv = tmodel.train_loss(tq, {"frame_embeds": _t(frames), "labels": _t(labels).long()},
                           tcfg)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for path in (("projector", "w"), ("stage0", "pos0", "attn", "wq"),
                 ("stage0", "pos0", "attn", "wk")):
        got, want = tq, jg
        for k in path:
            got, want = got[k], want[k]
        want = np.asarray(want)
        np.testing.assert_allclose(got.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(want).max()), err_msg=str(path))
    lj, cj, _ = j_prefill(jp, {"frame_embeds": jnp.asarray(frames)}, jcfg, max_seq=S)
    lt, ct, st = tmodel.prefill(tp, {"frame_embeds": _t(frames)}, tcfg, max_seq=S)
    assert st == S
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL, atol=ATOL)
    _assert_caches_close(ct, cj)
    with pytest.raises(ValueError, match="encoder-only"):
        jmodel.decode_step(jp, jnp.zeros(B, jnp.int32), cj, jnp.int32(S + 1), jcfg)
    with pytest.raises(ValueError, match="encoder-only"):
        tmodel.decode_step(tp, torch.zeros(B, dtype=torch.long), ct, S + 1, tcfg)


@pytest.mark.parametrize("arch", ["pixtral-12b", "hubert-xlarge"])
def test_params_from_arrays_carries_the_projector_bit_for_bit(arch):
    """The JAX tree with its ``projector`` (and, for audio, no ``embed``)
    loads leaf for leaf, bf16 bits kept."""
    over = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **over)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), **over)
    jp = jparam.tree_materialize(jmodel.model_spec(jcfg), jax.random.key(3))
    tp = convert.params_from_arrays(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    assert ("embed" in tp) == (arch == "pixtral-12b")
    got, want = tp["projector"]["w"], np.asarray(jp["projector"]["w"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_arrays({k: v for k, v in jp.items() if k != "projector"}, tcfg,
                                   device="cpu")
