"""Port vs JAX package: the flash-attention forward and its plain version.

The same numpy inputs go through the TPU kernel
``repro.kernels.flash_attn.flash_attention_fwd_pallas`` (interpret mode, as
``tests/test_flash_kernel.py`` runs it) and through the port's
``flash_attention_fwd_ref`` and ``ops.flash_attention_fwd`` on the CPU.
Tolerances are those of ``tests/test_flash_kernel.py``: rtol 1e-5 /
atol 2e-5 in float32 (the same float32 math, summed in another order), and
atol 3e-2 in bfloat16 (the Pallas interpreter rounds p·v to bfloat16).

Sliding windows and head dim 80: the port's ``models.flash.flash_attention``
(the plain forward on the CPU, the FlashAttention-2 backward) against JAX's
windowed ``repro.models.flash.flash_attention`` at blocks of 16, forward and
gradients within rtol 1e-5 / atol 1e-5 in float32. A window that is not
causal is one-sided (``repro.models.flash._mask``); JAX's windowed key slice
ends at the query block and so misses the later keys (ROADMAP C8), so there
the reference is JAX's ``attend_blocked(..., exploit_window=False)``, which
applies the mask over every key, and JAX's flash agrees only where one query
block spans the sequence.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels.flash_attn import flash_attention_fwd_pallas
from repro.models import attention as jattn
from repro.models import flash as jflash
from repro_torch.kernels import flash_attn, ops, ref
from repro_torch.models import flash as tflash

SHAPES = [(2, 64, 2, 2, 16, True, 16), (1, 100, 1, 3, 32, True, 32),  # ragged pad
          (2, 48, 2, 1, 16, False, 16),  # encoder
          (1, 128, 4, 2, 64, True, 64), (1, 96, 2, 2, 16, True, 32)]


def _inputs(B, S, KV, G, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32) * 0.4
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32) * 0.4
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("fn", ["ref", "ops"])
@pytest.mark.parametrize("B,S,KV,G,hd,causal,blk", SHAPES)
def test_flash_matches_pallas_kernel(fn, B, S, KV, G, hd, causal, blk):
    q, k, v = _inputs(B, S, KV, G, hd, S)
    want = flash_attention_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, block_q=blk, block_k=blk)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    impl = ref.flash_attention_fwd_ref if fn == "ref" else ops.flash_attention_fwd
    got = impl(tq, tk, tv, causal=causal)
    assert got.shape == (B, S, KV, G, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_flash_bf16_matches_pallas_kernel():
    q, k, v = _inputs(1, 64, 2, 2, 32, 7)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    want = flash_attention_fwd_pallas(jq, jk, jv, block_q=32, block_k=32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = ops.flash_attention_fwd(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=3e-2)


@pytest.mark.parametrize("hd", [16, 64])
def test_prescaled_q_with_unit_scale_equals_default(hd):
    """The model passes q already scaled by hd^-1/2 with sm_scale=1.0: scaling
    twice would be caught here."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 40, 2, 5, hd, hd))
    scale = hd**-0.5  # a power of two: the pre-scaling is exact
    once = ops.flash_attention_fwd(q * scale, k, v, causal=True, sm_scale=1.0)
    default = ops.flash_attention_fwd(q, k, v, causal=True)
    torch.testing.assert_close(once, default, rtol=1e-6, atol=1e-7)
    twice = ops.flash_attention_fwd(q * scale, k, v, causal=True)
    assert not torch.allclose(twice, default, rtol=1e-3, atol=1e-3)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 1, 2, 16, 0))
    before = ops.LAUNCHES["flash_attention_fwd"]
    ops.flash_attention_fwd(q, k, v)
    assert ops.LAUNCHES["flash_attention_fwd"] == before


def test_launcher_refuses_cpu_tensors_before_building():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 1, 2, 16, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_fwd_cuda(q, k, v)
    with pytest.raises(ValueError, match=r"\(B, S, KV, G, hd\)"):
        flash_attn.flash_attention_fwd_cuda(q[..., 0, :], k, v)


# ---------------------------------------------------------------------------
# Sliding windows and head dim 80.
# ---------------------------------------------------------------------------

# (B, S, KV, G, hd, window): W not a multiple of the blocks, a ragged S, a
# window as wide as S (vacuous), gemma3's G = 2 and hubert's hd 80.
WINDOWED = [(2, 100, 2, 2, 16, 37), (1, 100, 1, 2, 80, 37), (1, 61, 2, 1, 16, 16),
            (1, 50, 1, 3, 16, 50), (1, 40, 2, 2, 16, 1)]
_CFG = jget_config("qwen3-14b").reduced()  # attend_blocked reads only its softcap (None)


def _jax_reference(q, k, v, causal, window, block):
    """JAX's windowed attention for these inputs: its flash when causal, the
    blocked path over every key (the one-sided mask) when not."""
    if causal or window is None:
        spec = jflash.FlashSpec(causal, window, block, block, None)
        return jflash.flash_attention(q, k, v, spec)
    return jattn.attend_blocked(q, k, v, _CFG, causal=False, window=window, block_q=block,
                                block_k=block, exploit_window=False)


def _value_and_grads(q, k, v, cot, causal, window):
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def jloss(q_, k_, v_):
        return jnp.sum(_jax_reference(q_, k_, v_, causal, window, 16) * cot)

    want = _jax_reference(jq, jk, jv, causal, window, 16)
    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    spec = tflash.FlashSpec(causal, window, 16, 16, None)
    got = tflash.flash_attention(tq, tk, tv, spec)
    (got * torch.from_numpy(cot)).sum().backward()
    return (got.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)],
            np.asarray(want), [np.asarray(g) for g in jgrads])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,KV,G,hd,W", WINDOWED)
def test_windowed_flash_forward_and_gradients_match_jax(B, S, KV, G, hd, W, causal):
    q, k, v = _inputs(B, S, KV, G, hd, W)
    q = q * np.float32(hd**-0.5)  # the model's pre-scaled q
    cot = np.random.default_rng(W).standard_normal(q.shape).astype(np.float32)
    got, grads, want, jgrads = _value_and_grads(q, k, v, cot, causal, W)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
def test_head_dim_80_forward_and_gradients_match_jax(causal):
    """hubert-xlarge's head dim, no window: MHA (G = 1) and a ragged S."""
    q, k, v = _inputs(2, 45, 2, 1, 80, 80)
    q = q * np.float32(80**-0.5)
    cot = np.random.default_rng(80).standard_normal(q.shape).astype(np.float32)
    got, grads, want, jgrads = _value_and_grads(q, k, v, cot, causal, None)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g, jg, rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


@pytest.mark.parametrize("fn", ["ref", "ops"])
@pytest.mark.parametrize("B,S,KV,G", [(2, 64, 2, 1), (1, 77, 1, 2)])
def test_head_dim_80_matches_pallas_kernel(fn, B, S, KV, G):
    """hd 80, not causal (hubert's encoder), against the TPU kernel in
    interpret mode: its block is the whole head, so it takes any hd."""
    q, k, v = _inputs(B, S, KV, G, 80, S)
    want = flash_attention_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=False, block_q=32, block_k=32, interpret=True)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    impl = ref.flash_attention_fwd_ref if fn == "ref" else ops.flash_attention_fwd
    got = impl(tq, tk, tv, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=2e-5)


def test_noncausal_window_is_one_sided_as_the_mask_says():
    """JAX's windowed flash equals the mask where one query block spans the
    sequence (its key slice then holds every key), and not at blocks of 16
    (ROADMAP C8); the port equals the mask at any blocks."""
    q, k, v = _inputs(1, 100, 1, 2, 16, 3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    mask_ref = ref.flash_attention_fwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                           causal=False, sm_scale=1.0, window=37).numpy()
    whole = jflash.flash_attention(jq, jk, jv, jflash.FlashSpec(False, 37, 128, 4, None))
    np.testing.assert_allclose(np.asarray(whole), mask_ref, rtol=1e-5, atol=1e-5)
    blocked = jflash.flash_attention(jq, jk, jv, jflash.FlashSpec(False, 37, 16, 16, None))
    assert np.abs(np.asarray(blocked) - mask_ref).max() > 1e-2
    for block in (16, 512):
        got = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     tflash.FlashSpec(False, 37, block, block, None))
        np.testing.assert_allclose(got.numpy(), mask_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_windowed_lse_is_the_masked_logsumexp(causal):
    """The plain forward's log-sum-exp under a window, which the backward
    rebuilds the probabilities from, against JAX's ``_fwd_impl``."""
    q, k, v = _inputs(1, 70, 2, 2, 16, 5)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = ops.flash_attention_fwd(tq, tk, tv, causal=causal, sm_scale=1.0, window=21,
                                       return_lse=True)
    block = 16 if causal else 128  # JAX's slice holds every key at one query block
    jout, jlse = jflash._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  jflash.FlashSpec(causal, 21, block, 2, None))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    assert not torch.allclose(out, ops.flash_attention_fwd(tq, tk, tv, causal=causal,
                                                           sm_scale=1.0))


def test_launcher_takes_head_dim_80_and_refuses_a_bad_window():
    assert 80 in flash_attn.HEAD_DIMS
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 1, 2, 80, 0))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_fwd_cuda(q, k, v, window=8)
    with pytest.raises(ValueError, match="window"):
        flash_attn._check(q, k, v, 0)


# ---------------------------------------------------------------------------
# The logit softcap and the exploit_window=False baseline.
# ---------------------------------------------------------------------------

# (S, window, causal): a padded S (100 at blocks of 16) and a ragged one (33),
# with and without a window, causal and not.
SOFTCAP_CASES = [(S, W, c) for S in (100, 33) for W in (None, 21) for c in (True, False)]


def _capped_inputs(S, seed):
    """q, k with scores of about +-30 after the model's pre-scaling (a cap of
    30 saturates the largest, one of 50 bends them), v standard normal."""
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((2, S, 2, 2, 16)) * 3.0 * 16**-0.5).astype(np.float32)
    k = (rng.standard_normal((2, S, 2, 16)) * 3.0).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    return q, k, v


def _jax_capped(q, k, v, causal, window, cap, block):
    """JAX's capped attention: its custom-VJP flash where its blocked slice
    holds every key the mask keeps (causal, or no window), else the blocked
    path over every key (ROADMAP C8)."""
    if causal or window is None:
        return jflash.flash_attention(q, k, v, jflash.FlashSpec(causal, window, block, block,
                                                                cap))
    cfg = dataclasses.replace(_CFG, attn_logit_softcap=cap)
    return jattn.attend_blocked(q, k, v, cfg, causal=False, window=window, block_q=block,
                                block_k=block, exploit_window=False)


@pytest.mark.parametrize("cap", [50.0, 30.0])
@pytest.mark.parametrize("S,W,causal", SOFTCAP_CASES)
def test_softcap_forward_lse_and_gradients_match_jax(S, W, causal, cap):
    """The cap on the scaled float32 scores before the mask, as JAX's
    ``_scores``: the port's forward (the plain version on the CPU), its lse
    (against JAX's ``_fwd_impl`` where one query block spans S) and its
    FlashAttention-2 backward through the cap (JAX's ``_dscores``) against
    ``jax.grad``; rtol / atol 1e-5, the gradients' atol 1e-5 of the leaf's
    largest entry (scores up to ~50 give gradients up to ~30, and float32
    rounding scales with them: the entries that true arithmetic makes 0,
    a first row's dq, differ by ~1e-5 of that)."""
    q, k, v = _capped_inputs(S, S + int(cap))
    cot = np.random.default_rng(S).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = _jax_capped(jq, jk, jv, causal, W, cap, 16)
    jgrads = jax.grad(lambda *a: jnp.sum(_jax_capped(*a, causal, W, cap, 16) * cot),
                      argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    got = tflash.flash_attention(tq, tk, tv, tflash.FlashSpec(causal, W, 16, 16, cap))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(t.grad.numpy(), jg, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(jg).max()), err_msg=f"d{name}")
    _, lse = ops.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                                     sm_scale=1.0, window=W, softcap=cap, return_lse=True)
    _, jlse = jflash._fwd_impl(jq, jk, jv, jflash.FlashSpec(causal, W, 128, 1, cap))
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5, atol=1e-5)
    capless = tflash.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                     tflash.FlashSpec(causal, W, 16, 16, None))
    assert not torch.allclose(got.detach(), capless, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("causal", [True, False])
def test_baseline_without_the_window_is_the_same_function(causal):
    """``exploit_window=False`` (the backward from the first kv-block, the
    kernel's full-range launch on the card) gives the windowed result and
    gradients, and JAX's ``attend_blocked(..., exploit_window=False)``
    within 1e-5, not causal too (where JAX's windowed flash drops keys, C8)."""
    q, k, v = _inputs(1, 100, 2, 2, 16, 13)
    q = q * np.float32(16**-0.5)
    cot = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

    def jref(*a):
        return jattn.attend_blocked(*a, _CFG, causal=causal, window=37, block_q=16,
                                    block_k=16, exploit_window=False)

    want = jref(jq, jk, jv)
    jgrads = jax.grad(lambda *a: jnp.sum(jref(*a) * cot), argnums=(0, 1, 2))(jq, jk, jv)
    outs = {}
    for exploit in (True, False):
        tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
        spec = tflash.FlashSpec(causal, 37, 16, 16, None, exploit_window=exploit)
        got = tflash.flash_attention(tq, tk, tv, spec)
        (got * torch.from_numpy(cot)).sum().backward()
        outs[exploit] = [got.detach()] + [t.grad for t in (tq, tk, tv)]
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        for name, t, jg in zip("qkv", (tq, tk, tv), jgrads):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5,
                                       err_msg=f"d{name}")
    assert torch.equal(outs[True][0], outs[False][0])  # the same plain forward
    for a, b in zip(outs[True][1:], outs[False][1:]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_meta_tensors_give_shapes_and_record_the_call():
    """On ``meta`` the forward computes nothing: empty outputs of the right
    shapes, no launch counted, the call recorded for the FLOP count."""
    q = torch.empty((2, 40, 2, 3, 16), device="meta")
    k = v = torch.empty((2, 40, 2, 16), device="meta")
    before = dict(ops.LAUNCHES)
    with ops.recording_meta_calls() as calls:
        out, lse = ops.flash_attention_fwd(q, k, v, window=8, softcap=30.0, return_lse=True,
                                           exploit_window=False)
    assert out.shape == q.shape and out.is_meta and lse.shape == (2, 2, 3, 40)
    assert calls == [dict(q_shape=(2, 40, 2, 3, 16), causal=True, window=8, softcap=30.0,
                          exploit_window=False)]
    assert ops.LAUNCHES == before
    assert ops.flash_attention_fwd(q, k, v).shape == q.shape  # not recorded outside


def test_launcher_refuses_a_bad_softcap():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 1, 2, 16, 0))
    for cap in (0.0, -1.0, float("inf")):
        with pytest.raises(ValueError, match="softcap"):
            flash_attn._check(q, k, v, None, cap)
