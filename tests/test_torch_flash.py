"""Port vs JAX package: the flash-attention forward and its plain version.

The same numpy inputs go through the TPU kernel
``repro.kernels.flash_attn.flash_attention_fwd_pallas`` (interpret mode, as
``tests/test_flash_kernel.py`` runs it) and through the port's
``flash_attention_fwd_ref`` and ``ops.flash_attention_fwd`` on the CPU.
Tolerances are those of ``tests/test_flash_kernel.py``: rtol 1e-5 /
atol 2e-5 in float32 (the same float32 math, summed in another order), and
atol 3e-2 in bfloat16 (the Pallas interpreter rounds p·v to bfloat16).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention_fwd_pallas
from repro_torch.kernels import flash_attn, ops, ref

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
