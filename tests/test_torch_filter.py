"""Port vs JAX package: the message filter of Algorithm 2 (lines 7-9).

``topk_mask``/``topk_mask_exact``/``compress`` carry no arithmetic beyond a
subtraction that is exact here, so they must equal JAX's bit for bit, ties
included. The banded histogram filter's plain version is held to the
kernel contract against the exact ``topk_filter_ref``, and to mask equality
with JAX's Pallas filter (interpret mode) wherever both packages' thresholds
make the same decisions. Their first ladders may differ by an ulp (XLA fuses
the ladder's interpolation and rounds ``exp`` differently), so they are held
to a relative 1e-6, not compared bitwise; the refined ladders then hang on
which band each package picked and are not compared at all.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from repro.core import filter as jfilter
from repro.kernels import ops as jops
from repro.kernels import topk_filter as jtopk
from repro_torch.core import filter as tfilter
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import topk_filter as ttopk

INPUTS = {
    "normal": lambda rng, d: rng.standard_normal(d).astype(np.float32),
    # Many exact ties in |x|, with both signs: only the tie rule decides.
    "tied": lambda rng, d: rng.choice(np.array([-2, -1, 0, 1, 2, 3], np.float32), d),
    "sparse": lambda rng, d: np.where(rng.random(d) < 0.1,
                                      rng.standard_normal(d), 0).astype(np.float32),
}


@pytest.mark.parametrize("kind", sorted(INPUTS))
@pytest.mark.parametrize("d,k", [(64, 1), (257, 16), (1000, 100), (4096, 999)])
def test_topk_masks_and_compress_equal_jax(kind, d, k):
    x = INPUTS[kind](np.random.default_rng(d + k), d)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    for name in ("topk_mask", "topk_mask_exact"):
        j = getattr(jfilter, name)(xj, k)
        t = getattr(tfilter, name)(xt, k)
        for field in j._fields:
            np.testing.assert_array_equal(getattr(t, field).numpy(),
                                          np.asarray(getattr(j, field)),
                                          err_msg=f"{name}.{field}")
    vj, ij = jfilter.compress(xj, k)
    vt, it = tfilter.compress(xt, k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert it.dtype == torch.int32
    np.testing.assert_array_equal(tfilter.decompress(vt, it, d).numpy(),
                                  np.asarray(jfilter.decompress(vj, ij, d)))
    assert int(tfilter.nnz(xt)) == int(jfilter.nnz(xj))
    sent, resid, mask = tref.topk_filter_ref(xt, k)
    assert int(mask.sum()) == k and torch.equal(sent + resid, xt)


def test_byte_formulas_equal_jax():
    for d in (1, 7, 1000, 47_236, 3_231_961):
        for rho in (1e-4, 0.02, 0.5, 1.0, 2.0):
            assert tfilter.num_kept(d, rho) == jfilter.num_kept(d, rho)
        assert tfilter.dense_bytes(d) == jfilter.dense_bytes(d)
        assert tfilter.message_bytes(d, 2, 4) == jfilter.message_bytes(d, 2, 4)
        assert tfilter.message_bytes(d) == jfilter.message_bytes(d)


def _jax_thresholds(x, k):
    """The JAX filter's ``(thresh, edges, edges2)``, by its own glue (the
    Pallas histogram in interpret mode between the steps)."""
    x2d, n_tiles = jtopk._pad_to_tiles(x)
    mag_max = jnp.max(jnp.abs(x)).astype(jnp.float32)
    edges = jtopk._bucket_edges(mag_max, mag_max * jtopk.FLOOR)
    counts = jtopk._histogram(x2d, edges, n_tiles, True)
    t_lo, t_hi, _ = jtopk._select_band(counts, edges, k)
    edges2 = jtopk._bucket_edges(jnp.minimum(t_hi, mag_max), t_lo)
    counts2 = jtopk._histogram(x2d, edges2, n_tiles, True)
    t_lo, t_hi, count_hi = jtopk._select_band(counts2, edges2, k)
    thresh = [float(t_lo), float(t_hi), float(max(k - int(count_hi), 0))]
    return thresh, np.asarray(edges), np.asarray(edges2)


def _contract(x: torch.Tensor, sent, resid, mask, k: int):
    """The kernel contract against the exact top-k (tests/test_kernels.py)."""
    mag = x.float().abs()
    floor = mag.max() * ttopk.FLOOR
    assert int(mask.sum()) == min(k, int((mag >= floor).sum()))
    assert torch.equal(sent + resid, x)  # bitwise conservation
    kept_min = float(torch.where(mask, mag, torch.full_like(mag, torch.inf)).min())
    drop_max = float(torch.where(mask, torch.zeros_like(mag), mag).max())
    assert kept_min >= drop_max * (1 - 6e-3) - 1e-6
    s_ref, _, _ = tref.topk_filter_ref(x, k)
    assert float(sent.float().abs().sum()) >= 0.999 * float(s_ref.float().abs().sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_frac", [0.001, 0.02, 0.25])
@pytest.mark.parametrize("d", [257, 1024, 4096, 50000])
def test_topk_filter_plain_meets_contract_and_matches_jax(d, k_frac, dtype):
    rng = np.random.default_rng(d)
    k = max(1, int(k_frac * d))
    x = rng.standard_normal(d).astype(np.float32)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    sent, resid, mask = tops.topk_filter(xt, k)  # the plain version on the CPU
    assert sent.dtype == xt.dtype and mask.dtype == torch.bool
    _contract(xt, sent, resid, mask, k)
    _, _, j_mask = jops.topk_filter(xj, k)
    thresh, edges, _ = ttopk._thresholds(xt, k, ttopk._histogram_plain)
    j_thresh, j_edges, _ = _jax_thresholds(xj, k)
    np.testing.assert_allclose(edges.numpy(), j_edges, rtol=1e-6)
    mag = xt.float().abs()
    same_decisions = float(thresh[2]) == j_thresh[2] and all(
        torch.equal(mag >= float(thresh[i]), mag >= min(j_thresh[i], 3.4e38))
        for i in (0, 1))
    if same_decisions:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))


def test_topk_filter_plain_keeps_what_exists_when_k_exceeds_it():
    x = torch.zeros(2048)
    x[[3, 500, 1999]] = torch.tensor([1.0, -2.0, 0.5])
    sent, resid, mask = ttopk.topk_filter_plain(x, 100)
    assert set(torch.nonzero(sent).flatten().tolist()) == {3, 500, 1999}
    assert int(mask.sum()) <= 100 and torch.equal(sent + resid, x)


def test_topk_filter_launcher_refuses_host_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ttopk.topk_filter_cuda(torch.ones(16), 4)
