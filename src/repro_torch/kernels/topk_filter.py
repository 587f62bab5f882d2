"""Top-k message filter by histogram select: CUDA kernel and plain version.

Replaces the TPU kernel ``repro.kernels.topk_filter.topk_filter_pallas``.
Instead of sorting, the filter

  1. counts ``|x| >= edge_j`` on a geometric ladder of 64 edges from
     ``max|x|`` down to ``max|x| * 2**-22`` (:func:`_bucket_edges`);
  2. picks the band ``[t_lo, t_hi)`` that brackets the k-th magnitude
     (:func:`_select_band`), and refines once inside it on a second ladder;
  3. keeps everything ``>= t_hi`` and admits band elements in index order
     until the quota ``k - #{|x| >= t_hi}`` runs out.

Steps 1-2 are shared: the ladder and band glue is PyTorch on the device (no
value returns to the host), and only the counting differs. The kernel path
(:func:`topk_filter_cuda`) counts and emits with the passes in
``csrc/topk_filter.cu``; :func:`topk_filter_plain` transcribes the same
select in PyTorch. Given the same edges both make the same integer decisions,
so on the card their masks are equal exactly.

Contract against the exact ``topk_filter_ref``: ``min(k, #{|x| >= floor})``
entries are kept, ``sent + residual == dw`` bitwise, and every kept
magnitude is within one refined bucket (0.6%) of every dropped one.
float32 and bfloat16 input; magnitudes are compared in float32.
"""

from __future__ import annotations

import ctypes
from typing import Callable

import torch

from repro_torch.kernels import _build

NAME = "topk_filter"
NUM_BUCKETS = 64
# Dynamic range covered by the ladder, relative to max|x|. Entries smaller
# than max|x| * FLOOR are never selected; they stay in the residual.
FLOOR = 2.0**-22
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _bucket_edges(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Geometric ladder of NUM_BUCKETS float32 edges descending from hi to lo."""
    hi = torch.clamp_min(hi, 1e-37)
    lo = torch.maximum(lo, hi * 1e-37)
    t = torch.arange(NUM_BUCKETS, dtype=torch.float32, device=hi.device) / (NUM_BUCKETS - 1)
    return torch.exp(torch.log(hi) * (1.0 - t) + torch.log(lo) * t)


def _select_band(counts: torch.Tensor, edges: torch.Tensor, k: int):
    """``(t_lo, t_hi, count_hi)`` bracketing the k-th magnitude.

    ``counts`` is nondecreasing along the descending edges. t_lo is the first
    edge whose count reaches k (the last edge if none does), t_hi the edge
    before it (+inf if even the largest edge admits k).
    """
    reached = counts >= k
    j = torch.argmax(reached.to(torch.int32))  # first True; 0 if none
    j = torch.where(reached.any(), j, torch.full_like(j, NUM_BUCKETS - 1))
    prev = torch.clamp_min(j - 1, 0).view(1)
    t_lo = edges.index_select(0, j.view(1))[0]
    t_hi = torch.where(j > 0, edges.index_select(0, prev)[0],
                       torch.full_like(t_lo, torch.inf))
    count_hi = torch.where(j > 0, counts.index_select(0, prev)[0],
                           torch.zeros_like(counts[0]))
    return t_lo, t_hi, count_hi


def _thresholds(dw: torch.Tensor, k: int,
                histogram: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]):
    """``(thresh, edges, edges2)``: ``thresh = [t_lo, t_hi, quota]`` float32.

    ``histogram(dw, edges)`` returns ``counts[j] = #{|dw| >= edges[j]}``.
    """
    mag_max = torch.abs(dw).max().to(torch.float32)
    edges = _bucket_edges(mag_max, mag_max * FLOOR)
    t_lo, t_hi, _ = _select_band(histogram(dw, edges), edges, k)
    # Refine inside [t_lo, t_hi): the elements >= t_hi are in every refined
    # count, so searching for k again on the refined ladder finds the band.
    edges2 = _bucket_edges(torch.minimum(t_hi, mag_max), t_lo)
    t_lo, t_hi, count_hi = _select_band(histogram(dw, edges2), edges2, k)
    quota = torch.clamp_min(k - count_hi, 0).to(torch.float32)
    t_hi = torch.where(torch.isinf(t_hi), torch.full_like(t_hi, 3.4e38), t_hi)
    return torch.stack([t_lo, t_hi, quota]), edges, edges2


def _histogram_plain(dw: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    mag = torch.abs(dw.to(torch.float32))
    return (mag[None, :] >= edges[:, None]).sum(dim=1, dtype=torch.int32)


def topk_filter_plain(dw: torch.Tensor, k: int):
    """The histogram select in plain PyTorch: ``(sent, residual, mask)``."""
    thresh, _, _ = _thresholds(dw, k, _histogram_plain)
    t_lo, t_hi, quota = thresh[0], thresh[1], thresh[2]
    mag = torch.abs(dw.to(torch.float32))
    strong = mag >= t_hi
    band = (mag >= t_lo) & (mag < t_hi)
    band_i = band.to(torch.int64)
    rank = torch.cumsum(band_i, 0) - band_i  # index-order rank among band
    keep = strong | (band & (rank < quota))
    zero = torch.zeros_like(dw)
    return torch.where(keep, dw, zero), torch.where(keep, zero, dw), keep


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.topk_filter_histogram.argtypes = [p, i, i, p, p, p]
        lib.topk_filter_histogram.restype = i
        lib.topk_filter_emit.argtypes = [p, i, i, p, p, p, p, p, p, p]
        lib.topk_filter_emit.restype = i
        lib.topk_filter_tile.argtypes = []
        lib.topk_filter_tile.restype = i
        lib._typed = True
    return lib


def topk_filter_cuda(dw: torch.Tensor, k: int):
    """The histogram select on the card: ``(sent, residual, mask)``.

    ``dw`` is a contiguous 1-D float32 or bfloat16 CUDA tensor. Five launches
    on the current stream: two histogram passes, then band count, tile scan
    and emit. Nothing synchronizes with the host.
    """
    if not dw.is_cuda or dw.dim() != 1 or not dw.is_contiguous() or dw.dtype not in _DTYPES:
        raise ValueError(
            f"topk_filter: need a contiguous 1-D float32 or bfloat16 CUDA "
            f"tensor, got {dw.dtype} {tuple(dw.shape)} on {dw.device}")
    d = dw.shape[0]
    if not 1 <= k <= d:
        raise ValueError(f"topk_filter: need 1 <= k <= d = {d}, got k = {k}")
    lib = _lib()
    dtype = _DTYPES[dw.dtype]
    with torch.cuda.device(dw.device):
        stream = torch.cuda.current_stream(dw.device).cuda_stream

        def histogram(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
            counts = torch.zeros(NUM_BUCKETS, dtype=torch.int32, device=x.device)
            edges = edges.contiguous()
            code = lib.topk_filter_histogram(x.data_ptr(), d, dtype, edges.data_ptr(),
                                             counts.data_ptr(), stream)
            _build.check(lib, NAME, code, "topk_filter histogram launch")
            return counts

        thresh, _, _ = _thresholds(dw, k, histogram)
        n_tiles = -(-d // int(lib.topk_filter_tile()))
        tiles = torch.empty((2, n_tiles), dtype=torch.int32, device=dw.device)
        sent = torch.empty_like(dw)
        residual = torch.empty_like(dw)
        mask = torch.empty(d, dtype=torch.bool, device=dw.device)
        code = lib.topk_filter_emit(dw.data_ptr(), d, dtype, thresh.data_ptr(),
                                    tiles[0].data_ptr(), tiles[1].data_ptr(),
                                    sent.data_ptr(), residual.data_ptr(),
                                    mask.data_ptr(), stream)
    _build.check(lib, NAME, code, "topk_filter emit launch")
    return sent, residual, mask
