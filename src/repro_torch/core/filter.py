"""The paper's message filter F (Algorithm 2, lines 7-9) + residual feedback.

PyTorch counterpart of ``repro.core.filter``. Given the accumulated primal
delta ``dw`` of a worker, keep only the top ``ceil(rho * d)`` entries by
magnitude:

    c_k   = (rho d)-th largest value of |dw|
    M_k   = |dw| >= c_k                       (line 8 -- note: ties may pass)
    F(dw) = dw o M_k                          (sent, O(rho d) nonzeros)
    dw   <- dw o ~M_k                         (practical residual variant, Sec. III-B2)

``topk_mask`` follows the paper's threshold definition exactly (ties can admit
more than k entries); ``topk_mask_exact`` keeps exactly k, breaking ties
toward the lower index as ``lax.top_k`` does. ``torch.topk`` promises no
order among ties on CUDA, so the order here comes from a stable descending
sort of ``|dw|``. These are plain PyTorch, as the JAX package computes them
outside any kernel; the banded histogram filter of Table I is
``repro_torch.kernels.ops.topk_filter``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FilterResult(NamedTuple):
    sent: torch.Tensor  # F(dw): dw with all but the top-k entries zeroed
    residual: torch.Tensor  # dw o ~M: what the worker keeps (error feedback)
    mask: torch.Tensor  # M_k, boolean
    threshold: torch.Tensor  # c_k


def num_kept(d: int, rho: float) -> int:
    """ceil(rho*d), clamped to [1, d]."""
    return max(1, min(d, int(-(-rho * d // 1))))


def _top_k(mag: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest, ties toward the lower index."""
    values, idx = torch.sort(mag, descending=True, stable=True)
    return values[:k], idx[:k]


def topk_mask(dw: torch.Tensor, k: int) -> FilterResult:
    """Paper-faithful threshold filter: M = |dw| >= c_k (ties pass)."""
    mag = torch.abs(dw)
    c_k = _top_k(mag, k)[0][-1]
    mask = mag >= c_k
    sent = torch.where(mask, dw, torch.zeros_like(dw))
    return FilterResult(sent, dw - sent, mask, c_k)


def topk_mask_exact(dw: torch.Tensor, k: int) -> FilterResult:
    """Exactly-k filter (ties broken toward lower index)."""
    values, idx = _top_k(torch.abs(dw), k)
    mask = torch.zeros(dw.shape, dtype=torch.bool, device=dw.device)
    mask[idx] = True
    sent = torch.where(mask, dw, torch.zeros_like(dw))
    return FilterResult(sent, dw - sent, mask, values[-1])


def compress(dw: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """On-wire form: (values, int32 indices), each of length k.

    This is what actually crosses the network: 2k words instead of d.
    """
    _, idx = _top_k(torch.abs(dw), k)
    return dw[idx], idx.to(torch.int32)


def decompress(values: torch.Tensor, idx: torch.Tensor, d: int) -> torch.Tensor:
    out = torch.zeros((d,), dtype=values.dtype, device=values.device)
    return out.index_add_(0, idx.long(), values)


def message_bytes(k: int, value_bytes: int = 4, index_bytes: int = 4) -> int:
    """Bytes on the wire for one compressed message (Table I accounting)."""
    return k * (value_bytes + index_bytes)


def dense_bytes(d: int, value_bytes: int = 4) -> int:
    return d * value_bytes


def nnz(x: torch.Tensor) -> torch.Tensor:
    return torch.sum(x != 0)
