"""Dispatch to the hand-written kernels, by the device of the input.

For tensors on the card each wrapper launches its CUDA kernel or raises;
for tensors on the CPU, where no kernel exists, it computes its plain
PyTorch version. There is no other fallback: no capacity check that
switches path, no flag that turns a kernel off, no ``try`` that gives way.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card, so that a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.sdca_inner import sdca_inner_cuda
from repro_torch.kernels.topk_filter import topk_filter_cuda, topk_filter_plain

LAUNCHES: dict[str, int] = {"sdca_inner": 0, "topk_filter": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def topk_filter(dw: torch.Tensor, k: int):
    """Message filter F by histogram select: ``(sent, residual, mask)``.

    The banded filter of Table I (see ``kernels/topk_filter.py`` for its
    contract). On the CPU it is ``topk_filter_plain``, the same select.
    """
    if dw.is_cuda:
        out = topk_filter_cuda(dw, k)
        LAUNCHES["topk_filter"] += 1
        return out
    return topk_filter_plain(dw, k)


def sdca_epoch(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
               sigma_prime: float, idx):
    """All-workers ridge SDCA epoch: ``(dalpha (K, n_k), v (K, d))``.

    ``idx (K, H)`` int32 is each worker's visit order. On the card this is
    one launch of K blocks of the CUDA kernel; on the CPU it is
    ``ref.sdca_inner_ref``.
    """
    if X.is_cuda:
        out = sdca_inner_cuda(w_eff, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, idx)
        LAUNCHES["sdca_inner"] += 1
        return out
    return ref.sdca_inner_ref(w_eff, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, idx)
