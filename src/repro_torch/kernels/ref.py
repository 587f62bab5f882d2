"""Plain PyTorch versions of the kernels: the ground truth in tests.

``sdca_inner_ref`` is the ridge worker step written out over a batch of K
workers (the JAX package's ``vmap``); ``topk_filter_ref`` is the exact top-k
split that the banded histogram filter is held against.
"""

from __future__ import annotations

import torch

# A module import, not a name import: core.sdca imports kernels.ops, which
# imports this module, so core.sdca may still be initializing here.
from repro_torch.core import sdca


def topk_filter_ref(dw: torch.Tensor, k: int):
    """Exact top-k split (ties toward lower index): (sent, residual, mask)."""
    mag = torch.abs(dw.float())
    _, idx = torch.sort(mag, descending=True, stable=True)
    mask = torch.zeros(dw.shape, dtype=torch.bool, device=dw.device)
    mask[idx[:k]] = True
    sent = torch.where(mask, dw, torch.zeros_like(dw))
    return sent, dw - sent, mask


def sdca_inner_ref(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
                   sigma_prime: float, idx):
    """Ridge SDCA epoch for K workers with explicit visit orders ``idx (K, H)``.

    Returns ``(dalpha (K, n_k), v (K, d))``.
    """
    dalpha, v = sdca.sdca_epoch_plain("ridge", w_eff, alpha, X, y, norms_sq,
                                      lam, n_global, sigma_prime, idx)
    return dalpha, v
