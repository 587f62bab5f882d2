"""Plain PyTorch versions of the kernels: the ground truth in tests.

``sdca_inner_ref`` is the worker step, for each of the three losses,
written out over a batch of K workers (the JAX package's ``vmap``);
``topk_filter_ref`` is the exact top-k split that the banded histogram
filter is held against;
``flash_attention_fwd_ref`` is GQA attention with the whole score matrix
materialised, which the flash kernel is held against.
"""

from __future__ import annotations

import torch

# Masked scores, as in the TPU kernel (src/repro/kernels/flash_attn.py).
NEG_INF = -1e30

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
                   sigma_prime: float, idx, *, loss: str = "ridge", workers=None,
                   map_error=None, alpha_rows: bool = False, sigma_rows=None):
    """SDCA epoch for a batch of workers with explicit visit orders ``idx (B, H)``.

    Batch row b is worker ``workers[b]`` (all K workers in order without a
    map; host data or a tensor, checked here: a bad entry raises
    ``ValueError``, so ``map_error`` is never written). ``alpha_rows``
    reads ``alpha (B, n_k)`` at the batch row, ``sigma_rows (B,)`` is sigma'
    per row. Returns ``(dalpha (B, n_k), v (B, d))``.
    """
    dalpha, v = sdca.sdca_epoch_plain(loss, w_eff, alpha, X, y, norms_sq,
                                      lam, n_global, sigma_prime, idx, workers,
                                      alpha_rows=alpha_rows, sigma_rows=sigma_rows)
    return dalpha, v


def flash_attention_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool, sm_scale: float | None = None,
                            window: int | None = None, return_lse: bool = False,
                            softcap: float | None = None, exploit_window: bool = True):
    """GQA attention forward, computed in float32, cast to ``q.dtype``.

    ``q (B, S, KV, G, hd)``, ``k``/``v (B, S, KV, hd)``; ``q`` is scaled by
    ``sm_scale`` (default ``hd ** -0.5``) here, so pass it unscaled, or
    pre-scaled with ``sm_scale=1.0``. With a ``softcap`` each scaled float32
    score s becomes ``softcap * tanh(s / softcap)`` before the mask, the
    order of the JAX package's ``_scores`` (``repro.models.flash``). Query
    position ``i`` attends to key ``j`` if ``j < S``, ``j <= i`` when
    ``causal``, and ``i - j < window`` when a window is set: the mask of the
    JAX package's ``FlashSpec`` (``repro.models.flash._mask``), one-sided
    also when not causal. Masked scores are ``NEG_INF``. With ``return_lse``
    also the float32 ``torch.logsumexp`` of each row's masked, scaled (and
    capped) scores, (B, KV, G, S). ``exploit_window`` is taken for the
    kernel wrapper's signature and changes nothing: this version masks
    every key either way, which is the function both of the kernel's
    launches compute.
    """
    B, S, KV, G, hd = q.shape
    scale = hd**-0.5 if sm_scale is None else sm_scale
    qf = q.float() * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.float())  # (B, KV, G, S, S)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = kpos < S
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out
