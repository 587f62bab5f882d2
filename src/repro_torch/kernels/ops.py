"""Dispatch to the hand-written kernels, by the device of the input.

For tensors on the card each wrapper launches its CUDA kernel or raises;
for tensors on the CPU, where no kernel exists, it computes its plain
PyTorch version. There is no other fallback: no capacity check that
switches path, no flag that turns a kernel off, no ``try`` that gives way.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card, so that a run can show that its main path went through the kernels.
Its updates are safe from any thread (the experiment service launches from
several). A thread that records a CUDA graph counts its launches apart
(:func:`recording_launches`): they run when the graph replays, and the
replay adds them (:func:`add_launches`), so another thread's launches that
happen meanwhile are neither lost nor taken for the graph's.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attn import flash_attention_fwd_cuda
from repro_torch.kernels.sdca_inner import sdca_inner_cuda
from repro_torch.kernels.topk_filter import topk_filter_cuda, topk_filter_plain

LAUNCHES: dict[str, int] = {"sdca_inner": 0, "topk_filter": 0,
                             "flash_attention_fwd": 0}
_LAUNCH_LOCK = threading.Lock()
_RECORDING = threading.local()  # .counts: this thread's launches into a graph


def reset_launch_counts() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def add_launches(counts: dict[str, int]) -> None:
    """Add ``counts`` to ``LAUNCHES`` (a graph replay's launches)."""
    with _LAUNCH_LOCK:
        for name, n in counts.items():
            LAUNCHES[name] += n


def _count(name: str) -> None:
    recording = getattr(_RECORDING, "counts", None)
    if recording is not None:
        recording[name] += 1
        return
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Count this thread's launches into the yielded dict instead of
    ``LAUNCHES`` (a stream capture: they run only when the graph replays)."""
    prev = getattr(_RECORDING, "counts", None)
    counts = dict.fromkeys(LAUNCHES, 0)
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = prev


def topk_filter(dw: torch.Tensor, k: int):
    """Message filter F by histogram select: ``(sent, residual, mask)``.

    The banded filter of Table I (see ``kernels/topk_filter.py`` for its
    contract). On the CPU it is ``topk_filter_plain``, the same select.
    """
    if dw.is_cuda:
        out = topk_filter_cuda(dw, k)
        _count("topk_filter")
        return out
    return topk_filter_plain(dw, k)


def sdca_epoch(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
               sigma_prime: float, idx, *, loss: str = "ridge", workers=None,
               map_error=None, alpha_rows: bool = False, sigma_rows=None):
    """SDCA epoch of a batch of workers for ``loss``: ``(dalpha, v)``.

    ``X (K, n_k, d)``, ``alpha``, ``y``, ``norms_sq (K, n_k)`` hold every
    worker; ``workers`` (B entries in ``[0, K)``) names the worker of each
    batch row, all K in order when it is None. It is host data, or an int32
    tensor on the input's device, which is used without a host check or
    sync: on the card a bad entry lands in ``map_error``
    (``sdca_inner.map_error_word``), read by the caller; on the CPU it
    raises at once. ``w_eff (B, d)`` and the int32 visit orders ``idx (B,
    H)`` are per batch row, and so are the results, ``dalpha (B, n_k)`` and
    ``v (B, d)``; with ``alpha_rows`` so is ``alpha (B, n_k)``, and
    ``sigma_rows (B,)`` gives each row its own sigma'. On the card this is
    one launch of the CUDA kernel, one thread-block cluster per batch row,
    for each of the three losses; on the CPU it is ``ref.sdca_inner_ref``,
    the plain ``sdca_epoch_plain``.
    """
    if X.is_cuda:
        out = sdca_inner_cuda(w_eff, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, idx, loss=loss, workers=workers,
                              map_error=map_error, alpha_rows=alpha_rows,
                              sigma_rows=sigma_rows)
        _count("sdca_inner")
        return out
    return ref.sdca_inner_ref(w_eff, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, idx, loss=loss, workers=workers,
                              alpha_rows=alpha_rows, sigma_rows=sigma_rows)


def flash_attention_fwd(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    """GQA attention forward: q (B, S, KV, G, hd), k/v (B, S, KV, hd) -> q's shape.

    q is scaled by ``sm_scale`` (default ``hd ** -0.5``) inside, as on the
    TPU; a caller holding pre-scaled q passes ``sm_scale=1.0``. On the card
    this is one launch of ``csrc/flash_attn.cu``; on the CPU it is
    ``ref.flash_attention_fwd_ref``.
    """
    if q.is_cuda:
        out = flash_attention_fwd_cuda(q, k, v, causal=causal, sm_scale=sm_scale)
        _count("flash_attention_fwd")
        return out
    return ref.flash_attention_fwd_ref(q, k, v, causal=causal, sm_scale=sm_scale)
