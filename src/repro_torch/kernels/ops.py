"""Dispatch to the hand-written kernels, by the device of the input.

For tensors on the card each wrapper launches its CUDA kernel or raises;
for tensors on the CPU, where no kernel exists, it computes its plain
PyTorch version. There is no other fallback: no capacity check that
switches path, no flag that turns a kernel off, no ``try`` that gives way.
The flash forward also takes ``meta`` tensors (a step traced for its
shapes and FLOPs, never run): there it returns empty outputs of the right
shapes, computes nothing and launches nothing, and a
:func:`recording_meta_calls` block lists the call so that its FLOPs can be
counted from its shapes (``launch/hlo_analysis.py``); on any other device
it raises.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card, so that a run can show that its main path went through the kernels.
Its updates are safe from any thread (the experiment service launches from
several). A thread that records a CUDA graph counts its launches apart
(:func:`recording_launches`): they run when the graph replays, and the
replay adds them (:func:`add_launches`), so another thread's launches that
happen meanwhile are neither lost nor taken for the graph's. On the CPU,
where nothing launches, a recording block counts the wrappers' calls of
their plain versions instead: the launches the same calls make on the card
(the analyzer's contracts read them, ``repro_torch.analysis.contracts``);
``LAUNCHES`` never counts a plain call.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.exchange_apply import (exchange_apply_add_cuda,
                                                exchange_apply_add_plain,
                                                exchange_apply_split_cuda,
                                                exchange_apply_split_plain)
from repro_torch.kernels.exchange_threshold import (exchange_threshold_cuda,
                                                    exchange_threshold_plain)
from repro_torch.kernels.flash_attn import flash_attention_fwd_cuda
from repro_torch.kernels.sdca_inner import sdca_inner_cuda
from repro_torch.kernels.topk_filter import topk_filter_cuda, topk_filter_plain

LAUNCHES: dict[str, int] = {"sdca_inner": 0, "topk_filter": 0,
                             "flash_attention_fwd": 0, "exchange_threshold": 0,
                             "exchange_apply": 0}
_LAUNCH_LOCK = threading.Lock()
_RECORDING = threading.local()  # .counts: this thread's launches into a graph
_META = threading.local()  # .calls: this thread's flash forwards on meta tensors


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


def _count_plain(name: str) -> None:
    recording = getattr(_RECORDING, "counts", None)
    if recording is not None:
        recording[name] += 1


@contextlib.contextmanager
def recording_launches():
    """Count this thread's launches into the yielded dict instead of
    ``LAUNCHES`` (a stream capture: they run only when the graph replays),
    and its calls of the plain versions on the CPU."""
    prev = getattr(_RECORDING, "counts", None)
    counts = dict.fromkeys(LAUNCHES, 0)
    _RECORDING.counts = counts
    try:
        yield counts
    finally:
        _RECORDING.counts = prev


@contextlib.contextmanager
def recording_meta_calls():
    """Yield a list that collects, for each flash forward this thread calls on
    ``meta`` tensors, its arguments: ``q_shape`` (B, S, KV, G, hd), ``causal``,
    ``window``, ``softcap``, ``exploit_window``."""
    prev = getattr(_META, "calls", None)
    calls: list[dict] = []
    _META.calls = calls
    try:
        yield calls
    finally:
        _META.calls = prev


def topk_filter(dw: torch.Tensor, k: int):
    """Message filter F by histogram select: ``(sent, residual, mask)``.

    The banded filter of Table I (see ``kernels/topk_filter.py`` for its
    contract). On the CPU it is ``topk_filter_plain``, the same select.
    """
    if dw.is_cuda:
        out = topk_filter_cuda(dw, k)
        _count("topk_filter")
        return out
    _count_plain("topk_filter")
    return topk_filter_plain(dw, k)


def exchange_threshold(x: torch.Tensor, k: int, refine: bool = True) -> torch.Tensor:
    """The exchange's histogram threshold of ``x`` for ``k`` kept entries, 0-dim float32.

    ``core/compress.py`` ``threshold_for_topk`` states what it computes. On
    the card this is one call of ``csrc/exchange_threshold.cu`` (three
    launches, two without ``refine``, and no host sync); on the CPU it is
    ``exchange_threshold_plain``, the same rounds in PyTorch.
    """
    if x.is_cuda:
        out = exchange_threshold_cuda(x, k, refine)
        _count("exchange_threshold")
        return out
    _count_plain("exchange_threshold")
    return exchange_threshold_plain(x, k, refine)


def exchange_apply_add(res: torch.Tensor, grad: torch.Tensor) -> None:
    """The exchange's residual add in place: ``res += grad`` in float32.

    ``kernels/exchange_apply.py`` states the split it begins. On the card
    this is one launch of ``csrc/exchange_apply.cu`` (``res`` and ``grad``
    contiguous, ``grad`` float32, bfloat16 or float16), counted under
    ``exchange_apply``; on the CPU it is ``exchange_apply_add_plain``.
    """
    if res.is_cuda:
        exchange_apply_add_cuda(res, grad)
        _count("exchange_apply")
        return
    _count_plain("exchange_apply")
    exchange_apply_add_plain(res, grad)


def exchange_apply_split(res, acc, pg, dense_step, thresh, sent_count, byte_count, *,
                         dense_bytes: tuple[int, int], sparse_bytes: tuple[int, int]) -> None:
    """The exchange's split of ``dw`` (held in ``res``) at ``thresh``, in place.

    Updates ``acc``, ``res`` and the group's 0-dim ``sent_count`` and
    ``byte_count`` (``kernels/exchange_apply.py`` states how); ``thresh``
    None sends every coordinate. ``dense_bytes`` and ``sparse_bytes`` are
    (bytes an entry, bytes a message) of the two formats. On the card this is
    one launch of ``csrc/exchange_apply.cu`` that reads the 0-dim tensors
    there, with no host sync, counted under ``exchange_apply``; on the CPU it
    is ``exchange_apply_split_plain``.
    """
    kw = dict(dense_bytes=dense_bytes, sparse_bytes=sparse_bytes)
    if res.is_cuda:
        exchange_apply_split_cuda(res, acc, pg, dense_step, thresh, sent_count, byte_count, **kw)
        _count("exchange_apply")
        return
    _count_plain("exchange_apply")
    exchange_apply_split_plain(res, acc, pg, dense_step, thresh, sent_count, byte_count, **kw)


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
    _count_plain("sdca_inner")
    return ref.sdca_inner_ref(w_eff, alpha, X, y, norms_sq, lam, n_global,
                              sigma_prime, idx, loss=loss, workers=workers,
                              alpha_rows=alpha_rows, sigma_rows=sigma_rows)


def flash_attention_fwd(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
                        window: int | None = None, return_lse: bool = False,
                        softcap: float | None = None, exploit_window: bool = True):
    """GQA attention forward: q (B, S, KV, G, hd), k/v (B, S, KV, hd) -> q's shape.

    q is scaled by ``sm_scale`` (default ``hd ** -0.5``) inside, as on the
    TPU; a caller holding pre-scaled q passes ``sm_scale=1.0``. ``softcap``
    maps each scaled score s to ``softcap * tanh(s / softcap)`` before the
    mask (the JAX package's ``_scores``). ``window`` limits query i to keys
    j with ``i - j < window`` (the JAX package's windowed
    ``flash_attention``; its Pallas kernel has no window). ``exploit_window``
    False (the JAX package's baseline of that name) computes the same
    function over every key up to the diagonal: on the card a launch that
    loads the tiles below the window too, bit for bit the windowed launch's
    result; the plain version always masks every key, so on the CPU the
    flag changes nothing. With ``return_lse`` it returns ``(out, lse)``, lse
    the float32 log-sum-exp of each query row's scaled (capped) scores, (B,
    KV, G, S). On the card this is one launch of ``csrc/flash_attn.cu``; on
    the CPU it is ``ref.flash_attention_fwd_ref``; on ``meta`` it returns
    empty outputs (see the module docstring).
    """
    kw = dict(causal=causal, sm_scale=sm_scale, window=window, return_lse=return_lse,
              softcap=softcap, exploit_window=exploit_window)
    if q.is_cuda:
        out = flash_attention_fwd_cuda(q, k, v, **kw)
        _count("flash_attention_fwd")
        return out
    if q.is_meta:
        calls = getattr(_META, "calls", None)
        if calls is not None:
            calls.append(dict(q_shape=tuple(q.shape), causal=causal, window=window,
                              softcap=softcap, exploit_window=exploit_window))
        out = torch.empty_like(q)
        if not return_lse:
            return out
        B, S, KV, G, _ = q.shape
        return out, torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_fwd: no kernel and no plain version on {q.device}; "
                         "q must lie on a CUDA device, the CPU or meta")
    _count_plain("flash_attention_fwd")
    return ref.flash_attention_fwd_ref(q, k, v, **kw)
