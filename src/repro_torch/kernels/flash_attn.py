"""Launcher for the CUDA flash-attention forward kernel (``csrc/flash_attn.cu``).

Replaces the TPU kernel ``repro.kernels.flash_attn.flash_attention_fwd_pallas``:
GQA attention forward over q (B, S, KV, G, hd) and k, v (B, S, KV, hd),
causal or not, optionally over a sliding window (query i sees key j only
if ``i - j < window``, the JAX package's ``FlashSpec`` mask) and with a
logit softcap (each scaled score s becomes ``softcap * tanh(s / softcap)``
before the mask, the JAX package's ``_scores``), with an online softmax in
float32 and the KV tiles above the diagonal or below the window skipped.
``exploit_window=False`` (the model's option of that name) loads the tiles
below the window too and leaves the window to the mask: the same function,
computed over every key up to the diagonal, bit for bit the windowed
launch's result. See the CUDA source for the design and what
bounds it.

The launch dispatches on dtype to one of the source's two kernels, and both
compute the same function: bfloat16 goes to the tensor-core kernel (both
products on ``wgmma``, K/V loaded by TMA, P rounded to bfloat16 before
P V), float32 to the CUDA-core kernel, which keeps full float32 products.

Limits, checked here and raised on: float32 or bfloat16 tensors of one
dtype on one CUDA device, contiguous, in those layouts, in bfloat16
starting on a 16-byte boundary (the TMA's rule); hd one of
:data:`HEAD_DIMS`; at most 64 query heads per KV head. Like the TPU kernel,
it scales q by ``sm_scale`` (default ``hd ** -0.5``) itself: pass q not
pre-scaled, or pre-scaled with ``sm_scale=1.0``.

With ``return_lse=True`` the same launch also writes each query row's
log-sum-exp of its scaled, masked scores (float32, (B, KV, G, S)), the
residual a backward pass recomputes the probabilities from
(``models/flash.py``); without it the kernel writes no such row.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

NAME = "flash_attn"
HEAD_DIMS = (16, 32, 64, 80, 128)
MAX_GROUP = 64  # query rows per tile in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attn_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, p]
        lib.flash_attn_launch.restype = i
        lib._typed = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int | None,
           softcap: float | None = None) -> None:
    if q.dim() != 5:
        raise ValueError(f"flash_attn: q must be (B, S, KV, G, hd), got {tuple(q.shape)}")
    B, S, KV, G, hd = q.shape
    if window is not None and not 1 <= window < 2**31:
        raise ValueError(f"flash_attn: window must be a positive int32, got {window}")
    if softcap is not None and not 0 < softcap < float("inf"):
        raise ValueError(f"flash_attn: softcap must be a positive finite float, got {softcap}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_attn: {name} must lie on one CUDA device, "
                             f"got {t.device} (q on {q.device})")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise ValueError(f"flash_attn: q, k, v must share a dtype among "
                             f"float32 and bfloat16, got {name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attn: {name} is not contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attn: {name} does not start on a 16-byte boundary")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S, KV, hd):
            raise ValueError(f"flash_attn: {name} must be {(B, S, KV, hd)}, "
                             f"got {tuple(t.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attn: head dim {hd} not among {HEAD_DIMS}")
    if G > MAX_GROUP or min(B, S, KV, G) < 1:
        raise ValueError(f"flash_attn: need B, S, KV >= 1 and 1 <= G <= {MAX_GROUP}, "
                         f"got {tuple(q.shape)}")


def flash_attention_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, sm_scale: float | None = None,
                             window: int | None = None, return_lse: bool = False,
                             softcap: float | None = None, exploit_window: bool = True):
    """Launch the kernel for q's dtype; returns (B, S, KV, G, hd) in that dtype,
    and with ``return_lse`` also the float32 log-sum-exp (B, KV, G, S) of the
    capped scores.

    bfloat16 runs the tensor-core kernel, float32 the CUDA-core kernel, each
    in its capped instantiation when ``softcap`` is set. The launch is
    asynchronous on the current stream.
    """
    _check(q, k, v, window, softcap)
    B, S, KV, G, hd = q.shape
    scale = hd**-0.5 if sm_scale is None else float(sm_scale)
    lib = _lib()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        lse = (torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
               if return_lse else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attn_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), None if lse is None else lse.data_ptr(),
                                     B, S, KV, G, hd, _DTYPES[q.dtype], int(causal),
                                     window or 0, int(not exploit_window), scale,
                                     float(softcap or 0.0), stream)
    _build.check(lib, NAME, code, "flash_attn launch")
    return (out, lse) if return_lse else out
