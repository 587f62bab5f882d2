"""Launcher for the CUDA SDCA inner-loop kernel (``csrc/sdca_inner.cu``).

Replaces the TPU kernel ``repro.kernels.sdca_inner.sdca_inner_pallas``: one
ridge-SDCA epoch of H sequential coordinate steps for each of K workers, one
thread block per worker with the worker's ``v`` in shared memory. See the
CUDA source for the design and what bounds it.

Limits, checked here and raised on: float32 tensors on one CUDA device,
contiguous, ``idx`` int32; ``d`` at most :func:`max_d`, the floats of ``v``
that fit one block's opt-in shared memory (232,448 bytes on Hopper, so a
little over 58,000), which RCV1's ``d = 47,236`` lies inside. Steps whose index lies outside ``[0, n_k)`` are
skipped by the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.objectives import lam_n_f32
from repro_torch.kernels import _build

NAME = "sdca_inner"


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdca_inner_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, f, p]
        lib.sdca_inner_launch.restype = i
        lib.sdca_inner_max_d.argtypes = []
        lib.sdca_inner_max_d.restype = i
        lib._typed = True
    return lib


def max_d() -> int:
    """Largest ``d`` the kernel takes on the current device."""
    return int(_lib().sdca_inner_max_d())


def sdca_inner_cuda(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
                    sigma_prime: float, idx) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel; returns ``(dalpha (K, n_k), v (K, d))``.

    The launch is asynchronous on the current stream.
    """
    K, n_k, d = X.shape
    H = idx.shape[1]
    shapes = {"w_eff": (w_eff, (K, d)), "alpha": (alpha, (K, n_k)),
              "X": (X, (K, n_k, d)), "y": (y, (K, n_k)),
              "norms_sq": (norms_sq, (K, n_k)), "idx": (idx, (K, H))}
    for name, (t, shape) in shapes.items():
        want = torch.int32 if name == "idx" else torch.float32
        if not t.is_cuda or t.device != X.device:
            raise ValueError(f"sdca_inner: {name} must lie on {X.device}, "
                             f"got {t.device}")
        if t.dtype != want or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"sdca_inner: {name} must be a contiguous {want} tensor of "
                f"shape {shape}, got {t.dtype} {tuple(t.shape)}"
                f"{'' if t.is_contiguous() else ' (not contiguous)'}")
    lib = _lib()
    with torch.cuda.device(X.device):
        limit = int(lib.sdca_inner_max_d())
        if d > limit:
            raise ValueError(f"sdca_inner: d = {d} exceeds the kernel's limit "
                             f"of {limit} (v must fit one block's shared memory)")
        dalpha = torch.empty((K, n_k), dtype=torch.float32, device=X.device)
        v = torch.empty((K, d), dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        code = lib.sdca_inner_launch(
            w_eff.data_ptr(), alpha.data_ptr(), X.data_ptr(), y.data_ptr(),
            norms_sq.data_ptr(), idx.data_ptr(), dalpha.data_ptr(), v.data_ptr(),
            K, n_k, d, H, lam_n_f32(lam, n_global), float(sigma_prime), stream)
    _build.check(lib, NAME, code, "sdca_inner launch")
    return dalpha, v
