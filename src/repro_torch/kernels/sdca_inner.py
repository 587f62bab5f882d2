"""Launcher for the CUDA SDCA inner-loop kernel (``csrc/sdca_inner.cu``).

Replaces the TPU kernel ``repro.kernels.sdca_inner.sdca_inner_pallas``: one
SDCA epoch of H sequential coordinate steps for each of K workers, for the
ridge, smoothed-hinge and logistic losses. Each worker runs on one
thread-block cluster of C CTAs that split ``d`` between them, with ``w_eff``
and ``v`` in registers, the rows prefetched into shared memory, and each
step's partial sums exchanged through distributed shared memory; see the
CUDA source for the design and what bounds it, and :func:`plan` for how C
is chosen.

Limits, checked here and raised on: float32 tensors on one CUDA device,
contiguous, ``idx`` int32; ``d`` at most :func:`max_d`, which is 16 CTAs
times the slice one CTA holds. A slice lives in registers (M floats of
``w_eff``, of ``v`` and of two rows a thread, 256 threads, M = 12 or 24 by
instance) and passes through four ring slots of M * 256 floats in shared
memory beside the worker's ``dalpha``. On Hopper (232,448 bytes a CTA) that
makes 98,304 up to ``n_k = 31,398`` and 49,152 up to 43,686 (RCV1's
``d = 47,236`` at ``n_k = 4,096`` lies inside; the one-block design of the
first slice stopped near 58,000). Steps whose index lies outside
``[0, n_k)`` are skipped by the kernel.

An optional worker map ``workers (B,)`` launches B clusters on any B of the
K workers without copying their rows: cluster b reads the rows of ``X``,
``alpha``, ``y`` and ``norms_sq`` of worker ``workers[b]``, takes
``w_eff[b]`` and ``idx[b]`` and writes ``dalpha[b]`` and ``v[b]``. Host
data (a sequence or a CPU tensor) is checked to lie in ``[0, K)`` and
copied to the card. An int32 tensor already on the card (an arrival order
the device sorted) is used as it is, with no host check, copy or sync, so a
launch inside a captured CUDA graph can take it: the kernel checks each
entry, and a cluster whose entry lies outside ``[0, K)`` writes nothing and
records the first such row and entry in ``map_error``, a two-int word from
:func:`map_error_word` that the caller reads with its results and hands to
:func:`raise_map_error`.

Two more options run independent problems over one shared ``X`` (the
variants of a sweep, ``V * K`` batch rows): ``alpha_rows=True`` reads
``alpha (B, n_k)`` at batch row b instead of at the worker, and
``sigma_rows (B,)``, a float32 tensor on the card, gives each row its own
sigma'.

The library keeps per-process state: the kernels' attributes, which the
plan's occupancy queries set and reset. Every call into it holds
``_C_LOCK``, so a plan computed on one thread never changes the attributes
under another thread's launch, and a plan is read only once it is whole.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from repro_torch.core.objectives import lam_n_f32
from repro_torch.kernels import _build
from repro_torch.tracing import span

NAME = "sdca_inner"
LOSSES = {"ridge": 0, "smoothed_hinge": 1, "logistic": 2}
_C_LOCK = threading.RLock()


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if getattr(lib, "_typed", False):
        return lib
    with _C_LOCK:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.sdca_inner_launch.argtypes = [p, p, p, p, p, p, p, i, i, p, p, p, p, i, i, i, i,
                                          f, f, i, i, i, i, p]
        lib.sdca_inner_launch.restype = i
        lib.sdca_inner_prepare.argtypes = [i, i, i, i, i]
        lib.sdca_inner_prepare.restype = i
        lib.sdca_inner_plan.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_int)]
        lib.sdca_inner_plan.restype = i
        lib.sdca_inner_max_d.argtypes = [i]
        lib.sdca_inner_max_d.restype = i
        lib.sdca_inner_probe_launch.argtypes = [i, i, i, i, p, p]
        lib.sdca_inner_probe_launch.restype = i
        lib._typed = True
    return lib


@functools.lru_cache(maxsize=None)
def _max_d(device: int, n_k: int) -> int:
    with _C_LOCK:
        return int(_lib().sdca_inner_max_d(n_k))  # analysis: host-ok (a C int)


def max_d(n_k: int) -> int:
    """Largest ``d`` the kernel takes on the current device for ``n_k`` rows."""
    return _max_d(torch.cuda.current_device(), n_k)


@functools.lru_cache(maxsize=None)
def _plan(device: int, K: int, n_k: int, d: int, cluster: int) -> tuple[int, ...]:
    out = (ctypes.c_int * 5)()
    lib = _lib()
    with _C_LOCK:
        code = lib.sdca_inner_plan(K, n_k, d, cluster, out)
    _build.check(lib, NAME, code, "sdca_inner plan")
    return tuple(out)


def _plan_dict(K: int, n_k: int, d: int, cluster: int) -> dict[str, int]:
    C, stages, smem, active, per_thread = _plan(torch.cuda.current_device(), K, n_k,
                                                d, cluster)
    return dict(cluster=C, stages=stages, smem_bytes=smem, active_clusters=active,
                per_thread=per_thread, ctas=K * C)


def plan(K: int, n_k: int, d: int) -> dict[str, int]:
    """How the kernel launches K clusters (a batch of K workers, mapped or
    not) on the current device.

    ``cluster`` (C) is the largest of 16, 8, 4, 2, 1 whose slices hold at
    least 32 floats, fit the registers of one of the kernel's instances
    (``per_thread`` floats of each of ``w_eff``, ``v`` and two rows a thread:
    12 or 24) and the shared memory with four ring slots or more
    (``stages``), and keep all K clusters resident at once; if none keeps K
    resident, the one that runs them in the fewest waves of
    ``active_clusters``, the larger C on a tie. It depends on the device, K,
    n_k and d only (and is computed once for each), so a rerun repeats bit
    for bit. ``cluster`` is 0 when nothing fits.
    """
    return _plan_dict(K, n_k, d, 0)


def prepare(loss: str, B: int, n_k: int, d: int) -> dict[str, int]:
    """Load the library, cache the plan of a B-row launch and set its
    kernel's attributes, so that a later launch of that shape calls no
    occupancy query and no ``cudaFuncSetAttribute``: what a stream capture
    needs. Returns the plan."""
    if loss not in LOSSES:
        raise ValueError(f"sdca_inner: unknown loss {loss!r}")
    p = plan(B, n_k, d)
    if p["cluster"] == 0:
        raise ValueError(f"sdca_inner: no cluster takes B = {B}, n_k = {n_k}, d = {d}")
    lib = _lib()
    with _C_LOCK:
        code = lib.sdca_inner_prepare(LOSSES[loss], p["cluster"], p["stages"],
                                      p["per_thread"], n_k)
    _build.check(lib, NAME, code, "sdca_inner prepare")
    max_d(n_k)
    return p


def map_error_word(device) -> torch.Tensor:
    """A zeroed error word for launches with a device worker map: after
    them it holds ``{1 + batch row, entry}`` of the first entry outside
    ``[0, K)``, or zeros."""
    return torch.zeros(2, dtype=torch.int32, device=device)


def raise_map_error(word, K: int) -> None:
    """Raise ``ValueError`` naming the bad entry if the error word (host
    values or a tensor, read here) records one."""
    row, entry = (int(x) for x in (word.tolist() if isinstance(word, torch.Tensor)
                                   else word))
    if row:
        raise ValueError(f"sdca_inner: worker map entry {entry} of batch row {row - 1} "
                         f"lies outside [0, {K})")


def _check_inputs(w_eff, alpha, X, y, norms_sq, idx, loss: str, B: int,
                  alpha_rows: bool = False, sigma_rows=None) -> None:
    if loss not in LOSSES:
        raise ValueError(f"sdca_inner: unknown loss {loss!r}")
    K, n_k, d = X.shape
    H = idx.shape[1]
    shapes = {"w_eff": (w_eff, (B, d)), "alpha": (alpha, (B if alpha_rows else K, n_k)),
              "X": (X, (K, n_k, d)), "y": (y, (K, n_k)),
              "norms_sq": (norms_sq, (K, n_k)), "idx": (idx, (B, H))}
    if sigma_rows is not None:
        shapes["sigma_rows"] = (sigma_rows, (B,))
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


def _device_map(workers: torch.Tensor, map_error, device) -> torch.Tensor:
    """A worker map already on the card, taken as it is (no sync)."""
    if workers.device != device or workers.dtype != torch.int32 or workers.dim() != 1 \
            or not workers.is_contiguous() or workers.numel() == 0:
        raise ValueError(f"sdca_inner: a worker map on the card must be a non-empty "
                         f"contiguous 1-D int32 tensor on {device}, got {workers.dtype} "
                         f"{tuple(workers.shape)} on {workers.device}")
    if (not isinstance(map_error, torch.Tensor) or map_error.device != device
            or map_error.dtype != torch.int32 or tuple(map_error.shape) != (2,)):
        raise ValueError("sdca_inner: a worker map on the card needs map_error, the "
                         "int32 word of map_error_word() on the same device, which the "
                         "caller reads after the launch (raise_map_error)")
    return workers


def _worker_map(workers, K: int, device) -> torch.Tensor:  # analysis: host-ok (a host map)
    """A host map as an int32 tensor on ``device``, checked on the host first."""
    host = torch.as_tensor(workers, dtype=torch.int64).flatten()
    if host.numel() == 0:
        raise ValueError("sdca_inner: workers is empty")
    if int(host.min()) < 0 or int(host.max()) >= K:
        raise ValueError(f"sdca_inner: workers must lie in [0, {K}), got "
                         f"{host.tolist()}")
    with span("sync.worker_map"):  # a pageable copy to the device
        return host.to(torch.int32).to(device)


def sdca_inner_cuda(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int,
                    sigma_prime: float, idx, *, loss: str = "ridge", workers=None,
                    map_error=None, alpha_rows: bool = False,
                    sigma_rows=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel by :func:`plan`; returns ``(dalpha (B, n_k), v (B, d))``.

    B is K without a worker map, ``len(workers)`` with one. The launch is
    asynchronous on the current stream; with a map on the card it makes no
    host sync (see the module docstring for ``map_error``, ``alpha_rows``
    and ``sigma_rows``).
    """
    K, n_k, d = X.shape
    if isinstance(workers, torch.Tensor) and workers.is_cuda:
        wmap, err = _device_map(workers, map_error, X.device), map_error
    else:
        wmap = None if workers is None else _worker_map(workers, K, X.device)
        err = None
    B = K if wmap is None else wmap.numel()
    _check_inputs(w_eff, alpha, X, y, norms_sq, idx, loss, B, alpha_rows, sigma_rows)
    with torch.cuda.device(X.device):
        return _launch(w_eff, alpha, X, y, norms_sq, lam, n_global, sigma_prime, idx,
                       loss, plan(B, n_k, d), wmap, err, alpha_rows, sigma_rows)


def _launch(w_eff, alpha, X, y, norms_sq, lam: float, n_global: int, sigma_prime: float,
            idx, loss: str, p: dict[str, int], wmap: torch.Tensor | None = None,
            map_error: torch.Tensor | None = None, alpha_rows: bool = False,
            sigma_rows: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch with the plan ``p``, on inputs :func:`sdca_inner_cuda` has checked.

    :func:`sdca_inner_cuda` passes :func:`plan`'s and the worker map (an
    int32 tensor on the card, or None) with its error word; a measurement
    of another cluster size passes ``_plan_dict(B, n_k, d, C)``.
    """
    K, n_k, d = X.shape
    B = idx.shape[0]
    with torch.cuda.device(X.device):
        limit = max_d(n_k)
        if d > limit:
            raise ValueError(f"sdca_inner: d = {d} exceeds the kernel's limit of "
                             f"{limit} at n_k = {n_k} (a cluster's shared memory)")
        if p["cluster"] == 0:
            raise ValueError(f"sdca_inner: no cluster takes B = {B}, n_k = {n_k}, "
                             f"d = {d}")
        dalpha = torch.empty((B, n_k), dtype=torch.float32, device=X.device)
        v = torch.empty((B, d), dtype=torch.float32, device=X.device)
        stream = torch.cuda.current_stream(X.device).cuda_stream
        lib = _lib()
        with _C_LOCK:
            code = lib.sdca_inner_launch(
                w_eff.data_ptr(), alpha.data_ptr(), X.data_ptr(), y.data_ptr(),
                norms_sq.data_ptr(), idx.data_ptr(), None if wmap is None else wmap.data_ptr(),
                K, int(alpha_rows), None if sigma_rows is None else sigma_rows.data_ptr(),
                None if map_error is None else map_error.data_ptr(),
                dalpha.data_ptr(), v.data_ptr(), B, n_k, d, idx.shape[1],
                lam_n_f32(lam, n_global), float(sigma_prime), LOSSES[loss], p["cluster"],
                p["stages"], p["per_thread"], stream)
    _build.check(lib, NAME, code, "sdca_inner launch")
    return dalpha, v


def exchange_probe(K: int, cluster_size: int, H: int, device, *,
                   barrier: bool = False) -> torch.Tensor:
    """Launch the probe kernel: K clusters run H exchange round trips.

    The exchange is the kernel's: every warp of every CTA sends one float4
    to every CTA by ``st.async``, completing on the receiver's mbarrier;
    with ``barrier``, plain DSMEM stores and ``barrier.cluster`` instead. It
    measures the serial floor of the design, timed by the caller; it is not
    a step of any path, so it counts no launch.
    """
    out = torch.empty(K, dtype=torch.float32, device=device)
    lib = _lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        code = lib.sdca_inner_probe_launch(K, cluster_size, H, 0 if barrier else 1,
                                           out.data_ptr(), stream)
    _build.check(lib, NAME, code, "sdca_inner probe launch")
    return out
