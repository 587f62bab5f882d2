"""The exchange's histogram threshold: CUDA kernel and plain version.

No TPU kernel is replaced: the JAX counterpart
(``repro.core.compress.threshold_for_topk``) is jnp. The threshold is the
approximate k-th largest ``|x|`` by one or two histogram rounds of 64
log-spaced buckets; ``core/compress.py`` ``threshold_for_topk`` states its
guarantee.

:func:`exchange_threshold_plain` is the PyTorch formulation: each round
writes full-size temporaries and counts with ``torch.bincount``, which on a
card reads its input's minimum and maximum back to the host, and copies a
constant to the device from pageable memory (the ``sync.*`` spans count
these three waits a round). :func:`exchange_threshold_cuda` computes the same
threshold as the two or three launches of ``csrc/exchange_threshold.cu``,
which evaluate every float32 step with the roundings torch uses on the card,
read nothing back to the host and allocate only a few KB of scratch; the
counts are integers, so on finite input the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.tracing import span

NAME = "exchange_threshold"
_NUM_BUCKETS = 64
_FLOOR = 2.0**-22


def _round(mag: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, k: int):
    """One histogram round on |x|; returns (t_lo, t_hi) bracketing k."""
    with span("exchange.histogram"):
        hi = torch.clamp(hi, min=1e-37)
        lo = torch.minimum(torch.maximum(lo, hi * 1e-37), hi)
        ratio = torch.log(lo / hi) / (_NUM_BUCKETS - 1)  # negative
        # Bucket 0 holds the largest magnitudes.
        idx = torch.where(mag >= lo, torch.log(torch.clamp(mag, min=1e-37) / hi) / ratio,
                          torch.full_like(mag, float(_NUM_BUCKETS)))
        idx = idx.to(torch.int32).clamp(0, _NUM_BUCKETS)
        with span("sync.bincount", syncs=2):  # on CUDA it reads its input's min and max
            counts = torch.bincount(idx.flatten().long(), minlength=_NUM_BUCKETS + 1)
        csum = torch.cumsum(counts[:_NUM_BUCKETS], 0)  # count(mag >= edge_j)
        reached = csum >= k
        hit, first = reached.any(), torch.argmax(reached.to(torch.int32))
        with span("sync.last_bucket"):  # a pageable copy to the device
            last = torch.tensor(_NUM_BUCKETS - 1, device=mag.device)
        j = torch.where(hit, first, last)

        def edge(i):
            return hi * torch.exp(ratio * i.to(torch.float32))

        t_lo = edge(j + 1)  # lower edge of bucket j
        t_hi = torch.where(j > 0, edge(j), torch.full_like(t_lo, math.inf))
        return t_lo, t_hi


def exchange_threshold_plain(x: torch.Tensor, k: int, refine: bool = True) -> torch.Tensor:
    """The threshold in plain PyTorch: a 0-dim float32 tensor."""
    mag = torch.abs(x.to(torch.float32))
    hi = torch.max(mag)
    t_lo, t_hi = _round(mag, hi, hi * _FLOOR, k)
    if refine:
        t_lo, _ = _round(mag, torch.where(torch.isinf(t_hi), hi, t_hi), t_lo, k)
    return t_lo


def _lib() -> ctypes.CDLL:
    lib = _build.load(NAME)
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.exchange_threshold_launch.argtypes = [p, i, ctypes.c_longlong, i, p, p, p]
        lib.exchange_threshold_launch.restype = i
        lib.exchange_threshold_scratch_words.argtypes = []
        lib.exchange_threshold_scratch_words.restype = i
        lib._typed = True
    return lib


def exchange_threshold_cuda(x: torch.Tensor, k: int, refine: bool = True) -> torch.Tensor:
    """The threshold on the card: a 0-dim float32 CUDA tensor.

    ``x`` is a CUDA tensor of any shape with 1 to 2**31 - 1 entries; one that
    is not contiguous float32 is converted first (a copy; the exchange's
    leaves need none). Two or three kernel launches on the current stream
    with no PyTorch op between them; the output and scratch come from
    ``torch.empty``, and nothing synchronizes with the host.
    """
    if not x.is_cuda:
        raise ValueError(f"exchange_threshold: need a CUDA tensor, got one on {x.device}")
    n = x.numel()
    if not 1 <= n < 2**31:
        raise ValueError(f"exchange_threshold: need 1 to 2**31 - 1 entries, got {n}")
    x = x.to(torch.float32).contiguous().view(-1)
    lib = _lib()
    with torch.cuda.device(x.device):
        scratch = torch.empty(int(lib.exchange_threshold_scratch_words()), dtype=torch.int32,
                              device=x.device)
        out = torch.empty((), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.exchange_threshold_launch(x.data_ptr(), n, int(k), int(bool(refine)),
                                             scratch.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, NAME, code, "exchange_threshold launch")
    return out
