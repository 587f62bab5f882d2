"""One ``Compressor`` registry for the simulator's messages and grouped leaves.

PyTorch counterpart of ``repro.core.compress``. A compressor is a frozen,
hashable config object with

* ``compress(dw)``          -- the simulator form: one ``(d,)`` message, or a
  batch ``(..., d)`` of them filtered row by row; returns ``(sent,
  residual)`` with ``sent + residual == dw`` (error feedback);
* ``compress_grouped(dw)``  -- the exchange form: a ``(G, *shape)`` leaf,
  returns ``(sent, mask)`` per worker group;
* ``wire_bytes(d)``         -- bytes on the wire for one simulator message;
* ``payload_bytes(count)``  -- bytes for ``count`` kept coordinates.

Registry entries (the JAX package's names and byte formulas):

* ``dense``          -- no filtering, 4 B/coordinate;
* ``topk_exact``     -- exactly-k top-|dw| (ties toward the lower index, by
  :func:`repro_torch.core.filter.topk_mask_exact`'s stable sort), 8 B per
  kept entry (4 B value + 4 B int32 index);
* ``topk_threshold`` -- the paper's threshold filter ``|dw| >= c_k`` (ties
  pass); the grouped form uses the two-round histogram threshold;
* ``topk_q8``        -- top-k selection + 8-bit linear quantization of the
  kept values (per-message scale), 5 B per kept entry + 4 B scale; the
  quantization error stays in the residual.

The banded filter of Table I (``kernels.ops.topk_filter``) is not one of
these entries: its kept set differs from the exact top-k inside one band.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import filter as msg_filter
from repro_torch.kernels import ops
from repro_torch.tracing import span

# ---------------------------------------------------------------------------
# Histogram threshold (grouped, O(n) memory).
# ---------------------------------------------------------------------------


def threshold_for_topk(x: torch.Tensor, k: int, refine: bool = True) -> torch.Tensor:
    """Approximate k-th-largest-|x| threshold via 1-2 histogram rounds.

    Guarantee: #{|x| >= t} >= min(k, #{|x| >= max|x|*2^-22}), and the
    overshoot is bounded by one refined bucket's population. On the card
    this is ``csrc/exchange_threshold.cu``, with no host sync, bit for bit
    its plain version (``kernels/exchange_threshold.py``), which the CPU runs.
    """
    with span("exchange.threshold", timed=True):
        return ops.exchange_threshold(x, k, refine)


def kept_target(rho: float, n: int) -> int:
    """The grouped filters' k: entries to keep of a leaf's n, at least one."""
    return max(1, int(rho * n))


def sparsify_leaf(dw: torch.Tensor, rho: float, refine: bool = True):
    """dw (G, *shape) -> (sent, kept_mask) with ~rho fraction kept per group."""
    G = dw.shape[0]
    n = math.prod(dw.shape[1:])
    k = kept_target(rho, n)
    thresh = torch.stack([threshold_for_topk(dw[g], k, refine) for g in range(G)])
    tb = thresh.reshape((G,) + (1,) * (dw.ndim - 1))
    mask = torch.abs(dw) >= tb
    sent = torch.where(mask, dw, torch.zeros_like(dw))
    return sent, mask


# ---------------------------------------------------------------------------
# The registry.
# ---------------------------------------------------------------------------

_COMPRESSORS: dict[str, type["Compressor"]] = {}


def register_compressor(name: str):
    """Class decorator: make a Compressor constructible by registry name."""

    def deco(cls: type["Compressor"]) -> type["Compressor"]:
        cls.compressor_name = name
        _COMPRESSORS[name] = cls
        return cls

    return deco


def available_compressors() -> tuple[str, ...]:
    return tuple(sorted(_COMPRESSORS))


def get_compressor(name: str) -> type["Compressor"]:
    try:
        return _COMPRESSORS[name]
    except KeyError:
        raise ValueError(
            f"unknown compressor {name!r}; available: {available_compressors()}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Frozen (hashable) compression config -- see the module docstring.

    ``k`` parameterizes the simulator form (kept entries of a ``(d,)``
    message); ``rho`` the grouped form, where the kept count is derived per
    leaf.
    """

    compressor_name = "abstract"

    k: int = 0
    rho: float = 1.0
    # Second histogram round for threshold-based grouped compression;
    # ignored by compressors that do not use the histogram.
    refine: bool = True

    # -- byte accounting (one formula for both forms) ----------------------

    value_bytes: int = dataclasses.field(default=4, init=False)
    index_bytes: int = dataclasses.field(default=4, init=False)
    message_overhead: int = dataclasses.field(default=0, init=False)

    @property
    def entry_bytes(self) -> int:
        return self.value_bytes + self.index_bytes

    def payload_bytes(self, count):
        """Bytes for ``count`` kept coordinates (an int or a tensor)."""
        return count * self.entry_bytes + self.message_overhead

    def wire_bytes(self, d: int) -> int:
        """Bytes on the wire for one simulator message of a (d,) vector."""
        return int(self.payload_bytes(self.k if self.k else d))

    # -- compression -------------------------------------------------------

    def compress(self, dw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(..., d) messages -> (sent, residual), sent + residual == dw."""
        raise NotImplementedError

    def compress_grouped(self, dw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(G, *shape) leaf -> (sent, kept_mask) per worker group."""
        raise NotImplementedError


@register_compressor("dense")
@dataclasses.dataclass(frozen=True)
class Dense(Compressor):
    """No filtering: the whole vector crosses the wire, values only."""

    index_bytes: int = dataclasses.field(default=0, init=False)

    def wire_bytes(self, d: int) -> int:
        return int(self.payload_bytes(d))

    def compress(self, dw):
        return dw, torch.zeros_like(dw)

    def compress_grouped(self, dw):
        return dw, torch.ones(dw.shape, dtype=torch.bool, device=dw.device)


@register_compressor("topk_exact")
@dataclasses.dataclass(frozen=True)
class TopKExact(Compressor):
    """Exactly-k filter (ties broken toward the lower index)."""

    def compress(self, dw):
        res = msg_filter.topk_mask_exact(dw, self.k)
        return res.sent, res.residual

    def compress_grouped(self, dw):
        G = dw.shape[0]
        n = math.prod(dw.shape[1:])
        k = kept_target(self.rho, n)
        res = msg_filter.topk_mask_exact(dw.reshape(G, n), k)
        return res.sent.reshape(dw.shape), res.mask.reshape(dw.shape)


@register_compressor("topk_threshold")
@dataclasses.dataclass(frozen=True)
class TopKThreshold(Compressor):
    """The paper's filter: keep ``|dw| >= c_k`` (ties pass, Alg. 2 line 8).

    The simulator form computes ``c_k`` exactly; the grouped form uses the
    two-round histogram threshold (same semantics, approximate ``c_k``).
    """

    def compress(self, dw):
        res = msg_filter.topk_mask(dw, self.k)
        return res.sent, res.residual

    def compress_grouped(self, dw):
        return sparsify_leaf(dw, self.rho, self.refine)


@register_compressor("topk_q8")
@dataclasses.dataclass(frozen=True)
class QuantizedTopK(Compressor):
    """Top-k selection + 8-bit linear quantization of the kept values.

    The message carries int8 values (scaled by one float32 a message) plus
    int32 indices: 5 B per kept entry + 4 B overhead. ``compress`` returns
    the dequantized payload, so the quantization error lands in the
    residual. ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """

    value_bytes: int = dataclasses.field(default=1, init=False)
    message_overhead: int = dataclasses.field(default=4, init=False)

    _LEVELS = 127.0

    def _dequantized(self, sent, mask, dims):
        scale = torch.amax(torch.abs(sent), dim=dims, keepdim=True) / self._LEVELS
        scale = torch.clamp(scale, min=torch.finfo(torch.float32).tiny)
        q = torch.round(sent / scale).to(torch.int8)
        deq = q.to(sent.dtype) * scale
        return torch.where(mask, deq, torch.zeros_like(deq))

    def compress(self, dw):
        res = msg_filter.topk_mask_exact(dw, self.k)
        sent = self._dequantized(res.sent, res.mask, -1)
        return sent, dw - sent

    def compress_grouped(self, dw):
        sent, mask = sparsify_leaf(dw, self.rho, refine=self.refine)
        return self._dequantized(sent, mask, tuple(range(1, dw.ndim))), mask


# ---------------------------------------------------------------------------
# Resolution: configs -> registry objects.
# ---------------------------------------------------------------------------


def for_method(method, d: int) -> Compressor:
    """Resolve a ``MethodConfig`` to its compressor (simulator path).

    With ``method.compressor`` unset: ``rho >= 1`` is dense, otherwise
    top-``ceil(rho d)`` with ``use_exact_k`` choosing exact-k vs threshold.
    """
    rho = method.rho
    if method.compressor is None:
        if rho >= 1.0:
            return Dense(rho=rho)
        k = msg_filter.num_kept(d, rho)
        cls = TopKExact if method.use_exact_k else TopKThreshold
        return cls(k=k, rho=rho)
    cls = get_compressor(method.compressor)
    if cls is Dense:
        return Dense(rho=rho)
    return cls(k=msg_filter.num_kept(d, rho), rho=rho)


def for_exchange(cfg) -> Compressor:
    """Resolve an exchange config (``compressor``, ``rho``, ``refine``)."""
    cls = get_compressor(cfg.compressor)
    if cls is Dense or cfg.rho >= 1.0:
        return Dense(rho=cfg.rho)
    return cls(rho=cfg.rho, refine=cfg.refine)
