"""GroupedDeltaExchange: ACPD as a gradient-exchange layer for deep nets.

PyTorch counterpart of ``repro.core.exchange``. Each slice of the batch is
one ACPD "worker group". Per train step:

    dw_g   = residual_g + grad_g                    (error accumulation, Alg.2 l.6)
    F_g    = compress(dw_g)                         (message filter, l.7-9)
    update = gamma * sum_g p_g F_g / B              (server update, Alg.1 l.10)
    residual_g <- p_g (dw_g - F_g) + (1-p_g) dw_g   (skipped groups keep accumulating)

``p`` is the round-robin B-of-K participation mask; every T-th step is a
dense sync (everything sent, every group participating). With B = K,
rho = 1, gamma = 1 the update is exactly the data-parallel mean gradient.

The filter is the :mod:`repro_torch.core.compress` registry entry
(``ExchangeConfig.compressor``; ``topk_threshold``'s two-round histogram
threshold by default), so bytes are counted one way on both paths. Its
threshold (``compress.threshold_for_topk``) is the kernel
``csrc/exchange_threshold.cu`` on the card. Where the filter is
``topk_threshold``, :func:`exchange_sequential` runs the split around it as
two passes a leaf and group (``ops.exchange_apply_add``, the residual add in
place, and ``ops.exchange_apply_split``, the mask, the accumulator, the new
residual and the group's accounting): on the card the two launches of
``csrc/exchange_apply.cu``, on the CPU their plain versions, which are the
PyTorch sequence the other filters still run (``topk_exact``, ``topk_q8``,
dense), and which the JAX package runs in jnp (the Table-I top-k kernel
computes another selection).

Leaves are visited in the JAX package's order (dict keys sorted). The step
is a tensor on the device, and the dense-step and participation decisions
are made there with ``torch.where``, so on the card the exchange waits for
the stream nowhere. The threshold's plain version, which the CPU runs,
calls ``torch.bincount`` in each histogram round; on CUDA that would read
its input's minimum and maximum back to the host, and the round's copy of
one constant from pageable memory would wait too: three syncs per round,
two rounds per leaf and group.
:func:`exchange_sequential` writes the new residuals into the state's
tensors (K float32 copies of the model; a second set would not fit at full
width) and returns the state holding them; :func:`exchange` returns new
tensors, as JAX does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core import compress as compress_lib
from repro_torch.kernels import ops
from repro_torch.models.param import tree_flatten, tree_map
from repro_torch.tracing import span

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    num_groups: int = 16  # K: worker groups (= batch slices)
    group_size: int = 8  # B: participating groups per step
    sync_period: int = 20  # T: dense full-sync every T steps
    rho: float = 1.0 / 256.0  # fraction of coordinates exchanged
    gamma: float = 0.9  # server step scale
    refine: bool = True  # second histogram round
    min_leaf_size: int = 1024  # leaves smaller than this are sent densely
    compressor: str = "topk_threshold"  # repro_torch.core.compress registry entry

    def __post_init__(self):
        if not 1 <= self.group_size <= self.num_groups:
            raise ValueError(f"need 1 <= group_size <= num_groups, got "
                             f"{self.group_size} of {self.num_groups}")
        compress_lib.get_compressor(self.compressor)  # early validation


class ExchangeState(NamedTuple):
    residual: PyTree  # each leaf (G, *param_shape), float32


def dense_config(num_groups: int) -> ExchangeConfig:
    """The synchronous dense baseline (== data-parallel mean) as a config."""
    return ExchangeConfig(num_groups=num_groups, group_size=num_groups,
                          sync_period=1, rho=1.0, gamma=1.0)


def init_state(cfg: ExchangeConfig, params: PyTree) -> ExchangeState:
    return ExchangeState(residual=tree_map(
        lambda p: torch.zeros((cfg.num_groups, *p.shape), dtype=torch.float32,
                              device=p.device), params))


_DENSE = compress_lib.Dense()


def participation(cfg: ExchangeConfig, step: torch.Tensor) -> torch.Tensor:
    """Rotating B-of-K mask (round-robin schedule), (G,) float32 in {0,1}."""
    G, B = cfg.num_groups, cfg.group_size
    g = torch.arange(G, device=step.device)
    return (torch.remainder(g - step * B, G) < B).to(torch.float32)


def _round_masks(cfg: ExchangeConfig, step: torch.Tensor):
    """(dense_step bool 0-dim, p (G,) float32, denom) of the round at ``step``."""
    dense_step = torch.remainder(step, cfg.sync_period) == cfg.sync_period - 1
    ones = torch.ones(cfg.num_groups, dtype=torch.float32, device=step.device)
    p = torch.where(dense_step, ones, participation(cfg, step))
    return dense_step, p, torch.clamp(torch.sum(p), min=1.0)


def exchange_sequential(cfg: ExchangeConfig, grad_fn: Callable, params: PyTree,
                        grouped_batch: dict, state: ExchangeState, step: torch.Tensor):
    """One ACPD round, one group at a time: the memory-scalable form.

    ``grad_fn(params, batch_g)`` returns the gradient tree of group g's
    batch; ``grouped_batch`` has a leading axis G on every leaf. Only one
    group's gradient and the float32 accumulator are alive at once, whatever
    K. Returns ``(update, state, metrics)`` with the semantics of
    :func:`exchange` (tested for equivalence); the residuals are updated in
    place.
    """
    G = cfg.num_groups
    comp = compress_lib.for_exchange(cfg)
    fused = isinstance(comp, compress_lib.TopKThreshold)
    payload = dict(dense_bytes=(_DENSE.entry_bytes, _DENSE.message_overhead),
                   sparse_bytes=(comp.entry_bytes, comp.message_overhead))
    dense_step, p, denom = _round_masks(cfg, step)
    res_leaves, unflatten = tree_flatten(state.residual)
    dev = step.device

    def leaf_filter(dw):
        if cfg.rho >= 1.0 or dw.numel() < cfg.min_leaf_size:
            return dw, None, True
        sent, mask = comp.compress_grouped(dw[None])
        sent = torch.where(dense_step, dw, sent[0])
        mask = torch.where(dense_step, True, mask[0])
        return sent, mask, False

    acc = [torch.zeros(r.shape[1:], dtype=torch.float32, device=dev) for r in res_leaves]
    sent_total = torch.zeros((), dtype=torch.float32, device=dev)
    bytes_total = torch.zeros((), dtype=torch.float32, device=dev)
    for g in range(G):
        with span("exchange.group"):
            batch_g = {k: v[g] for k, v in grouped_batch.items()}
            grads, _ = tree_flatten(grad_fn(params, batch_g))
            pg = p[g]
            sent_count = torch.zeros((), dtype=torch.float32, device=dev)
            byte_count = torch.zeros((), dtype=torch.float32, device=dev)
            for i, res in enumerate(res_leaves):
                with span("exchange.leaf"):
                    if fused:  # res[g] holds dw, then the new residual
                        dw = res[g]
                        ops.exchange_apply_add(dw, grads[i].contiguous())
                        grads[i] = None
                        thresh = None  # a leaf under min_leaf_size is sent densely
                        if dw.numel() >= cfg.min_leaf_size:
                            thresh = compress_lib.threshold_for_topk(
                                dw, compress_lib.kept_target(comp.rho, dw.numel()), comp.refine)
                        ops.exchange_apply_split(dw, acc[i], pg, dense_step, thresh,
                                                 sent_count, byte_count, **payload)
                        continue
                    dw = res[g] + grads[i].to(torch.float32)
                    grads[i] = None  # free this group's gradient leaf as it is used
                    sent, mask, always_dense = leaf_filter(dw)
                    acc[i] += pg * sent
                    res[g] = torch.where(pg > 0, dw - sent, dw)
                    if always_dense:  # host numbers: no copy to the device
                        kept, nbytes = dw.numel(), float(_DENSE.payload_bytes(dw.numel()))
                    else:
                        kept = torch.sum(mask)
                        nbytes = torch.where(dense_step, _DENSE.payload_bytes(kept),
                                             comp.payload_bytes(kept)).to(torch.float32)
                    del dw, sent, mask
                    sent_count = sent_count + pg * kept
                    byte_count = byte_count + pg * nbytes
            sent_total = sent_total + sent_count
            bytes_total = bytes_total + byte_count

    # In place: the accumulators become the update, so the step holds no
    # second float32 copy of the model.
    update = unflatten([a.mul_(cfg.gamma).div_(denom) for a in acc])
    total = float(sum(r.numel() for r in res_leaves))
    metrics = {
        "exchange/sent_fraction": sent_total / max(total, 1.0),
        "exchange/bytes_step": bytes_total,
        "exchange/participating": torch.sum(p),
        "exchange/dense_step": dense_step.to(torch.float32),
    }
    return update, state, metrics


def exchange(cfg: ExchangeConfig, grads_per_group: PyTree, state: ExchangeState,
             step: torch.Tensor) -> tuple[PyTree, ExchangeState, dict]:
    """One ACPD round over the group axis.

    ``grads_per_group``: a tree with a leading axis G on every leaf. Returns
    (update tree without the G axis, new state, metrics).
    """
    G, B = cfg.num_groups, cfg.group_size
    comp = compress_lib.for_exchange(cfg)
    dense_step, p, denom = _round_masks(cfg, step)
    always_dense = cfg.rho >= 1.0 and B == G
    dev = step.device
    sent_count = torch.zeros((), dtype=torch.float32, device=dev)
    total_count = 0.0
    byte_count = torch.zeros((), dtype=torch.float32, device=dev)
    res_leaves, unflatten = tree_flatten(state.residual)
    g_leaves, _ = tree_flatten(grads_per_group)
    updates, new_res = [], []
    for res, g in zip(res_leaves, g_leaves):
        dw = res + g.to(torch.float32)  # (G, *shape)
        n = math.prod(dw.shape[1:])
        if cfg.rho >= 1.0 or n < cfg.min_leaf_size:
            sent, mask = dw, torch.ones(dw.shape, dtype=torch.bool, device=dev)
            leaf_dense = torch.ones((), dtype=torch.bool, device=dev)
        else:
            sent_sparse, mask_sparse = comp.compress_grouped(dw)
            sent = torch.where(dense_step, dw, sent_sparse)
            mask = torch.where(dense_step, True, mask_sparse)
            leaf_dense = dense_step
        pb = p.reshape((G,) + (1,) * (dw.dim() - 1))
        updates.append(cfg.gamma * torch.sum(pb * sent, dim=0) / denom)
        new_res.append(torch.where(pb > 0, dw - sent, dw))
        kept = torch.sum(torch.where(pb > 0, mask, False), dim=tuple(range(1, dw.dim())))
        sent_count = sent_count + torch.sum(kept)
        byte_count = byte_count + torch.sum(p * torch.where(
            leaf_dense, _DENSE.payload_bytes(kept), comp.payload_bytes(kept)).to(torch.float32))
        total_count += float(dw.numel())
    residual_norm = torch.zeros((), dtype=torch.float32, device=dev)
    for r in new_res:
        residual_norm = residual_norm + torch.sum(torch.square(r))
    metrics = {
        "exchange/sent_fraction": sent_count / max(total_count, 1.0),
        "exchange/bytes_step": byte_count,
        "exchange/participating": torch.sum(p),
        "exchange/dense_step": dense_step.to(torch.float32),
        "exchange/residual_norm": torch.sqrt(residual_norm),
    }
    if always_dense:
        metrics["exchange/sent_fraction"] = torch.ones((), dtype=torch.float32, device=dev)
    return unflatten(updates), ExchangeState(residual=unflatten(new_res)), metrics
