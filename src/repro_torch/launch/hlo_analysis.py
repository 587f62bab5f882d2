"""Roofline terms of a step: FLOPs counted on ``meta`` tensors, H100 peaks.

PyTorch counterpart of ``repro.launch.hlo_analysis``, kept under that name
so that a reader finds it. The JAX package reads its terms from a compiled
XLA executable: FLOPs from ``cost_analysis`` and a loop-aware walk of the
optimized HLO (``hlo_program.py``), the collective schedule from the HLO
text (``parse_collectives``), and the bf16-to-f32 weight upcasts that
XLA:CPU hoists out of scans (``cpu_upcast_bytes``). PyTorch has no HLO, so
those three have no counterpart here. What replaces them:

* FLOPs: :func:`count_step_flops` runs the step itself at full width on
  ``meta`` tensors (shapes only, nothing allocated or computed) under
  ``torch.utils.flop_counter.FlopCounterMode``. Python runs every loop of
  the step (the remat recompute, the flash backward's blocks, the SSD
  chunks, the chunked loss), so the count is loop-aware by construction,
  which is what the JAX package's HLO walk exists to recover. The stack's
  periods are the one loop it does not run in full: every period runs the
  same products on the same shapes, so the step is counted without the
  stack's periods and with one, and extended by the difference (exact: the
  counts are integers), as the HLO walk multiplies a scan body by its trip
  count.
  Like that walk it counts matrix products only (elementwise work is not
  counted).
  The flash forward is a CUDA kernel launched through ``ctypes``, which the
  counter cannot see: its FLOPs are added from its shapes by
  :func:`flash_flops`, the (query, key) pairs its mask keeps, the formula
  ``chip_smoke.py`` times the kernel against.
* Bytes: the analytic model of ``launch/analytic.py``, as in the JAX
  package's dry-run.
* Collectives: the ring on-wire byte rules are kept as pure functions
  (:func:`wire_bytes`); on one card every group has one member and they
  give 0. The port runs on one card and has no collective schedule to
  apply them to on a larger mesh, so there the collective term is None.

Hardware constants are one H100 SXM's (NVIDIA's data sheet, dense, at the
700 W limit) in place of the JAX package's TPU v5e constants.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import InputShape, input_specs
from repro_torch.kernels import ops
from repro_torch.models import decode_step, model_spec, prefill, train_loss
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_map

PEAK_BF16 = 989e12  # FLOP/s, tensor cores
PEAK_F32 = 67e12  # FLOP/s outside the tensor cores
HBM_BW = 3.35e12  # bytes/s


def wire_bytes(kind: str, nbytes: float, group: int) -> float:
    """Ring-algorithm bytes one device sends for one collective over a group
    of ``group`` devices, ``nbytes`` its result's size per device (the JAX
    package's rules): all-reduce 2 b (n-1)/n; all-gather b (n-1)/n;
    reduce-scatter b (n-1) (b is the 1/n result); all-to-all b (n-1)/n;
    collective-permute b (one hop)."""
    n = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * nbytes * (n - 1) / n
    if kind == "collective-permute":
        return float(nbytes) if n > 1 else 0.0
    if kind in ("all-gather", "all-to-all"):
        return nbytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(nbytes * (n - 1))
    raise ValueError(f"unknown collective {kind!r}")


def flash_flops(q_shape: tuple[int, ...], causal: bool, window: int | None) -> int:
    """FLOPs of one flash forward on q (B, S, KV, G, hd): q.k and p.v over the
    (query, key) pairs that the mask keeps, 4 B KV G hd per pair."""
    B, S, KV, G, hd = q_shape
    W = S if window is None else min(window, S)
    if causal:  # row i keeps min(i + 1, W) keys
        pairs = W * (W + 1) // 2 + (S - W) * W
    else:  # row i keeps keys max(0, i - W + 1) .. S - 1
        pairs = S * S - (S - W) * (S - W + 1) // 2
    return 4 * B * KV * G * hd * pairs


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    wire_bytes_per_device: float | None
    compute_s: float
    memory_s: float
    collective_s: float | None
    dominant: str
    memory_stats: dict[str, int]
    collectives: dict[str, Any]
    model_flops: float | None = None
    useful_ratio: float | None = None

    def as_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``cfg`` as ``meta`` tensors."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                    model_spec(cfg))


def _counted(fn) -> tuple[int, int, int]:
    """(matrix-product FLOPs the counter saw, flash forward FLOPs from the
    shapes, flash forward calls) of ``fn()`` on meta tensors."""
    with ops.recording_meta_calls() as calls, FlopCounterMode(display=False) as counter:
        fn()
    flash = sum(flash_flops(c["q_shape"], c["causal"], c["window"]) for c in calls)
    return int(counter.get_total_flops()), flash, len(calls)


def _count_parts(cfg: ModelConfig, shape: InputShape, groups: int | None,
                 exploit_window: bool) -> tuple[int, int, int]:
    """``_counted`` of the whole step of ``cfg`` (see ``count_step_flops``)."""
    from repro_torch.launch.steps import value_and_grad

    params = abstract_params(cfg)
    specs = input_specs(cfg, shape)
    parts: list[tuple[int, tuple[int, int, int]]] = []  # (multiplicity, counted)
    if shape.kind == "train":
        batch = specs["batch"]

        def loss_fn(p, b):
            return train_loss(p, b, cfg, exploit_window=exploit_window)

        if groups is None:
            parts.append((1, _counted(lambda: value_and_grad(loss_fn, params, batch))))
        else:
            group = {k: v[: v.shape[0] // groups] for k, v in batch.items()}
            with torch.no_grad():
                parts.append((1, _counted(lambda: loss_fn(params, batch))))
            parts.append((groups, _counted(lambda: value_and_grad(loss_fn, params, group))))
    elif shape.kind == "prefill":
        parts.append((1, _counted(lambda: prefill(params, specs["batch"], cfg,
                                                  max_seq=shape.seq_len,
                                                  exploit_window=exploit_window))))
    else:
        parts.append((1, _counted(lambda: decode_step(params, specs["token"], specs["caches"],
                                                      specs["cache_len"], cfg))))
    return tuple(sum(m * c[i] for m, c in parts) for i in range(3))


def count_step_flops(cfg: ModelConfig, shape: InputShape, *, groups: int | None = None,
                     exploit_window: bool = True) -> dict[str, float]:
    """FLOPs of one step of ``shape.kind`` at ``shape``'s global batch, on
    ``meta`` tensors: ``flops`` (all), ``matmul_flops`` (the counter's),
    ``flash_flops`` (the kernel's, from its shapes), ``flash_calls``,
    ``seconds`` (the count's host time).

    train: with ``groups`` None the plain step, the loss and its gradient
    over the batch; with ``groups`` K the ACPD step of ``launch/steps.py``,
    the monitored forward over the batch plus K group gradients, each over
    1/K of it (one group's is counted and taken K times: they have the same
    shapes). The exchange's filter and the optimizer are elementwise and add
    nothing counted. prefill: ``models.prefill`` to a cache of ``seq_len``
    slots. decode: one ``decode_step`` at a full cache. A stack of more than
    one period is counted at none and one (see the module docstring).
    """
    t0 = time.perf_counter()
    period = len(cfg.layout)
    full, rem = divmod(cfg.num_layers, period)
    if full <= 1:
        counts = _count_parts(cfg, shape, groups, exploit_window)
    else:
        none, one = (_count_parts(dataclasses.replace(cfg, num_layers=n * period + rem),
                                  shape, groups, exploit_window) for n in (0, 1))
        counts = tuple(a + full * (b - a) for a, b in zip(none, one))
    matmul, flash, calls = counts
    return dict(flops=float(matmul + flash), matmul_flops=float(matmul),
                flash_flops=float(flash), flash_calls=calls,
                seconds=time.perf_counter() - t0)
