"""Reading the traced window: device operations, busy time, the breakdown.

The ``--trace 1`` run wraps the first seconds of its window in
``torch.profiler`` (CUPTI on the card). Device operations are every event
on a CUDA device (kernels, copies, fills) but the spans' shadows there;
busy time is the length of their
union, so overlapping streams count once. An idle gap between two device
operations is charged to what the host was doing when it began: the
innermost host operation open at that instant, under the innermost span
that the benchmark's drivers opened (``perfbench.*``).
"""

from __future__ import annotations

import bisect
import collections

import torch

TOP = 10


def start(on_card: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def device_and_host_ops(prof) -> tuple[list, list]:
    """``(device ops, host ops)``: ``(name, start_ns, duration_ns)`` each,
    sorted by start."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # A span also shows on the device's timeline; it is no operation.
            if not (e.is_user_annotation() or e.name().startswith("perfbench.")):
                dev.append(item)
        elif e.device_type() == torch.autograd.DeviceType.CPU:
            host.append(item)
    dev.sort(key=lambda t: t[1])
    host.sort(key=lambda t: t[1])
    return dev, host


def _merged(ops) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for _, s, d in ops:
        e = s + d
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(ops) -> float:
    return sum(e - s for s, e in _merged(ops)) / 1e9


def _innermost(events, starts, t: int, lookback: int):
    """The shortest of the ``lookback`` events that start last before ``t``
    and are still open at ``t``: ``(name, duration)`` or ``(None, None)``."""
    hi = bisect.bisect_right(starts, t)
    name_in, d_in = None, None
    for name, s, d in events[max(0, hi - lookback):hi]:
        if s <= t < s + d and (d_in is None or d < d_in):
            name_in, d_in = name, d
    return name_in, d_in


def _host_label(spans, span_starts, ops, starts, t: int) -> str:
    """Innermost span and innermost host operation open at ``t``."""
    span, _ = _innermost(spans, span_starts, t, 64)
    op, _ = _innermost(ops, starts, t, 256)
    label = op or "host (no operation traced)"
    return f"{span}/{label}" if span else label


def breakdown(dev, host) -> dict:
    """The device operations that took most time and the longest idle gaps
    summed by what the host was doing, at most ``TOP`` of each."""
    per_op: dict[str, float] = collections.defaultdict(float)
    for name, _, d in dev:
        per_op[name[:160]] += d / 1e9
    gaps: dict[str, float] = collections.defaultdict(float)
    spans = [h for h in host if h[0].startswith("perfbench.")]
    ops = [h for h in host if not h[0].startswith("perfbench.")]
    starts = [s for _, s, _ in ops]
    span_starts = [s for _, s, _ in spans]
    merged = _merged(dev)
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        if s1 > e0:
            gaps[_host_label(spans, span_starts, ops, starts, e0)] += (s1 - e0) / 1e9
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in idle]}
