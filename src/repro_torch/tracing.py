"""Spans at the port's layer boundaries, recorded only under ``torch.profiler``.

``span(name)`` is a context manager placed in host code at the boundary of a
layer (``session.setup``, ``session.run``, ``engine.round`` and its
``engine.server`` and ``engine.launch``, ``engine.eval``,
``solver.norms_sq``, ``executor.capture``, ``executor.replay``,
``train.step``, ``grads``, ``exchange``, ``exchange.group``,
``exchange.leaf``, ``exchange.threshold``, ``exchange.histogram`` (the
threshold's plain rounds), ``optimizer.update``, HuBERT's
``audio.frontend``, ``audio.posconv`` and ``audio.head`` in
``models/audio.py``, and the held-experts layer's ``moe.route``,
``moe.dispatch``, ``moe.experts`` and ``moe.combine`` in ``models/moe.py``)
and around each call that makes the host wait for the stream
(``sync.<site>``: a read to the host, a copy from pageable host memory, the
syncs inside ``torch.bincount``).

* **Off**, while no profiler records, it reads one flag and returns a shared
  null context: nothing is allocated and no profiler range is opened.
* **On**, it opens the profiler range ``repro_torch.<name>`` (torch's
  ``_RecordFunctionFast``, ``record_function``'s fast form, at a tenth of its
  host cost on a CPU host), so that the span lies in the profiler's
  trace beside the device's work, on the same clock, and keeps a record in
  memory: name, id, parent and root id (the spans of one run or step share
  their root's id), host start and end (``time.perf_counter_ns``) and, for a
  ``timed`` span on the card, a pair of CUDA events on the current stream.
  Only the spans whose device time is read are timed: under the profiler an
  event costs ~24 us of host time on the H100's host, and with events and
  ``record_function`` on every span a traced ACPD run took a tenth longer.
  A ``sync.*`` span is never timed: it counts the syncs its call makes (one,
  or ``syncs``: two for ``torch.bincount`` on CUDA, which reads its input's
  minimum and maximum) and its host time is the wait.
* While the current stream captures a CUDA graph a span is the null context
  too: nothing of it may become part of the graph.

Open spans stack per thread (the service runs sessions from threads), and no
span stays open across a ``yield``. The store holds the last traced window
only: the first span opened while a profiler records, after spans were last
seen with it off, starts a new one. It keeps at most ``CAP`` records and
counts what it drops past that. :func:`summary` reads it, with how much
``ops.LAUNCHES``, ``executor.STATS`` and ``blocks.STATS`` grew from the
window's first span to its last root span's end. There is no exporter and
no switch: an operator runs the program under ``torch.profiler`` and reads
its trace, or :func:`summary`.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import threading
import time

import torch
import torch.autograd.profiler as _profiler

CAP = 1 << 20
PREFIX = "repro_torch."
# The program's counters whose growth over a window summary() reports: the
# module that holds each and its name there. Read from sys.modules, so that
# a window that never imported the module reports no growth.
COUNTERS = {"launches": ("repro_torch.kernels.ops", "LAUNCHES"),
            "executor": ("repro_torch.core.executor", "STATS"),
            "blocks": ("repro_torch.models.blocks", "STATS"),
            "moe": ("repro_torch.models.moe", "STATS")}


_NULL = contextlib.nullcontext()  # reusable: every span that records nothing


def _counters() -> dict:
    """Each counter's values; a count kept on the device is copied there (a
    launch, no sync), and only :func:`summary` reads it."""
    out = {}
    for key, (module, attr) in COUNTERS.items():
        mod = sys.modules.get(module)
        out[key] = {c: v.clone() if isinstance(v, torch.Tensor) else v
                    for c, v in getattr(mod, attr, {}).items()}
    return out


class _Window:
    """The records of one traced window."""

    def __init__(self):
        self.records: list[_Span] = []
        self.dropped = 0
        self.first = _counters()
        self.last = None  # the counters at the last root span's end
        self.lock = threading.Lock()
        self.cached = None  # (records, dropped) -> summary


class _Stack(threading.local):
    """This thread's open spans, innermost last."""

    def __init__(self):
        self.spans: list[_Span] = []


_ids = itertools.count(1)
_local = _Stack()
_window: _Window | None = None  # none yet
_fresh = True  # spans were last seen with the profiler off
_fresh_lock = threading.Lock()


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def span(name: str, *, timed: bool = False, syncs: int = 1):
    """The span ``name`` around a ``with`` block (see the module docstring):
    ``timed`` records its device time on the card; ``syncs`` is how many
    times the call of a ``sync.*`` span waits."""
    global _fresh, _window
    if not _profiler._is_profiler_enabled:
        _fresh = True
        return _NULL
    if _capturing():
        return _NULL
    if _fresh:
        with _fresh_lock:
            if _fresh:
                _window = _Window()
                _fresh = False
    return _Span(name, _window, timed, syncs)


class _Span:
    __slots__ = ("name", "window", "timed", "syncs", "id", "parent", "root", "t0", "t1",
                 "child_ns", "wait_ns", "ev0", "ev1", "rf")

    def __init__(self, name: str, window: _Window, timed: bool, syncs: int):
        self.name = name
        self.window = window
        self.timed = timed
        self.syncs = syncs
        self.child_ns = 0
        self.wait_ns = 0  # host time of the sync.* spans inside it
        self.ev0 = self.ev1 = None

    def __enter__(self):
        stack = _local.spans
        self.id = next(_ids)
        parent = self.parent = stack[-1] if stack else None
        self.root = parent.root if parent is not None else self.id
        self.rf = torch._C._profiler._RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        if self.timed and torch.cuda.is_initialized():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        stack.append(self)
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        self.rf.__exit__(None, None, None)
        self.rf = None
        _local.spans.pop()
        parent, w = self.parent, self.window
        if parent is not None:
            parent.child_ns += t1 - self.t0
            parent.wait_ns += t1 - self.t0 if self.name.startswith("sync.") else self.wait_ns
        if len(w.records) < CAP:
            w.records.append(self)  # atomic; the cap may be passed by a racing thread's few
        else:
            with w.lock:
                w.dropped += 1
        if parent is None:
            counters = _counters()
            with w.lock:
                w.last = counters


def _growth(first: dict, last: dict | None) -> dict:
    if last is None:
        return {k: {} for k in first}
    return {k: {c: _whole(v - first[k].get(c, 0)) for c, v in last[k].items()} for k in last}


def _whole(v):
    return int(v) if isinstance(v, torch.Tensor) else v


def summary() -> dict:
    """The last traced window: per span name ``count``, ``host_ms``,
    ``self_host_ms`` (less its child spans' host time), ``wait_ms`` (the
    host time of the ``sync.*`` spans inside it, at any depth) and
    ``device_ms`` (between its CUDA events; None off the card and for spans
    not timed), and for ``sync.*`` names ``syncs``, the syncs their calls
    made, under ``"spans"``; the growth of ``ops.LAUNCHES`` (``"launches"``),
    ``executor.STATS`` (``"executor"``) and ``models.blocks.STATS``
    (``"blocks"``: stacked leaves unbound) and ``models.moe.STATS``
    (``"moe"``: the held-experts layer's calls, held rows and the sum of each
    call's largest held expert's rows) over the window; ``"dropped"``, the
    records past ``CAP``. Waits for the card's work where spans recorded
    events."""
    w = _window
    if w is None:
        return {"spans": {}, "dropped": 0, **{k: {} for k in COUNTERS}}
    with w.lock:
        records, dropped, last = list(w.records), w.dropped, w.last
    key = (len(records), dropped)
    if w.cached is not None and w.cached[0] == key:
        return w.cached[1]
    if any(r.ev1 is not None for r in records):
        torch.cuda.synchronize()
    spans: dict[str, dict] = {}
    for r in records:
        s = spans.setdefault(r.name, {"count": 0, "host_ms": 0.0, "self_host_ms": 0.0,
                                      "wait_ms": 0.0, "device_ms": None})
        s["count"] += 1
        s["wait_ms"] += r.wait_ns / 1e6
        if r.name.startswith("sync."):
            s["syncs"] = s.get("syncs", 0) + r.syncs
        s["host_ms"] += (r.t1 - r.t0) / 1e6
        s["self_host_ms"] += (r.t1 - r.t0 - r.child_ns) / 1e6
        if r.ev1 is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.ev0.elapsed_time(r.ev1)
    out = {"spans": spans, "dropped": dropped, **_growth(w.first, last)}
    w.cached = (key, out)
    return out
