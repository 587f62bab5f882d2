"""The benchmark's general part: find a cell's files, time its window, print its line.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds everything by name, so that a later change adds a cell, a
configuration or a metric by adding files and entries, and edits none:

* ``configs[].file``: the configuration as it is run (JSON);
* ``perfbench/traffic/<traffic>.json``: the traffic mix; its ``driver``
  names the module ``perfbench/drivers/<driver>.py`` that runs it, and an
  optional ``window_multiple`` makes the window hold a multiple of that
  many units;
* ``perfbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from;
* ``perfbench/metrics/<metric>.py``: a per-layer metric's reader,
  ``read(ctx) -> float | None`` over a :class:`TraceContext`.

A driver module has ``setup(config, traffic, seed, device, limits) -> work``,
where ``work`` has ``unit()`` (one run or one step, closed loop, ended on
the host), ``end_to_end(window_s, unit_s) -> {metric: value}``,
``trace_begin()`` / ``trace_end() -> {span: [ms, ...]}`` (spans of the
traced units, taken only in the ``--trace 1`` run), ``free()`` (drop the
program's state once the window has closed) and ``check() -> (attempted,
failed, {number: (value, limit)})``. ``correct`` is true when every number
lies at or below its limit and no answer failed.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# Top-level module names that the port's process must not hold: JAX and the
# JAX package. Names are compared whole, so ``repro_torch`` is not ``repro``.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
# Build and compile caches, at fixed paths inside the checkout.
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCHINDUCTOR_CACHE_DIR": "inductor",
              "TORCH_EXTENSIONS_DIR": "extensions"}


def load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def load_bench() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def peaks() -> dict:
    return load_json(HERE / "peaks.json")


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(bench: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in e2e_names]
    return Cell(name=name, chips=int(w["chips"]), config=load_json(ROOT / conf["file"]),
                traffic=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(HERE / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def derive_seed(seed: int, *salt: int) -> int:
    """A seed below 2**63 drawn from ``seed`` and ``salt`` (any whole numbers)."""
    words = [int(seed) & (2**64 - 1), int(seed) >> 64, *(int(s) for s in salt)]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> 1)


def set_cache_dirs() -> None:
    """Point every compile cache at a fixed directory in the checkout (the
    kernels' ``.so`` files already live in ``src/repro_torch/_build``)."""
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = str(ROOT / ".perfbench_cache" / sub)
    # transformers, if anything imports it, must not load JAX by itself.
    os.environ.setdefault("USE_FLAX", "0")


def import_program() -> None:
    """Make ``repro_torch`` importable from the checkout's ``src``."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_loaded() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def load_reader(name: str):
    """The ``read`` function of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    module = "perfbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader reads: the traced window and its work."""

    config: dict
    traffic: dict
    peaks: dict
    units: int  # whole runs or steps inside the traced window
    window_s: float  # host seconds of the traced window
    busy_s: float  # device seconds with an operation running (union of intervals)
    kernels: list  # (name, start_ns, duration_ns) of every device operation
    spans: dict  # span name -> [ms of each traced unit's span, ...]

    def kernel_seconds(self, *needles: str) -> float:
        """Summed device seconds of the operations whose name holds a needle."""
        return sum(d for n, _, d in self.kernels if any(s in n for s in needles)) / 1e9


def _units_until(work, start: float, seconds: float, unit_s: list, multiple: int) -> None:
    """Whole units, closed loop, until ``seconds`` have passed since ``start``
    and ``unit_s`` holds a multiple of ``multiple`` units."""
    while time.perf_counter() - start < seconds or len(unit_s) % multiple:
        a = time.perf_counter()
        work.unit()
        unit_s.append(time.perf_counter() - a)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float | None = None) -> dict:
    """Set up, measure, check; returns the result object (not yet printed)."""
    import torch

    from perfbench import devtrace as trace_lib

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    driver = importlib.import_module(f"perfbench.drivers.{cell.traffic['driver']}")
    work = driver.setup(cell.config, cell.traffic, seed, dev, cell.limits)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    # Set-up's objects leave the collector's young generations, so that its
    # passes in the window walk only what the window makes.
    gc.collect()
    gc.freeze()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    trace_seconds = min(float(cell.traffic.get("trace_seconds", seconds)), seconds)
    # A traffic whose work repeats in periods (an exchange's dense sync every
    # T-th step) ends the window, and its traced part, on whole periods.
    multiple = int(cell.traffic.get("window_multiple", 1))
    unit_s: list[float] = []
    traced = None
    t0 = time.perf_counter()
    if trace:
        prof = trace_lib.start(on_card)
        work.trace_begin()
        tt0 = time.perf_counter()
        _units_until(work, tt0, trace_seconds, unit_s, multiple)
        if on_card:
            torch.cuda.synchronize()
        traced_window = time.perf_counter() - tt0
        spans = work.trace_end()
        prof.stop()
        traced = (prof, len(unit_s), traced_window, spans)
    _units_until(work, t0, seconds, unit_s, multiple)
    if on_card:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    peak = int(torch.cuda.max_memory_allocated()) if on_card else 0

    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
                   "count": cell.chips if on_card else 1,
                   "memory_peak_bytes": peak}
    metrics: dict = {}
    breakdown = None
    if trace:
        prof, units, traced_window, spans = traced
        kernels, host_ops = trace_lib.device_and_host_ops(prof)
        busy = trace_lib.busy_seconds(kernels)
        ctx = TraceContext(config=cell.config, traffic=cell.traffic, peaks=peaks(),
                           units=units, window_s=traced_window, busy_s=busy,
                           kernels=kernels, spans=spans)
        for m in cell.per_layer:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        device_info["busy_s"] = busy
        device_info["window_s"] = traced_window
        breakdown = trace_lib.breakdown(kernels, host_ops)
        del prof
    else:
        values = work.end_to_end(window_s, unit_s)
        values["setup_s"] = setup_s
        values["peak_gb"] = peak / 1e9
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    work.free()
    attempted, failed, numbers = work.check()
    correct = failed == 0 and all(v <= lim for v, lim in numbers.values())
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["units"] = len(unit_s)
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return out


def main(argv: list[str] | None = None) -> int:
    import argparse

    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description="One cell of the port's benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    cell = find_cell(load_bench(), args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 3
    import_program()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    loaded = forbidden_loaded()
    if loaded:
        print(f"perfbench: the process holds {loaded} after the window; the port's "
              f"benchmark may load neither JAX nor the JAX package", file=sys.stderr)
        return 4
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
