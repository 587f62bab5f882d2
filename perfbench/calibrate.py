"""Readings that a cell's limits are set from, at the cell's own size.

    python3 perfbench/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 \
        [--faults] [--out PATH]

For each of ``--seeds`` seeds, the program as the window runs it against
the plain reference (a solver run: one run of the cell's traffic; a
training cell: the cell's compared steps from fresh weights); for each of
``--control-seeds`` seeds, the control (the reference computed one
precision lower: TF32 for the solver cells' float32, float8 for the
training cells' bfloat16) against the reference; with ``--faults``, for a
training cell, the program with a fault planted underneath on the control
seeds. Each reading is one JSON line on standard output: the cell, the
kind (``program``, ``control`` or a fault's name), the seed and every
number the check compares. The lower reading of a number is the largest
over the program's seeds; its upper the smallest over the control's (or a
fault's) seeds. The benchmark's own runs never run this.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import sys
import time

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

from perfbench import harness  # noqa: E402


def emit(fh, **fields) -> None:
    line = json.dumps(fields)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")
        fh.flush()


def solver_readings(cell, seeds, control_seeds, device, fh) -> None:
    import torch

    from perfbench.drivers import solver_runs
    from perfbench.reference import solver as reference

    base = harness.derive_seed((seeds or control_seeds)[0], 99)
    work = solver_runs.SolverWork(cell.config, cell.traffic, base, device, cell.limits)
    for s in seeds:
        t0 = time.perf_counter()
        got = solver_runs.as_plain(work.run_once(s))
        want = reference.run(work.X, work.y, cell.config, cell.traffic, s)
        emit(fh, cell=cell.name, kind="program", seed=s, seconds=time.perf_counter() - t0,
             executor=work.executor, **solver_runs.compare(got, want))
    work.free()
    for s in control_seeds:
        want = reference.run(work.X, work.y, cell.config, cell.traffic, s)
        got = reference.run(work.X, work.y, cell.config, cell.traffic, s, precision="tf32")
        emit(fh, cell=cell.name, kind="control", seed=s, **solver_runs.compare(got, want))
    del work
    torch.cuda.empty_cache() if device.type == "cuda" else None


@contextlib.contextmanager
def planted(fault: str, exchange: bool):
    """A fault planted in the program underneath the step."""
    import torch

    from repro_torch.launch import steps

    saved = {}

    def patch(name, fn):
        saved[name] = getattr(steps, name)
        setattr(steps, name, fn)

    if fault == "state_unchanged":
        def apply_update(cfg, params, grads, state):
            return params, state, {"lr": torch.zeros(()), "grad_norm": torch.zeros(())}
        patch("apply_update", apply_update)
    elif fault == "half_batch":
        orig = steps.train_loss

        def train_loss(params, batch, cfg, **kw):
            half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
            return orig(params, half, cfg, **kw)
        patch("train_loss", train_loss)
    elif fault == "exchange_left_out":
        ex_lib = steps.exch_lib

        class _Plain:
            def __getattr__(self, name):
                return getattr(ex_lib, name)

            @staticmethod
            def exchange_sequential(cfg, grad_fn, params, grouped, state, step):
                whole = {k: v.reshape(-1, *v.shape[2:]) for k, v in grouped.items()}
                grads = grad_fn(params, whole)
                return grads, state, {"exchange/bytes_step": torch.zeros(())}
        patch("exch_lib", _Plain())
    else:
        raise ValueError(fault)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(steps, name, fn)


def train_readings(cell, seeds, control_seeds, faults, device, fh) -> None:
    import gc

    import torch

    from perfbench.drivers import train_steps
    from perfbench.reference import decoder as reference

    steps_n = cell.traffic["check_steps"]

    def program(s, fault=None):
        ctx = (planted(fault, cell.traffic.get("exchange") is not None) if fault
               else contextlib.nullcontext())
        with ctx:
            work = train_steps.TrainWork(cell.config, cell.traffic, s, device, cell.limits)
        read = work.read
        work.free()
        del work
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
        return read

    def emit_compared(kind, s, got, want, j, **extra):
        by_leaf = {p: d / r if r else d for p, d, r in
                   zip(want["paths"], want["grad_dist"][j], want["grad_ref"])}
        emit(fh, cell=cell.name, kind=kind, seed=s, **extra,
             **train_steps.compare(got, want, want["grad_dist"][j]), grad_rel_by_leaf=by_leaf)

    def reference_of(s, judges, **kw):
        return reference.train(cell.config, cell.traffic, harness.derive_seed(s, 10),
                               harness.derive_seed(s, 11), device, steps=steps_n,
                               judges=judges, **kw)

    for s in seeds:
        t0 = time.perf_counter()
        got = program(s)
        want = reference_of(s, [got.pop("values")])
        emit_compared("program", s, got, want, 0, seconds=time.perf_counter() - t0,
                      loss=got["loss"], ref_loss=want["loss"])
    for s in control_seeds:
        ctrl = reference_of(s, [], precision="fp8", keep_values=True)
        got = {"loss": ctrl["loss"], "bytes": ctrl["bytes"]}
        for k in ("grad", "change", "residual"):
            if ctrl[k] is not None:
                got[k] = dict(zip(ctrl["paths"], ctrl[k]))
        runs = [("control", got, ctrl["values"])]
        for fault in faults:
            read = program(s, fault)
            runs.append((fault, read, read.pop("values")))
        want = reference_of(s, [v for _, _, v in runs])
        for j, (kind, read, _) in enumerate(runs):
            emit_compared(kind, s, read, want, j)
        del runs, ctrl


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_007)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    harness.import_program()
    import torch

    cell = harness.find_cell(harness.load_bench(), args.workload)
    device = torch.device(args.device)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    control = [args.first_seed + 104729 * (i + 1) for i in range(args.control_seeds)]
    fh = None
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        fh = args.out.open("a")
    if cell.traffic["driver"] == "solver_runs":
        solver_readings(cell, seeds, control, device, fh)
    else:
        faults = []
        if args.faults:
            faults = ["half_batch"]
            if cell.traffic.get("exchange") is not None:
                faults.append("exchange_left_out")
        train_readings(cell, seeds, control, faults, device, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
