#!/usr/bin/env python
"""Where the time goes in the port's ACPD run on one CUDA card.

Builds the main problem of ``chip_smoke.py`` (RCV1 width, same shapes and
seed) once, then for each mode runs ACPD once to warm up, once unprofiled
and once under ``torch.profiler``, and prints one JSON object a mode: wall
time, the device's busy time (the sum of kernel times; the run uses one
stream), the idle share, and the kernels by device time. Modes: ``loop``,
the reference loop (``run_method_reference``: one SDCA launch per worker
round, a gap certificate a round); ``engine``, the protocol engine
(``run_method``: one launch per worker group, the certificates deferred to
one batched evaluation). ``--trace PREFIX`` also writes each mode's Chrome
trace to ``PREFIX.<mode>.json``. More modes run the cell's other methods
through the whole-run executor (one captured CUDA graph, replayed: the
warm-up run captures it) and the same run through the event engine: the
CoCoA+ baseline for ``chip_smoke.COCOA_ROUNDS`` rounds (``scan`` /
``cocoa``), LAG (``lag_scan`` / ``lag``) and partial_work with 4 chunks
(``partial_scan`` / ``partial``) for one outer round of T.
``--reps N`` times N unprofiled runs of each mode after every mode's
warm-up, the modes in turns (forward, then backward), and reports their
median, quartiles and every run.

Run from the repo root on a machine with a card:

    python3 scripts/profile_torch_acpd.py [--mode MODE|both|executor|all]
        [--reps N] [--trace PREFIX]

``both`` is loop and engine, ``executor`` the six executor/event modes,
``all`` every mode.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--mode", default="both", choices=(
        "loop", "engine", "scan", "cocoa", "lag_scan", "lag", "partial_scan", "partial",
        "both", "executor", "all"))
    parser.add_argument("--trace", type=pathlib.Path, default=None)
    parser.add_argument("--reps", type=int, default=1)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_acpd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cfg
    from repro_torch.api import problems
    from repro_torch.api.session import Session
    from repro_torch.core import acpd, baselines
    from repro_torch.core.simulate import ClusterModel

    dev = torch.device("cuda")
    problem = problems.rcv1_like(K=cfg.K, d=cfg.D, n_per_worker=cfg.N_K, seed=cfg.SEED,
                                 nnz_per_row=24, lam=cfg.LAM, loss="ridge", device=dev)
    method = baselines.acpd(cfg.K, cfg.D, B=cfg.B, T=cfg.T, rho_d=cfg.RHO_D,
                            gamma=cfg.GAMMA, H=cfg.H)
    cluster = ClusterModel(cfg.K, straggler_sigma=10.0)

    runners = {
        "loop": lambda: acpd.run_method_reference(problem, method, cluster, num_outer=1,
                                                  seed=cfg.SEED, eval_every=1, device=dev),
        "engine": lambda: acpd.run_method(problem, method, cluster, num_outer=1,
                                          seed=cfg.SEED, eval_every=1, device=dev),
    }
    others = {  # mode pairs: (method, outer rounds), executor then event engine
        ("scan", "cocoa"): (baselines.cocoa_plus(cfg.K, H=cfg.H), cfg.COCOA_ROUNDS),
        ("lag_scan", "lag"): (baselines.acpd_lag(cfg.K, cfg.D, B=cfg.B, T=cfg.T,
                                                 rho_d=cfg.RHO_D, gamma=cfg.GAMMA,
                                                 H=cfg.H), 1),
        ("partial_scan", "partial"): (baselines.acpd_partial_work(
            cfg.K, cfg.D, B=cfg.B, T=cfg.T, rho_d=cfg.RHO_D, gamma=cfg.GAMMA, H=cfg.H,
            n_chunks=4), 1),
    }
    rounds = {}
    for names, (m, outer) in others.items():
        for name, ex in zip(names, ("scan", "event")):
            runners[name] = (lambda m=m, outer=outer, ex=ex: Session(
                problem, m, cluster, num_outer=outer, seed=cfg.SEED, executor=ex,
                device=dev).run())
            rounds[name] = outer * (1 if m.protocol in ("sync", "cocoa", "cocoa_plus")
                                    else m.T)
    executor_modes = tuple(n for names in others for n in names)
    modes = {"both": ("loop", "engine"), "executor": executor_modes,
             "all": ("loop", "engine") + executor_modes}.get(args.mode, (args.mode,))

    def run(mode):
        runners[mode]()
        torch.cuda.synchronize()

    for mode in modes:
        run(mode)  # warm-up: kernel build and load, allocator, cuBLAS handles, capture
    walls = {mode: [] for mode in modes}
    for r in range(args.reps):
        for mode in (modes if r % 2 == 0 else modes[::-1]):
            t0 = time.perf_counter()
            run(mode)
            walls[mode].append((time.perf_counter() - t0) * 1e3)
    for mode in modes:
        q1, median, q3 = np.percentile(walls[mode], [25, 50, 75])
        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run(mode)
            wall_profiled = time.perf_counter() - t0
        if args.trace is not None:
            args.trace.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(f"{args.trace}.{mode}.json")

        rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
        kernels = sorted((r for r in rows if r[2] > 0 and not r[0].startswith("aten::")
                          and not r[0].startswith("cuda")), key=lambda r: -r[2])
        busy_ms = sum(r[2] for r in kernels) / 1e3
        print(json.dumps({
            "mode": mode,
            "card": torch.cuda.get_device_name(0),
            "nvidia_smi": cfg.nvidia_smi(),
            "rounds": rounds.get(mode, cfg.T),
            "wall_ms": median,
            "wall_ms_quartiles": [q1, q3],
            "wall_ms_runs": walls[mode],
            "wall_ms_profiled": wall_profiled * 1e3,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_profiled * 1e3),
            "kernels": [{"name": n[:120], "count": c, "device_ms": us / 1e3}
                        for n, c, us in kernels[:15]],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
