#!/usr/bin/env python
"""Where the time goes in the port's ACPD run on one CUDA card.

Builds the main problem of ``chip_smoke.py`` (RCV1 width, same shapes and
seed), runs the ACPD reference loop once to warm up, then once more under
``torch.profiler`` and prints one JSON object: wall time, the device's busy
time (the sum of kernel times; the loop runs on one stream), the idle share,
and the kernels by device time. ``--trace PATH`` also writes the Chrome
trace.

Run from the repo root on a machine with a card:

    python3 scripts/profile_torch_acpd.py [--trace chiprun_out/acpd_trace.json]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

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
    parser.add_argument("--trace", type=pathlib.Path, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_acpd: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cfg
    from repro_torch.api import problems
    from repro_torch.core import acpd, baselines
    from repro_torch.core.simulate import ClusterModel

    dev = torch.device("cuda")
    problem = problems.rcv1_like(K=cfg.K, d=cfg.D, n_per_worker=cfg.N_K, seed=cfg.SEED,
                                 nnz_per_row=24, lam=cfg.LAM, loss="ridge", device=dev)
    method = baselines.acpd(cfg.K, cfg.D, B=cfg.B, T=cfg.T, rho_d=cfg.RHO_D,
                            gamma=cfg.GAMMA, H=cfg.H)
    cluster = ClusterModel(cfg.K, straggler_sigma=10.0)

    def run():
        acpd.run_method_reference(problem, method, cluster, num_outer=1, seed=cfg.SEED,
                                  eval_every=1, device=dev)
        torch.cuda.synchronize()

    run()  # warm-up: kernel build and load, allocator, cuBLAS handles
    t0 = time.perf_counter()
    run()
    wall_plain = time.perf_counter() - t0
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        wall_profiled = time.perf_counter() - t0
    if args.trace is not None:
        args.trace.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(args.trace))

    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[2] > 0 and not r[0].startswith("aten::")
                      and not r[0].startswith("cuda")), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in kernels) / 1e3
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "nvidia_smi": cfg.nvidia_smi(),
        "rounds": cfg.T,
        "wall_ms": wall_plain * 1e3,
        "wall_ms_profiled": wall_profiled * 1e3,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (wall_profiled * 1e3),
        "kernels": [{"name": n[:120], "count": c, "device_ms": us / 1e3}
                    for n, c, us in kernels[:15]],
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
