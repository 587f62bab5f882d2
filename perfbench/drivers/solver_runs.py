"""Back-to-back solver runs through the port's ``Session``: closed loop, one client.

Set-up makes the problem on the device from the seed (``inputs/rcv1.py``),
builds the program's ``Problem``, cluster and method from the
configuration and traffic files, and runs ``warmup_runs`` runs of its own
seeds, which build the kernels and capture the executor's graph. A unit of
the window is one run: a ``Session`` on the resident problem, drained to
``result()`` with every certificate, its visit orders drawn from a seed of
its own (the cell's seed and the run's index). Every result is kept; once
the window has closed a sample of runs drawn from the seed is run again by
the plain reference and compared.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import inspect
import math

import numpy as np
import torch

from perfbench.harness import derive_seed
from perfbench.inputs import rcv1
from perfbench.inputs.draws import Draws
from perfbench.reference import solver as reference
from perfbench.reference.numerics import rel

# Accounting fields compared for equality, value fields compared in relative terms.
EXACT = ("iteration", "bytes_up", "bytes_down", "sim_time", "compute_time", "comm_time")


def as_plain(result) -> dict:
    """A program's ``RunResult`` in the reference's form."""
    return {"records": [dataclasses.asdict(r) for r in result.records],
            "w": torch.as_tensor(np.asarray(result.w)),
            "alpha": torch.as_tensor(np.asarray(result.alpha)),
            "alpha_applied": (None if result.alpha_applied is None
                              else torch.as_tensor(np.asarray(result.alpha_applied)))}


def _rel_norm(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    den = float(torch.linalg.vector_norm(b))
    num = float(torch.linalg.vector_norm(a - b))
    if not math.isfinite(num):
        return math.inf
    return num / den if den > 0 else num


def compare(got: dict, want: dict) -> dict:
    """The numbers of one run: accounting mismatches, and the widest
    relative gaps of the certificates, w and alpha."""
    recs_g, recs_w = got["records"], want["records"]
    mismatches = abs(len(recs_g) - len(recs_w))
    gap = objective = 0.0
    for g, w in zip(recs_g, recs_w):
        mismatches += sum(g[k] != w[k] for k in EXACT)
        gap = max(gap, rel(g["gap"], w["gap"]), rel(g["gap_server"], w["gap_server"]))
        objective = max(objective, rel(g["primal"], w["primal"]), rel(g["dual"], w["dual"]))
    alpha = _rel_norm(got["alpha"], want["alpha"])
    if want["alpha_applied"] is not None:
        alpha = max(alpha, _rel_norm(got["alpha_applied"], want["alpha_applied"]))
    nan = lambda x: math.inf if x != x else x  # noqa: E731
    return {"accounting_mismatches": float(mismatches), "gap_rel": nan(gap),
            "objective_rel": nan(objective), "w_rel": _rel_norm(got["w"], want["w"]),
            "alpha_rel": nan(alpha)}


def program_method(traffic: dict, K: int, d: int):
    """The program's preset, given the traffic's ``method`` values that it
    takes by name; the values it derives itself (protocol, sigma', CoCoA+'s
    gamma) are stated there for the reference, and a preset that derives
    others reads as not correct."""
    from repro_torch.core import baselines

    preset = getattr(baselines, traffic["preset"])
    params = inspect.signature(preset).parameters
    args = (K, d) if "d" in params else (K,)
    return preset(*args, **{k: v for k, v in traffic["method"].items() if k in params})


def program_cluster(config: dict):
    from repro_torch.core.simulate import ClusterModel

    c = config["cluster"]
    return ClusterModel(config["workers"], unit_time=c["unit_time"],
                        straggler_sigma=c["straggler_sigma"],
                        straggler_workers=tuple(c["straggler_workers"]), jitter=c["jitter"],
                        latency=c["latency"], bandwidth=c["bandwidth"],
                        delay_model=c["delay_model"])


class SolverWork:
    def __init__(self, config, traffic, seed, device, limits):
        from repro_torch.core.objectives import Problem

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.limits = limits
        self.X, self.y = rcv1.make(config, derive_seed(seed, 0), device)
        self.problem = Problem(X=self.X, y=self.y, lam=config["lam"], loss=config["loss"])
        self.cluster = program_cluster(config)
        self.method = program_method(traffic, config["workers"], config["num_features"])
        self.results: list = []
        self.tracing = False
        self.executor = None
        for j in range(traffic["warmup_runs"]):
            self.run_once(derive_seed(seed, 2, j))

    def run_once(self, run_seed: int):
        from repro_torch.api.session import Session

        t = self.traffic
        s = Session(self.problem, self.method, self.cluster, num_outer=t["num_outer"],
                    seed=run_seed, eval_every=t["eval_every"], eval_mode=t["eval_mode"],
                    executor=t["executor"], draws=Draws(run_seed, self.device),
                    device=self.device)
        self.executor = s.executor
        return s.run()

    def unit(self) -> None:
        run_seed = derive_seed(self.seed, 1, len(self.results))
        span = (torch.profiler.record_function("perfbench.run") if self.tracing
                else contextlib.nullcontext())
        with span:
            self.results.append((run_seed, self.run_once(run_seed)))

    def end_to_end(self, window_s, unit_s) -> dict:
        return {"run_s": window_s / len(unit_s), "run_p95_s": float(np.percentile(unit_s, 95))}

    def trace_begin(self) -> None:
        self.tracing = True

    def trace_end(self) -> dict:
        self.tracing = False
        return {}

    def free(self) -> None:
        from repro_torch.core import executor

        executor.clear_cache()
        self.problem = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> list[int]:
        rng = np.random.default_rng(derive_seed(self.seed, 3))
        n = len(self.results)
        return sorted(rng.choice(n, size=min(n, self.traffic["check_runs"]), replace=False))

    def check(self):
        worst: dict = {}
        failed = 0
        picked = self.sample()
        for i in picked:
            run_seed, result = self.results[i]
            want = reference.run(self.X, self.y, self.config, self.traffic, run_seed)
            got = as_plain(result)
            failed += len(got["records"]) != len(want["records"])
            for k, v in compare(got, want).items():
                worst[k] = max(worst.get(k, 0.0), v)
        limits = self.limits["limits"]
        # A number whose readings gave it no limit is not compared (PERF.md).
        return len(picked), failed, {k: (v, limits[k]) for k, v in worst.items() if k in limits}


def setup(config, traffic, seed, device, limits):
    return SolverWork(config, traffic, seed, device, limits)
