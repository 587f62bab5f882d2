"""Batched sweep runner: many independent runs, ONE captured graph.

PyTorch counterpart of ``repro.api.sweep``. Grids over delay models, seeds
and server step sizes (gamma) share one spec shape: the dataset, protocol
and round budget. :func:`run_sweep` runs every cell of a scan-capable
protocol (the lockstep ``sync`` / ``cocoa`` / ``cocoa_plus`` and ``lag``)
inside one run function of :mod:`repro_torch.core.executor`, captured once
as a CUDA graph on the card:

* ``batch="map"``  -- the cells run one after another inside the graph,
  each with the op sequence of its solo run: every cell equals its
  ``Session(executor="scan")`` run (and so the event engine) bit for bit.
* ``batch="vmap"`` (default) -- the cells' workers run as the batch rows of
  ONE ``sdca_inner`` launch per round (``V * K`` rows over the shared
  ``X``; the kernel reads each row's ``alpha`` and sigma' at the row and
  ``X`` at the worker), the rest batched across cells. Deterministic, but
  the batched reductions (and the kernel's cluster size for ``V * K`` rows)
  reorder float sums, so not bit-identical to solo runs.

The delay axis rides along: lockstep timing is host accounting, and the
lag queue consumes each cell's pre-sampled durations and link factors as
inputs. Accounting comes back per cell; the deferred gap certificates are
evaluated per cell after the run, as a solo run evaluates them.

A sweep's graph is keyed as the JAX package keys its executables
(:func:`sweep_key`): gamma and sigma' enter per cell as inputs (a method
that derives sigma' from gamma, or a cell whose gamma is NaN, captures
nothing new), the cell axis is padded to its power-of-two bucket by
repeating the last cell, and the eval snapshots to theirs; the padded rows
run real work and are dropped before evaluation. So the service's batches
of 3 and of 4 cells share one capture.

Sharding (``shard=``) keeps the JAX package's resolution rules
(:func:`resolve_shard`), but a sweep runs on the one device its problem
lives on, so every request resolves to the unsharded path there.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine, executor, objectives
from repro_torch.core.acpd import MethodConfig, RunResult
from repro_torch.core.objectives import lam_n_f32
from repro_torch.core.sdca import TorchDraws
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops
from repro_torch.kernels import sdca_inner as sdca_kernel

SHARD_MODES = ("auto", "none", "cells", "workers")


@dataclasses.dataclass(frozen=True)
class SweepVariant:
    """One cell of the sweep: the varied parameters plus its RunResult.

    ``rounds`` carries the cell's per-round accounting
    (:class:`repro_torch.core.executor.RoundAccount`) so a consumer can replay
    the cell's complete Session event stream.
    """

    seed: int
    gamma: float
    result: RunResult
    delay: str = "constant"  # the cell's delay-model registry entry
    rounds: tuple | None = None  # per-round RoundAccounts


@dataclasses.dataclass(frozen=True)
class SweepCellSpec:
    """One EXPLICIT sweep cell. ``gamma=None`` keeps the method's gamma;
    ``sigma_prime=None`` resolves the protocol default for the cell's gamma
    (what a solo run would do). The ``cluster`` is fully per-cell."""

    cluster: ClusterModel
    seed: int
    gamma: float | None = None
    sigma_prime: float | None = None


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """A resolved ``shard=`` request: which axis, over how many devices."""

    mode: str  # "none" | "cells" | "workers"
    n_shards: int  # 1 iff mode == "none"


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _device_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def resolve_shard(shard: str, *, protocol: str, num_workers: int,
                  n_devices: int | None = None) -> ShardPlan:
    """Resolve a ``shard=`` request against ``n_devices`` devices
    (``torch.cuda.device_count()``, or 1 without a card).

    ``auto`` and ``cells`` shard the cell axis over the largest power of two
    of the devices and degrade to ``none`` on one device; ``workers`` needs a
    lockstep protocol and a worker count divisible by the shard count and
    degrades to ``none`` when no split exists.
    """
    if shard not in SHARD_MODES:
        raise ValueError(f"unknown shard mode {shard!r}; expected one of "
                         f"{SHARD_MODES}")
    if n_devices is None:
        n_devices = _device_count()
    pow2 = _pow2_floor(n_devices)
    if shard == "workers":
        if protocol not in executor.LOCKSTEP_PROTOCOLS:
            raise ValueError(
                f"shard='workers' partitions the lockstep worker axis; "
                f"protocol {protocol!r} cannot (lag's event queue is "
                f"sequential in arrival order). Use shard='cells'.")
        s = pow2
        while s > 1 and num_workers % s:
            s //= 2
        return ShardPlan("workers", s) if s > 1 else ShardPlan("none", 1)
    if shard == "none" or pow2 == 1:
        return ShardPlan("none", 1)
    return ShardPlan("cells", pow2)  # "auto" and "cells"


def sweep_supported(method: MethodConfig,
                    cluster: ClusterModel) -> tuple[bool, str]:
    """Can (method, cluster) batch into :func:`run_sweep`? (ok, why-not)."""
    if method.protocol not in executor.SWEEP_PROTOCOLS:
        return False, (
            f"protocol {method.protocol!r} does not batch into shared sweep "
            f"cells (sweep-batchable: {executor.SWEEP_PROTOCOLS}); run it "
            f"one Session per cell")
    return executor.scan_supported(method, cluster)


# ---------------------------------------------------------------------------
# The sweep bodies.
# ---------------------------------------------------------------------------


def _prefixed(v: int, inp: dict) -> dict:
    return {f"c{v}.{k}": t for k, t in inp.items()}


def _cell_inputs(v: int, inp: dict) -> dict:
    pre = f"c{v}."
    return {k[len(pre):]: t for k, t in inp.items() if k.startswith(pre)}


def _lockstep_vmap_body(problem, solver, V: int, *, length: int, n_slots: int):
    """All cells' lockstep rounds batched: per round one solve of ``V * K``
    rows (``cells=V``), the aggregation per cell from the stacked rows."""
    K, n_k, d = problem.X.shape
    X, lam, loss, n = problem.X, problem.lam, problem.loss, problem.n

    def fn(inp):
        y, norms_sq = inp["y"], inp["norms_sq"]
        gamma, sigma = inp["gamma"], inp["sigma_rows"]
        g_rows = gamma.repeat_interleave(K)[:, None]
        err = sdca_kernel.map_error_word(X.device)
        w = torch.zeros((V, d), dtype=X.dtype, device=X.device)
        alpha = torch.zeros((V * K, n_k), dtype=X.dtype, device=X.device)
        ws = executor._snapshot_buffer(n_slots, (V, d), w)
        alphas = executor._snapshot_buffer(n_slots, (V, K, n_k), alpha)
        slots = sorted(k for k in inp if k.startswith("orders_"))
        for r in range(length):
            w_all = w.repeat_interleave(K, dim=0)
            dalpha, v = solver.solve([inp[s][r] for s in slots], w_all, alpha, X, y,
                                     norms_sq, lam, n, sigma, loss=loss, cells=V,
                                     map_error=err)
            alpha = alpha + g_rows * dalpha
            w = w + gamma[:, None] * v.view(V, K, d).sum(dim=1)
            at = inp["eval_slot"][r:r + 1]
            ws.index_copy_(0, at, w[None])
            alphas.index_copy_(0, at, alpha.view(1, V, K, n_k))
        return {"w": w, "alpha": alpha.view(V, K, n_k), "map_error": err,
                "eval_ws": ws[:n_slots].transpose(0, 1).contiguous(),
                "eval_alphas": alphas[:n_slots].transpose(0, 1).contiguous()}

    return fn


def _lag_vmap_body(problem, method, V: int, *, needs, comp, R, n_slots):
    """All cells' LAG queues stepped together; each wave's relaunches of all
    cells are ONE kernel launch (worker map = the cells' sorted orders,
    ``alpha`` and sigma' per row)."""
    X = problem.X

    def fn(inp):
        runs = [executor.QueueRun(problem, method, _cell_inputs(v, inp),
                                  chunk_steps=(method.H,), needs=needs, comp=comp,
                                  lag=True, n_slots=n_slots)
                for v in range(V)]
        err = runs[0].map_error
        y, norms_sq = runs[0].problem.y, runs[0].norms_sq

        def wave(steps):
            w_eff, alphas, wmaps, idxs, sig, res_rows = [], [], [], [], [], []
            for run, (widx, B, _, _) in zip(runs, steps):
                res = run.residual.index_select(0, widx)
                res_rows.append(res)
                w_eff.append(run.w_local.index_select(0, widx) + run.gamma * res)
                alphas.append(run.alpha.index_select(0, widx))
                wmaps.append(widx.to(torch.int32))
                idxs.append(run.inp["orders_0"][run.wave, :B])
                sig.append(run.sigma.expand(B))
            dalpha, v = ops.sdca_epoch(
                torch.cat(w_eff), torch.cat(alphas), X, y, norms_sq, problem.lam,
                problem.n, 0.0, torch.cat(idxs), loss=problem.loss,
                workers=torch.cat(wmaps), map_error=err, alpha_rows=True,
                sigma_rows=torch.cat(sig))
            at = 0
            for run, res, (widx, B, starts, billing) in zip(runs, res_rows, steps):
                solved = engine.group_local_finish(run.alpha, widx, res,
                                                   dalpha[at:at + B], v[at:at + B],
                                                   run.gamma, run.comp)
                run.launch(widx, B, starts, billing, solved=solved)
                at += B

        wave([run.first_wave() for run in runs])
        for r in range(R):
            wave([run.server(r) for run in runs])
            for run in runs:
                run.record(r)
        out = {}
        for v, run in enumerate(runs):
            o = run.outputs()
            o["map_error"] = err
            out.update(_prefixed(v, o))
        return out

    return fn


# ---------------------------------------------------------------------------
# The sweep drivers.
# ---------------------------------------------------------------------------


def _delay_variants(cluster: ClusterModel, delays):
    """Normalize the delay axis to [(name, ClusterModel), ...]."""
    if delays is None:
        return [(cluster.delay_model, cluster)]
    out = []
    for entry in delays:
        if isinstance(entry, str):
            name, params = entry, None
        else:
            name, params = entry
        if params is None:
            params = (dict(cluster.delay_params)
                      if name == cluster.delay_model else {})
        out.append((name, dataclasses.replace(
            cluster, delay_model=name, delay_params=tuple(params.items()))))
    return out


def run_sweep(problem: objectives.Problem, method: MethodConfig, cluster: ClusterModel,
              *, num_outer: int, seeds=(0,), gammas=None, delays=None,
              eval_every: int = 1, batch: str = "vmap",
              shard: str = "auto") -> list[SweepVariant]:
    """Run the cross product ``delays x seeds x gammas`` of a scan-capable
    method as one captured graph; one :class:`SweepVariant` per cell
    (delay-major, then seed, then gamma).

    ``gammas=None`` keeps the method's gamma; a swept gamma with
    ``method.sigma_prime`` unset gets its protocol's default sigma' for that
    gamma. ``delays`` entries are delay-registry names or ``(name, params)``
    pairs. Under ``batch="map"`` every cell equals its
    ``Session(executor="scan")`` run bit for bit.
    """
    if method.protocol not in executor.SWEEP_PROTOCOLS:
        raise ValueError(
            f"sweep batching needs a sweep-batchable (shared-cell "
            f"scan-capable) protocol {executor.SWEEP_PROTOCOLS}, got "
            f"{method.protocol!r}; run other protocols one Session per "
            f"cell")
    if batch not in ("vmap", "map"):
        raise ValueError(f"unknown batch mode {batch!r}; 'vmap' or 'map'")
    if num_outer <= 0:
        raise ValueError(f"num_outer must be >= 1, got {num_outer}")
    gammas = [method.gamma] if gammas is None else list(gammas)
    seeds = list(seeds)
    if not seeds or not gammas:
        raise ValueError(
            f"the sweep grid is empty: got {len(seeds)} seeds x "
            f"{len(gammas)} gammas (each axis needs at least one value)")
    variants = _delay_variants(cluster, delays)
    if not variants:
        raise ValueError("delays=() declares an empty delay axis; pass "
                         "None to keep the cluster's own delay model")
    cells = [SweepCellSpec(cl, s, g, method.sigma_prime)
             for _, cl in variants for s in seeds for g in gammas]
    return run_sweep_cells(problem, method, cells, num_outer=num_outer,
                           eval_every=eval_every, batch=batch, shard=shard)


def _cell_methods(method, cells, K):
    mcfgs = [dataclasses.replace(method, gamma=c.gamma, sigma_prime=c.sigma_prime)
             for c in cells]
    return mcfgs, [m.resolved_sigma_prime(K) for m in mcfgs]


def _padded(items: list) -> list:
    """``items`` padded to the power-of-two bucket of their count by
    repeating the last (the JAX package's ``_padded_cells``)."""
    return items + [items[-1]] * (engine._bucket_size(len(items)) - len(items))


def _lockstep_key(problem, method, num_cells, *, num_outer, eval_every, batch):
    evals = executor._eval_indices(num_outer, eval_every)
    return ("sweep", batch, str(problem.X.device), tuple(problem.X.shape), problem.loss,
            method.H, executor.solver_name(method), num_outer, executor.eval_slots(evals),
            lam_n_f32(problem.lam, problem.n), engine._bucket_size(num_cells))


def _lag_key(problem, method, num_cells, *, num_outer, eval_every, batch):
    K, n_k, d = problem.X.shape
    R = num_outer * method.T
    evals = executor._eval_indices(R, eval_every)
    return ("sweep_lag", batch, str(problem.X.device), tuple(problem.X.shape), problem.loss,
            method.H, compress_lib.for_method(method, d), executor.lag_needs(method, K, R),
            executor.eval_slots(evals), method.lag_window,
            lam_n_f32(problem.lam, problem.n), engine._bucket_size(num_cells))


def sweep_key(problem, method, num_cells: int, *, num_outer: int, eval_every: int,
              batch: str) -> tuple:
    """The cache key (``executor.cache_key``) of the graph that
    :func:`run_sweep_cells` runs ``num_cells`` cells of ``method`` in: equal
    keys share one capture. Neither gamma, sigma', the cells' clusters and
    seeds, nor the cell count within its power-of-two bucket enter it."""
    make = _lag_key if method.protocol == "lag" else _lockstep_key
    return executor.cache_key(make(problem, method, num_cells, num_outer=num_outer,
                                   eval_every=eval_every, batch=batch), [problem.X])


def _eval_cell(problem, rounds, evals, ws, alphas):
    """A cell's records from its snapshots: the solo run's batched evaluation."""
    if not evals:
        return []
    E = len(evals)
    p, dv, gap, gap_srv = engine._eval_batched(ws[:E], alphas[:E], problem)
    rows = zip(*(t.tolist() for t in (p, dv, gap, gap_srv)))
    return [executor._record(rounds[r], r, *row) for r, row in zip(evals, rows)]


def _lockstep_cells(problem, method, cells, *, num_outer, eval_every, batch):
    K, n_k, d = problem.X.shape
    dev = problem.X.device
    R = num_outer
    mcfgs, sigma_ps = _cell_methods(method, cells, K)
    norms_sq = torch.sum(problem.X * problem.X, dim=-1)
    evals = executor._eval_indices(R, eval_every)
    n_slots = executor.eval_slots(evals)
    solver = executor.lockstep_solver(method)
    per_cell = []
    for c, m, sp in zip(cells, mcfgs, sigma_ps):
        draws = TorchDraws(c.seed, dev)
        _, _, inp = executor._lockstep_inputs(problem, m, norms_sq, draws, draws.root(),
                                              sp, R, evals=evals)
        per_cell.append(inp)
    V = len(cells)
    per_cell = _padded(per_cell)
    V_pad = len(per_cell)
    if batch == "map":
        def body(inp):
            fn = executor.lockstep_body(problem, solver, length=R, n_slots=n_slots)
            out = {}
            for v in range(V_pad):
                out.update(_prefixed(v, fn(_cell_inputs(v, inp))))
            return out

        inp = {}
        for v, ci in enumerate(per_cell):
            inp.update(_prefixed(v, ci))
        batches = [K]
    else:
        body = _lockstep_vmap_body(problem, solver, V_pad, length=R, n_slots=n_slots)
        slots = sorted(k for k in per_cell[0] if k.startswith("orders_"))
        inp = {"y": problem.y, "norms_sq": norms_sq, "eval_slot": per_cell[0]["eval_slot"],
               "gamma": executor.host_input([m.gamma for m in _padded(mcfgs)],
                                            torch.float32, dev),
               "sigma_rows": executor.host_input(np.repeat(_padded(sigma_ps), K),
                                                 torch.float32, dev)}
        for s in slots:
            inp[s] = torch.cat([ci[s] for ci in per_cell], dim=1)
        batches = [V_pad * K]
    key = _lockstep_key(problem, method, V, num_outer=R, eval_every=eval_every, batch=batch)
    run = executor._compiled(key, [problem.X], lambda: executor.Graphed(
        body, dev, "sweep", executor._prepare_kernel(problem, batches)))
    out = run(inp)
    if batch == "vmap":
        sdca_kernel.raise_map_error(out["map_error"].cpu(), K)
    out_v = [_cell_inputs(v, out) for v in range(V)] if batch == "map" else [
        {k: out[k][v] for k in ("w", "alpha", "eval_ws", "eval_alphas")} for v in range(V)]
    results = []
    for v, (c, m) in enumerate(zip(cells, mcfgs)):
        rounds = executor.lockstep_accounts(m, c.cluster, d, num_rounds=R, seed=c.seed)
        o = out_v[v]
        records = _eval_cell(problem, rounds, evals, o["eval_ws"], o["eval_alphas"])
        results.append(SweepVariant(c.seed, c.gamma, RunResult(
            m, records, o["w"].cpu().numpy(), o["alpha"].cpu().numpy()),
            delay=c.cluster.delay_model, rounds=tuple(rounds)))
    return results


def _lag_cells(problem, method, cells, *, num_outer, eval_every, batch):
    K, n_k, d = problem.X.shape
    dev = problem.X.device
    T = method.T
    R = num_outer * T
    for c in cells:
        ok, why = executor.scan_supported(method, c.cluster)
        if not ok:
            raise ValueError(
                f"delay model {c.cluster.delay_model!r} cannot batch into a "
                f"lag sweep: {why}; run it per-cell via "
                f"Session(executor='event')")
    comp = compress_lib.for_method(method, d)
    needs = executor.lag_needs(method, K, R)
    mcfgs, _ = _cell_methods(method, cells, K)
    norms_sq = torch.sum(problem.X * problem.X, dim=-1)
    evals = executor._eval_indices(R, eval_every)
    n_slots = executor.eval_slots(evals)
    per_cell = []
    for c, m in zip(cells, mcfgs):
        draws = TorchDraws(c.seed, dev)
        per_cell.append(executor.queue_inputs(
            problem, m, c.cluster, norms_sq, draws, draws.root(), R=R, seed=c.seed,
            needs=needs, chunk_steps=(method.H,), evals=evals))
    V = len(cells)
    per_cell = _padded(per_cell)
    V_pad = len(per_cell)
    inp = {}
    for v, ci in enumerate(per_cell):
        inp.update(_prefixed(v, ci))
    if batch == "map":
        def body(inp):
            out = {}
            for v in range(V_pad):
                run = executor.QueueRun(problem, method, _cell_inputs(v, inp),
                                        chunk_steps=(method.H,), needs=needs, comp=comp,
                                        lag=True, n_slots=n_slots)
                out.update(_prefixed(v, run.run(R)))
            return out

        batches = (K,) + needs
    else:
        body = _lag_vmap_body(problem, method, V_pad, needs=needs, comp=comp, R=R,
                              n_slots=n_slots)
        batches = tuple(V_pad * b for b in (K,) + needs)
    key = _lag_key(problem, method, V, num_outer=num_outer, eval_every=eval_every,
                   batch=batch)
    run = executor._compiled(key, [problem.X], lambda: executor.Graphed(
        body, dev, "sweep_lag", executor._prepare_kernel(problem, batches)))
    out = run(inp)
    results = []
    for v, (c, m) in enumerate(zip(cells, mcfgs)):
        o = _cell_inputs(v, out)
        sdca_kernel.raise_map_error(o["map_error"].cpu(), K)
        rounds = executor.queue_accounts(o, needs, T)
        records = _eval_cell(problem, rounds, evals, o["eval_ws"], o["eval_alphas"])
        results.append(SweepVariant(c.seed, c.gamma, RunResult(
            m, records, o["w"].cpu().numpy(), o["alpha"].cpu().numpy(),
            alpha_applied=o["alpha_applied"].cpu().numpy()),
            delay=c.cluster.delay_model, rounds=tuple(rounds)))
    return results


def run_sweep_cells(problem: objectives.Problem, method: MethodConfig, cells, *,
                    num_outer: int, eval_every: int = 1, batch: str = "vmap",
                    shard: str = "auto") -> list[SweepVariant]:
    """Run an EXPLICIT list of sweep cells as one captured graph.

    ``cells`` are :class:`SweepCellSpec` (or ``(cluster, seed, gamma)``
    tuples); ``method`` is the shared template (protocol, H, T, B, rho,
    compressor, solver, lag window), each cell overriding gamma, sigma',
    cluster and seed. Same contract as :func:`run_sweep`; every variant
    carries its per-round accounting.
    """
    if method.protocol not in executor.SWEEP_PROTOCOLS:
        raise ValueError(
            f"sweep batching needs a sweep-batchable (shared-cell "
            f"scan-capable) protocol {executor.SWEEP_PROTOCOLS}, got "
            f"{method.protocol!r}; run other protocols one Session per "
            f"cell")
    if batch not in ("vmap", "map"):
        raise ValueError(f"unknown batch mode {batch!r}; 'vmap' or 'map'")
    if num_outer <= 0:
        raise ValueError(f"num_outer must be >= 1, got {num_outer}")
    cells = [c if isinstance(c, SweepCellSpec) else SweepCellSpec(*c) for c in cells]
    if not cells:
        raise ValueError("cells is empty: pass at least one SweepCellSpec")
    cells = [dataclasses.replace(c, gamma=method.gamma) if c.gamma is None else c
             for c in cells]
    K = problem.X.shape[0]
    for c in cells:
        if c.cluster.num_workers != K:
            raise ValueError(
                f"cell cluster has num_workers={c.cluster.num_workers} but "
                f"the problem is partitioned over K={K} workers")
    # The rules are the JAX package's; the problem lives on one device, so
    # the sweep runs there unsharded.
    resolve_shard(shard, protocol=method.protocol, num_workers=K, n_devices=1)
    if method.protocol in executor.LOCKSTEP_PROTOCOLS:
        ok, why = executor.scan_supported(method, cells[0].cluster)
        if not ok:
            raise ValueError(f"this method cannot run as a sweep: {why}")
        core = _lockstep_cells
    else:
        core = _lag_cells
    return core(problem, method, cells, num_outer=num_outer, eval_every=eval_every,
                batch=batch)


def run_lockstep_sweep(problem: objectives.Problem, method: MethodConfig,
                       cluster: ClusterModel, *, num_outer: int, seeds=(0,),
                       gammas=None, eval_every: int = 1, batch: str = "vmap",
                       shard: str = "none") -> list[SweepVariant]:
    """Lockstep-only compat wrapper over :func:`run_sweep`."""
    if method.protocol not in executor.LOCKSTEP_PROTOCOLS:
        raise ValueError(
            f"sweep batching needs a lockstep protocol "
            f"{executor.LOCKSTEP_PROTOCOLS}, got {method.protocol!r}; use "
            f"run_sweep for lag, or one Session per cell for the group "
            f"family")
    return run_sweep(problem, method, cluster, num_outer=num_outer, seeds=seeds,
                     gammas=gammas, eval_every=eval_every, batch=batch, shard=shard)


def sweep_spec(spec, method_name: str, *, seeds=None, gammas=None, delays=None,
               batch: str = "vmap", shard: str | None = None,
               device: str | torch.device | None = None) -> list[SweepVariant]:
    """Sweep one method entry of an :class:`repro_torch.api.spec.ExperimentSpec`
    (its eval cadence, problem and seed; ``seeds`` defaults to
    ``(spec.seed,)``), on ``device`` (CUDA unless given)."""
    from repro_torch.device import resolve_device

    if spec.target_gap is not None or spec.time_budget is not None:
        raise ValueError(
            "sweep batching runs whole runs and cannot early-stop; "
            "this spec sets target_gap/time_budget -- run it per-cell via "
            "Experiment/Session instead")
    entry = spec.method_named(method_name)
    problem = spec.problem.build(device=resolve_device(device))
    return run_sweep(problem, entry.config, spec.cluster, num_outer=entry.num_outer,
                     seeds=(spec.seed,) if seeds is None else seeds, gammas=gammas,
                     delays=delays, eval_every=spec.eval_every, batch=batch,
                     shard=spec.shard if shard is None else shard)
