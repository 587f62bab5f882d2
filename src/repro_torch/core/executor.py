"""Whole-run executor: a run as ONE captured CUDA graph, replayed.

PyTorch counterpart of ``repro.core.executor``. The event engine
(:mod:`repro_torch.core.engine` driven by :class:`repro_torch.api.session.Session`)
pays one host step per round: a few launches, a pull of the replies' byte
counts, the heap. For protocols with no host-adaptive control flow the
whole run is instead a plain torch function with no host sync, captured
once as a ``torch.cuda.CUDAGraph`` and replayed: the port's counterpart of
the JAX package's one ``lax.scan`` per run. Selected via
``Session(executor="scan")`` or by ``"auto"``.

Three paths, as in the JAX package:

* **Lockstep** (``sync`` / ``cocoa`` / ``cocoa_plus``): timing is host
  accounting (:func:`lockstep_accounts`, the event loop's host-RNG stream
  pre-sampled by ``DelayModel.sample_stream``); the graph runs the rounds
  (:func:`repro_torch.core.engine.lockstep_round`, the event engine's own
  body) and keeps the eval-boundary snapshots.
* **LAG** (``lag``): the B-of-K queue moves onto the device. Per-worker
  arrival times (float64) and sequence numbers live in device tensors; each
  round sorts them lexicographically (two stable sorts, the host heap's pop
  order), applies the group with the event engine's op sequence, bills the
  replies on their device ``nnz`` and relaunches the arrived workers as ONE
  kernel launch whose worker map is the sorted order itself (an int32
  device tensor; ``sdca_inner``'s error word catches a bad entry). The
  float64 accounting adds in the host's order, so it is equal bit for bit.
* **partial_work**: the same with per-chunk state ``(K, n_chunks)``; the
  deadline is the B-th full arrival, every pending chunk at or before it is
  folded in global arrival order (a where-masked sum over a flattened sort).

Everything the host knows is fixed when the graph is captured: the round
count, the per-round arrival counts, the eval rounds. Everything else stays
on the device. Random draws come before the run: every visit order of the
run is drawn through the run's draw source in the event engine's call order
(one split chain, one batch per launch wave in rank order) into int32
tensors, and compute times are pre-sampled with
``DelayModel.sample_stream`` / ``sample_chunk_stream``. So for every
supported (protocol, delay) cell the executor equals the event engine bit
for bit: trajectories, accounting, certificates.

On the card a run is captured once per static signature (shapes, loss, H,
solver, compressor, round count and arrival counts, the number of eval
snapshots padded to a power of two, and lambda*n, which the kernel takes by
value) and replayed: the run's inputs (orders, durations, gamma, sigma', the
eval rounds' snapshot slots, link factors, ...) are copied into the graph's
buffers, the graph replays, and its outputs are cloned out. sigma' is an
input, read by the kernel per batch row, so runs that differ only in gamma
share a graph whatever sigma' their protocol derives from it.
``STATS["*_traces"]`` counts captures and ``STATS["*_calls"]`` runs; Python
does not run during a replay, so each graph records the ``sdca_inner``
launches it holds and every replay adds them to ``ops.LAUNCHES``. On the
CPU the same functions run eagerly (a cache entry still counts one trace
per signature). There is no eager path on the card: a capture that fails
raises.

Threads: the experiment service runs batches on a dispatcher thread and
abandons an overrun attempt on its own thread, which runs on. One
process-wide lock (``_LOCK``) is held across a cache lookup, a capture, and
a replay with its input copy and output clones, and across every update of
``STATS``; replays of one graph are ordered on the device by an event, so a
caller on another stream cannot overwrite the outputs another caller is
still cloning.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import pathlib
import threading
import time
import weakref
import zlib

import numpy as np
import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine, objectives
from repro_torch.core import solvers as solvers_lib
from repro_torch.core.acpd import MethodConfig, RunRecord, RunResult
from repro_torch.core.objectives import _full_fp32, lam_n_f32
from repro_torch.core.sdca import TorchDraws, as_orders
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops
from repro_torch.kernels import sdca_inner as sdca_kernel

LOCKSTEP_PROTOCOLS = ("sync", "cocoa", "cocoa_plus")
# Protocols whose run bodies batch into shared sweep cells (repro_torch.api.sweep).
SWEEP_PROTOCOLS = LOCKSTEP_PROTOCOLS + ("lag",)
# Protocols with a single-run executor path; partial_work runs solo only.
SCAN_PROTOCOLS = SWEEP_PROTOCOLS + ("partial_work",)

# target_gap runs compute-and-mask: every budgeted round executes after the
# target is hit, so ``executor="auto"`` keeps the event loop (which stops at
# the hit) beyond this budget; ``executor="scan"`` overrides.
GAP_SCAN_AUTO_MAX_ROUNDS = 4096

# "*_calls" counts runs (one replay each on the card), "*_traces" counts
# captures (one per static signature; flat across same-shape runs).
STATS = {"lockstep_calls": 0, "lockstep_traces": 0,
         "lockstep_gap_calls": 0, "lockstep_gap_traces": 0,
         "lockstep_segment_calls": 0, "lockstep_segment_traces": 0,
         "lag_calls": 0, "lag_traces": 0,
         "partial_calls": 0, "partial_traces": 0,
         "sweep_calls": 0, "sweep_traces": 0,
         "sweep_lag_calls": 0, "sweep_lag_traces": 0}

# torch.cuda.set_sync_debug_mode value held around every replay and the
# cloning of its outputs (0: off). "error" makes any host sync there raise.
REPLAY_SYNC_DEBUG: int | str = 0


# Held across every use of the graph cache, every capture and replay on the
# card, and every update of STATS (an eager run on the CPU runs outside it).
_LOCK = threading.RLock()


def reset_stats() -> None:
    with _LOCK:
        for k in STATS:
            STATS[k] = 0


# ---------------------------------------------------------------------------
# Eligibility.
# ---------------------------------------------------------------------------


def solver_name(method: MethodConfig) -> str:
    """The local solver a lockstep protocol runs (``sync`` is ``sdca``)."""
    return method.local_solver if method.protocol != "sync" else "sdca"


def lockstep_solver(method: MethodConfig):
    """The registry entry of :func:`solver_name`."""
    return solvers_lib.get_solver(solver_name(method))


def scan_supported(method: MethodConfig, cluster: ClusterModel, *,
                   eval_mode: str = "batched",
                   target_gap: float | None = None,
                   time_budget: float | None = None) -> tuple[bool, str]:
    """Can this run be one captured graph? Returns (ok, reason-if-not).

    The JAX package's rules, plus one of the port's: a lockstep run's local
    solver must be a :class:`repro_torch.core.solvers.LocalSolver` (its
    draws separable from its solve), as every built-in one is.
    """
    if method.exact_dual_feedback:
        return False, ("exact_dual_feedback needs a host lstsq per round "
                       "(reference path only)")
    if time_budget is not None:
        return False, "time_budget early stop needs the per-round event loop"
    if target_gap is not None:
        if method.protocol not in LOCKSTEP_PROTOCOLS:
            return False, (
                f"target_gap early stop runs in the graph only for lockstep "
                f"protocols {LOCKSTEP_PROTOCOLS}; {method.protocol!r} needs "
                f"the per-round event loop")
    elif eval_mode == "stream":
        return False, ("streamed certificates without a gap target need "
                       "the per-round event loop")
    if method.protocol in LOCKSTEP_PROTOCOLS:
        try:
            solver = lockstep_solver(method)
        except ValueError as e:
            return False, str(e)
        if not isinstance(solver, solvers_lib.LocalSolver):
            return False, (f"local solver {method.local_solver!r} draws inside its "
                           f"solve; register a solvers.LocalSolver to run it whole")
        return True, ""
    if method.protocol == "lag":
        model = cluster.make_delay()
        if model.vector_sampled or model.deterministic:
            return True, ""
        return False, (
            f"delay model {cluster.delay_model!r} draws per-launch host "
            f"randomness in arrival order, which cannot be pre-sampled "
            f"into a (round, worker) stream")
    if method.protocol == "partial_work":
        if cluster.membership:
            return False, ("elastic membership drop/rejoin schedules are "
                           "host-adaptive control flow (event loop only)")
        if method.pw_quantum is not None:
            return False, ("pw_quantum harvest ticks pop clock-dependent "
                           "arrival counts (event loop only)")
        model = cluster.make_delay()
        if model.vector_sampled or model.deterministic:
            return True, ""
        return False, (
            f"delay model {cluster.delay_model!r} draws per-launch host "
            f"randomness in arrival order, which cannot be pre-sampled "
            f"into a (round, chunk, worker) stream")
    return False, (
        f"protocol {method.protocol!r} has host-adaptive control flow "
        f"(scan-capable protocols: {SCAN_PROTOCOLS})")


def coalesce_supported(method: MethodConfig, cluster: ClusterModel, *,
                       target_gap: float | None = None,
                       time_budget: float | None = None) -> tuple[bool, str]:
    """Can this (method, cluster) join a SHARED sweep batch? (ok, why-not).

    The serve layer's admission rule: narrower than :func:`scan_supported`
    (early-stopped runs never coalesce: their round count is
    data-dependent); per protocol it is the registry's
    ``Protocol.coalesce_supported`` hook.
    """
    if target_gap is not None:
        return False, ("target_gap early stop makes the round count "
                       "data-dependent; batches compile fixed-length runs "
                       "-- served per-request instead")
    if time_budget is not None:
        return False, ("time_budget early stop needs the per-round event "
                       "loop -- served per-request instead")
    return engine.get_protocol(method.protocol).coalesce_supported(method, cluster)


# ---------------------------------------------------------------------------
# Run container handed back to the Session.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundAccount:
    """Host-side accounting of one server round (cumulative totals)."""

    arrivals: int
    is_sync: bool
    sim_time: float
    bytes_up: int
    bytes_down: int
    compute_time: float
    comm_time: float


@dataclasses.dataclass
class ScanRun:
    """Everything a Session needs to emit the run's event stream.

    ``eval_ws``/``eval_alphas`` hold the eval-boundary snapshots stacked
    (one tensor each, on the run's device).
    """

    method: MethodConfig
    rounds: list[RoundAccount]
    eval_rounds: list[int]  # 0-based round index per eval boundary
    eval_ws: torch.Tensor | None
    eval_alphas: torch.Tensor | None
    w: torch.Tensor
    alpha: torch.Tensor
    alpha_applied: torch.Tensor | None = None
    # target_gap runs: why the run stopped, and the records already made
    # from the graph's certificates (nothing left to defer).
    stop_reason: str = "completed"
    stream_records: list | None = None

    def materialize_records(self, problem, eval_mode: str) -> list[RunRecord]:
        """The run's RunRecords, by the event engine's certificate ops
        (``batched``: ``engine._eval_batched``; ``replay``: one
        ``gap_certificate`` each)."""
        if self.stream_records is not None:
            return self.stream_records
        if not self.eval_rounds:
            return []
        if eval_mode == "replay":
            rows = []
            for i in range(len(self.eval_rounds)):
                cert = objectives.gap_certificate(problem, self.eval_alphas[i],
                                                  w=self.eval_ws[i])
                rows.append((cert["primal"], cert["dual"], cert["gap"],
                             cert["gap_server"]))
        elif eval_mode == "batched":
            p, dv, gap, gap_srv = engine._eval_batched(self.eval_ws, self.eval_alphas,
                                                       problem)
            rows = list(zip(*(t.tolist() for t in (p, dv, gap, gap_srv))))
        else:
            raise ValueError(f"unknown eval_mode {eval_mode!r}")
        return [_record(self.rounds[r], r, *row) for r, row in zip(self.eval_rounds, rows)]

    def finalize(self, records) -> RunResult:
        def host(t):
            return None if t is None else t.cpu().numpy()

        return RunResult(self.method, records, host(self.w), host(self.alpha),
                         alpha_applied=host(self.alpha_applied))


def _record(a: RoundAccount, r: int, p, dv, gap, gap_srv) -> RunRecord:
    return RunRecord(iteration=r + 1, sim_time=a.sim_time, gap=float(gap),
                     gap_server=float(gap_srv), primal=float(p), dual=float(dv),
                     bytes_up=a.bytes_up, bytes_down=a.bytes_down,
                     compute_time=a.compute_time, comm_time=a.comm_time)


def _eval_indices(num_rounds: int, eval_every: int) -> list[int]:
    """0-based round indices of eval boundaries (iteration % eval_every == 0)."""
    return [it - 1 for it in range(1, num_rounds + 1) if it % eval_every == 0]


def eval_slots(evals) -> int:
    """How many snapshot rows a run keeps for ``evals``: their count padded
    to a power of two, so runs of other eval cadences share a graph."""
    return engine._bucket_size(len(evals)) if evals else 0


def _slot_input(num_rounds: int, evals, device) -> torch.Tensor:
    """Round r's snapshot row: its eval boundary's index, or the discard row
    ``eval_slots(evals)`` for a round that keeps none."""
    slot = np.full(num_rounds, eval_slots(evals), dtype=np.int64)
    slot[list(evals)] = np.arange(len(evals))
    return host_input(slot, torch.int64, device)


def _snapshot_buffer(n_slots: int, shape, like: torch.Tensor) -> torch.Tensor:
    """Snapshot rows plus the discard row, filled in the graph by
    ``index_copy_`` at each round's slot."""
    return torch.zeros((n_slots + 1, *shape), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# One run function, captured once and replayed.
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _sync_debug(mode):
    if not mode:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Graphed:
    """A run function bound to its static signature.

    ``fn(inputs) -> outputs`` maps a dict of tensors to a dict of tensors and
    makes no host sync. On the CPU a call runs it eagerly. On the card the
    first call warms up (``prepare()``: the kernel's library, plans and
    attributes, and cuBLAS on the capture stream) and captures it into one
    CUDA graph; every call copies its inputs into the graph's buffers,
    replays it, and clones the outputs out. ``launches`` is what one replay
    adds to ``ops.LAUNCHES``.
    """

    def __init__(self, fn, device: torch.device, stat: str, prepare=None):
        self.fn = fn
        self.device = device
        self.stat = stat
        self.prepare = prepare
        self.graph = None
        self.static_in: dict[str, torch.Tensor] = {}
        self.static_out: dict[str, torch.Tensor] = {}
        self.launches: dict[str, int] = {}
        self.capture_ms = 0.0
        self._done = None  # recorded after the last replay's clones

    def __call__(self, inputs: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        if self.device.type != "cuda":
            # Eager: no shared buffers, so only the count needs the lock.
            with _LOCK:
                STATS[f"{self.stat}_calls"] += 1
            return self.fn(inputs)
        with _LOCK:
            STATS[f"{self.stat}_calls"] += 1
            if self.graph is None:
                self._capture(inputs)
            with torch.cuda.device(self.device), _sync_debug(REPLAY_SYNC_DEBUG):
                stream = torch.cuda.current_stream(self.device)
                if self._done is not None:
                    stream.wait_event(self._done)
                for name, t in inputs.items():
                    self.static_in[name].copy_(t, non_blocking=True)
                self.graph.replay()
                out = {k: v.clone() for k, v in self.static_out.items()}
                self._done = torch.cuda.Event()
                self._done.record(stream)
            ops.add_launches(self.launches)
            return out

    def _capture(self, inputs) -> None:
        t0 = time.perf_counter()
        with torch.cuda.device(self.device):
            stream = torch.cuda.Stream()
            stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(stream):
                self.static_in = {k: v.to(self.device, copy=True) for k, v in inputs.items()}
                if self.prepare is not None:
                    self.prepare()
                with _full_fp32():  # cuBLAS handle and workspace for this stream
                    a = torch.ones(8, 8, device=self.device)
                    (a @ a).sum()
            stream.synchronize()
            graph = torch.cuda.CUDAGraph()
            # The lock orders this capture against every other capture and
            # replay. Other threads may still work on the card outside any
            # graph meanwhile (the event engine's runs, pinned host inputs,
            # certificates), on their own streams, which the capture stream
            # does not wait on. "thread_local" checks only this thread's
            # calls; the default, "global", would fail this capture, and the
            # other thread's call, on such a thread's first allocation.
            with ops.recording_launches() as counts, torch.cuda.graph(
                    graph, stream=stream, capture_error_mode="thread_local"):
                out = self.fn(self.static_in)
            self.launches = dict(counts)
            torch.cuda.synchronize(self.device)
        self.graph, self.static_out = graph, out
        self.capture_ms = (time.perf_counter() - t0) * 1e3


_CACHE: collections.OrderedDict = collections.OrderedDict()
_CACHE_SIZE = 16


def clear_cache() -> None:
    """Drop every captured graph (and the device memory their pools hold)."""
    with _LOCK:
        _CACHE.clear()


def cache_key(key: tuple, tensors) -> tuple:
    """The key :func:`_compiled` files a run under: ``key`` and the identity
    (address, shape, dtype, device) of the tensors its graph reads in place."""
    return key + tuple((t.data_ptr(), tuple(t.shape), t.dtype, str(t.device))
                       for t in tensors)


def _compiled(key: tuple, tensors, make) -> Graphed:
    """The cached run for ``key`` (``tensors``: the device tensors a graph
    reads in place, such as ``X``; the entry dies with them), or a new one
    from ``make()``, counted as one trace."""
    full_key = cache_key(key, tensors)
    with _LOCK:
        hit = _CACHE.get(full_key)
        if hit is not None and all(r() is not None for r in hit[0]):
            _CACHE.move_to_end(full_key)
            return hit[1]
        entry = make()
        STATS[f"{entry.stat}_traces"] += 1
        _CACHE[full_key] = ([weakref.ref(t) for t in tensors], entry)
        while len(_CACHE) > _CACHE_SIZE:
            _CACHE.popitem(last=False)
        return entry


def last_graph(stat: str) -> Graphed | None:
    """The most recently used cached run of kind ``stat`` (measurements)."""
    with _LOCK:
        for _, entry in reversed(_CACHE.values()):
            if entry.stat == stat:
                return entry
    return None


def _prepare_kernel(problem, batches):
    """Warm-up for a capture: the kernel's plan and attributes for every
    batch size the run launches."""
    if problem.X.device.type != "cuda":
        return lambda: None
    K, n_k, d = problem.X.shape

    def prepare():
        for B in sorted(set(batches)):
            sdca_kernel.prepare(problem.loss, B, n_k, d)

    return prepare


def _lexsort(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """The permutation ordering ``(primary, secondary)`` lexicographically:
    two stable sorts, so ties in ``primary`` keep ``secondary``'s order."""
    _, by_second = torch.sort(secondary, stable=True)
    _, by_first = torch.sort(primary.index_select(0, by_second), stable=True)
    return by_second.index_select(0, by_first)


def host_input(value, dtype, device) -> torch.Tensor:
    """A run input made on the host. Pinned when the run is on the card, so
    the copy into the graph's buffer is asynchronous: it does not wait for
    the work already queued on the device (a pageable copy would)."""
    t = torch.as_tensor(np.asarray(value), dtype=dtype)
    return t.pin_memory() if torch.device(device).type == "cuda" else t


def _draws_for(draws, seed: int, device):
    """The run's draw source and its root key."""
    draws = TorchDraws(seed, device) if draws is None else draws
    return draws, draws.root()


def _stack_orders(waves, shape_rows: int, device) -> torch.Tensor:
    """Launch waves' orders ``[(B_w, h)]`` padded into one ``(W, rows, h)``
    int32 tensor (unused rows zero)."""
    h = waves[0].shape[1]
    out = torch.zeros((len(waves), shape_rows, h), dtype=torch.int32, device=device)
    for w, o in enumerate(waves):
        out[w, :o.shape[0]] = o
    return out


# ---------------------------------------------------------------------------
# run_scan: dispatch.
# ---------------------------------------------------------------------------


def run_scan(problem: objectives.Problem, method: MethodConfig,
             cluster: ClusterModel, *, num_outer: int, seed: int,
             eval_every: int, norms_sq=None, target_gap: float | None = None,
             draws=None, key=None) -> ScanRun:
    """Execute one run on the whole-run executor (caller checked eligibility).

    ``draws``/``key``: the run's draw source and root key (a fresh
    ``TorchDraws(seed)`` on the problem's device by default); the Session
    hands over its protocol's, untouched, so both backends draw the same.
    """
    if norms_sq is None:
        norms_sq = torch.sum(problem.X * problem.X, dim=-1)
    if draws is None:
        draws, key = _draws_for(None, seed, problem.X.device)
    kw = dict(num_outer=num_outer, seed=seed, eval_every=eval_every, norms_sq=norms_sq,
              draws=draws, key=key)
    if method.protocol in LOCKSTEP_PROTOCOLS:
        if target_gap is not None:
            return _run_lockstep_gap(problem, method, cluster, target_gap=target_gap, **kw)
        return _run_lockstep(problem, method, cluster, **kw)
    if target_gap is not None:
        raise ValueError(
            f"target_gap early stop on the whole-run executor is lockstep-only; "
            f"{method.protocol!r} runs it through the event loop")
    if method.protocol in ("lag", "partial_work"):
        return _run_queue(problem, method, cluster, lag=method.protocol == "lag", **kw)
    raise ValueError(f"protocol {method.protocol!r} is not scan-capable "
                     f"(supported: {SCAN_PROTOCOLS})")


def _empty(problem, method, *, applied: bool) -> ScanRun:
    K, n_k, d = problem.X.shape
    dt, dev = problem.X.dtype, problem.X.device
    z = torch.zeros((K, n_k), dtype=dt, device=dev)
    return ScanRun(method, [], [], None, None, torch.zeros((d,), dtype=dt, device=dev),
                   z, alpha_applied=z.clone() if applied else None)


# ---------------------------------------------------------------------------
# Lockstep path: sync / cocoa / cocoa_plus.
# ---------------------------------------------------------------------------


def lockstep_accounts(method: MethodConfig, cluster: ClusterModel, d: int,
                      *, num_rounds: int, seed: int) -> list[RoundAccount]:
    """Host-side timing/byte accounting of a lockstep run: the event loop's
    one K-vector a round, pre-sampled (same floats), and the static ring
    allreduce time and bytes."""
    K = cluster.num_workers
    delay = cluster.make_delay()
    rng = np.random.default_rng(seed)
    durations = delay.sample_stream(num_rounds, method.H, rng, lockstep=True)
    step_comm = delay.allreduce_time(d)
    phase = (K - 1) * d * 4  # ring reduce-scatter == all-gather
    sim = comp_t = comm_t = 0.0
    bu = bd = 0
    rounds: list[RoundAccount] = []
    for r in range(num_rounds):
        step_compute = float(np.max(durations[r]))
        sim += step_compute + step_comm
        comp_t += step_compute
        comm_t += step_comm
        bu += phase
        bd += phase
        rounds.append(RoundAccount(K, True, sim, bu, bd, comp_t, comm_t))
    return rounds


def lockstep_draw(draws, key, solver, problem, norms_sq, sigma_p: float, *,
                  num_steps: int, num_rounds: int):
    """Every visit order of ``num_rounds`` lockstep rounds, in the event
    engine's calls: per round one split of the chain, ``split(sub, K)``, the
    solver's draws. Returns ``(key, [orders (R, K, h) per solver slot])``."""
    K, n_k, _ = problem.X.shape
    per_round = []
    for _ in range(num_rounds):
        key, sub = draws.split(key, 2)
        keys = draws.split(sub, K)
        per_round.append(solver.draw(keys, draws, n_k=n_k, num_steps=num_steps,
                                     norms_sq=norms_sq, lam=problem.lam,
                                     n_global=problem.n, sigma_prime=sigma_p,
                                     device=problem.X.device))
    slots = [torch.stack([o[s] for o in per_round]) for s in range(len(per_round[0]))]
    return key, slots


def lockstep_body(problem, solver, *, length: int, n_slots: int = 0, evals=(),
                  gap: bool = False):
    """The lockstep rounds as a plain torch function of ``inputs``: ``w``,
    ``alpha`` (the carry), ``orders_<slot> (R, K, h)``, ``gamma``, ``sigma``
    (sigma', 0-dim float32, which the kernel reads per row), ``y``,
    ``norms_sq``, and ``eval_slot (R,)``: the snapshot row each round's
    ``(w, alpha)`` lands in (``n_slots`` rows and a discard row). With
    ``gap``, the eval rounds ``evals`` are fixed and carry the in-graph
    certificate with compute-and-mask (and ``gap_target``, see
    :func:`gap_floor_f32`)."""
    K, n_k, d = problem.X.shape
    X, lam, loss, n = problem.X, problem.lam, problem.loss, problem.n
    evals = set(evals)

    def fn(inp):
        w, alpha, gamma = inp["w"], inp["alpha"], inp["gamma"]
        y, norms_sq = inp["y"], inp["norms_sq"]
        sigma = inp["sigma"].expand(K).contiguous()
        slots = sorted(k for k in inp if k.startswith("orders_"))
        certs, dones = [], []
        done = torch.zeros((), dtype=torch.bool, device=X.device)
        if not gap:
            ws = _snapshot_buffer(n_slots, (d,), w)
            alphas = _snapshot_buffer(n_slots, (K, n_k), alpha)
        for r in range(length):
            orders = [inp[s][r] for s in slots]

            def solve(w_all, a):
                return solver.solve(orders, w_all, a, X, y, norms_sq, lam, n, sigma,
                                    loss=loss)

            w_new, alpha_new = engine.lockstep_round(w, alpha, gamma, solve)
            if gap:
                w = torch.where(done, w, w_new)
                alpha = torch.where(done, alpha, alpha_new)
                if r in evals:
                    p, dv, g, _, g_srv = objectives.certificate_tensors(X, y, lam, loss,
                                                                        alpha, w)
                    done = done | (g <= inp["gap_target"])
                    certs.append(torch.stack([p, dv, g, g_srv]))
                dones.append(done)
            else:
                w, alpha = w_new, alpha_new
                at = inp["eval_slot"][r:r + 1]
                ws.index_copy_(0, at, w[None])
                alphas.index_copy_(0, at, alpha[None])
        out = {"w": w, "alpha": alpha}
        if gap:
            out["certs"] = torch.stack(certs) if certs else torch.zeros((0, 4), device=X.device)
            out["done"] = torch.stack(dones)
        else:
            out["eval_ws"], out["eval_alphas"] = ws[:n_slots], alphas[:n_slots]
        return out

    return fn


def _lockstep_inputs(problem, method, norms_sq, draws, key, sigma_p, R, *, w=None,
                     alpha=None, evals=()):
    K, n_k, d = problem.X.shape
    dev, dt = problem.X.device, problem.X.dtype
    solver = lockstep_solver(method)
    key, slots = lockstep_draw(draws, key, solver, problem, norms_sq, sigma_p,
                               num_steps=method.H, num_rounds=R)
    inp = {"w": torch.zeros((d,), dtype=dt, device=dev) if w is None else w,
           "alpha": (torch.zeros((K, n_k), dtype=dt, device=dev) if alpha is None
                     else alpha),
           "gamma": host_input(method.gamma, torch.float32, dev),
           "sigma": host_input(sigma_p, torch.float32, dev),
           "eval_slot": _slot_input(R, evals, dev),
           "y": problem.y, "norms_sq": norms_sq}
    for s, o in enumerate(slots):
        inp[f"orders_{s}"] = o
    return key, solver, inp


def _lockstep_key(kind, problem, method, R, evals):
    return (kind, str(problem.X.device), tuple(problem.X.shape), problem.loss, method.H,
            solver_name(method), R, evals, lam_n_f32(problem.lam, problem.n))


def _run_lockstep(problem, method, cluster, *, num_outer, seed, eval_every, norms_sq,
                  draws, key) -> ScanRun:
    K, n_k, d = problem.X.shape
    R = num_outer
    if R == 0:
        return _empty(problem, method, applied=False)
    rounds = lockstep_accounts(method, cluster, d, num_rounds=R, seed=seed)
    sigma_p = method.resolved_sigma_prime(K)
    evals = _eval_indices(R, eval_every)
    n_slots = eval_slots(evals)
    _, solver, inp = _lockstep_inputs(problem, method, norms_sq, draws, key, sigma_p, R,
                                      evals=evals)
    run = _compiled(_lockstep_key("lockstep", problem, method, R, n_slots), [problem.X],
                    lambda: Graphed(lockstep_body(problem, solver, length=R,
                                                  n_slots=n_slots),
                                    problem.X.device, "lockstep",
                                    _prepare_kernel(problem, [K])))
    out = run(inp)
    E = len(evals)
    return ScanRun(method, rounds, evals, out["eval_ws"][:E], out["eval_alphas"][:E],
                   out["w"], out["alpha"])


def gap_floor_f32(target_gap: float) -> np.float32:
    """The largest float32 ``t`` with ``float(t) <= target_gap``: the graph's
    float32 test then decides as the event loop's float64 one does."""
    t = np.float32(target_gap)
    if float(t) > target_gap:
        t = np.nextafter(t, np.float32(-np.inf), dtype=np.float32)
    return t


def _run_lockstep_gap(problem, method, cluster, *, num_outer, seed, eval_every, norms_sq,
                      draws, key, target_gap) -> ScanRun:
    """Lockstep + target_gap: one graph with the certificates in it; the
    records are truncated at the stop boundary on the host."""
    K, n_k, d = problem.X.shape
    R = num_outer
    if R == 0:
        return dataclasses.replace(_empty(problem, method, applied=False),
                                   stream_records=[])
    rounds = lockstep_accounts(method, cluster, d, num_rounds=R, seed=seed)
    sigma_p = method.resolved_sigma_prime(K)
    evals = _eval_indices(R, eval_every)
    _, solver, inp = _lockstep_inputs(problem, method, norms_sq, draws, key, sigma_p, R)
    inp["gap_target"] = host_input(gap_floor_f32(target_gap), torch.float32,
                                   problem.X.device)
    run = _compiled(_lockstep_key("lockstep_gap", problem, method, R, tuple(evals)),
                    [problem.X],
                    lambda: Graphed(lockstep_body(problem, solver, length=R,
                                                  evals=evals, gap=True),
                                    problem.X.device, "lockstep_gap",
                                    _prepare_kernel(problem, [K])))
    out = run(inp)
    certs = out["certs"].double().cpu().numpy()
    done = out["done"].cpu().numpy()
    hit = bool(done.any())
    stop = int(np.argmax(done)) if hit else R - 1
    records = [_record(rounds[r], r, *certs[i]) for i, r in enumerate(evals) if r <= stop]
    return ScanRun(method, rounds[:stop + 1], [], None, None, out["w"], out["alpha"],
                   stop_reason="target_gap" if hit else "completed",
                   stream_records=records)


# ---------------------------------------------------------------------------
# The B-of-K queue on the device: lag and partial_work.
# ---------------------------------------------------------------------------


def lag_needs(method: MethodConfig, K: int, num_rounds: int) -> tuple[int, ...]:
    """Per-round arrival counts of a LAG run (B-of-K + T-periodic barrier)."""
    T = method.T
    return tuple(K if r % T == T - 1 else min(method.B, K) for r in range(num_rounds))


def lag_durations(method: MethodConfig, cluster: ClusterModel, *,
                  num_rounds: int, seed: int):
    """Pre-sample a LAG run's compute stream; returns (durations, delay).
    Row 0 feeds the t=0 launch wave, row 1+r round r's."""
    delay = cluster.make_delay()
    rng = np.random.default_rng(seed)
    durations = delay.sample_stream(num_rounds + 1, method.H, rng, lockstep=False)
    if durations is None:
        raise ValueError(
            f"delay model {cluster.delay_model!r} cannot pre-sample a "
            f"(round, worker) stream; use executor='event'")
    return durations, delay


def partial_durations(method: MethodConfig, cluster: ClusterModel, *,
                      num_rounds: int, seed: int):
    """Pre-sample a partial_work run's per-chunk compute stream: ``(durations
    (num_rounds + 1, C, K), delay)``."""
    steps = engine.chunk_steps(method.H, method.n_chunks)
    delay = cluster.make_delay()
    rng = np.random.default_rng(seed)
    durations = delay.sample_chunk_stream(num_rounds + 1, steps, rng)
    if durations is None:
        raise ValueError(
            f"delay model {cluster.delay_model!r} cannot pre-sample a "
            f"(round, chunk, worker) stream; use executor='event'")
    return durations, delay


def queue_draw(draws, key, problem, waves, chunk_steps):
    """Every visit order of a queue run, in the event engine's calls: per
    launch wave of ``B`` workers, ``B * C`` splits (worker-major), then one
    ``randint`` per chunk. Returns ``[orders (W, K, h_c) per chunk]``."""
    K, n_k, _ = problem.X.shape
    per_chunk = [[] for _ in chunk_steps]
    for B in waves:
        keys = []
        for _ in range(B):
            row = []
            for _ in chunk_steps:
                key, sub = draws.split(key, 2)
                row.append(sub)
            keys.append(row)
        for c, h in enumerate(chunk_steps):
            per_chunk[c].append(as_orders(draws.randint([ks[c] for ks in keys], n_k, h),
                                          problem.X.device))
    return [_stack_orders(w, K, problem.X.device) for w in per_chunk]


class QueueRun:
    """A lag or partial_work run on the device (the body of one graph).

    State lives in tensors: the model (``w_server``, ``dw_tilde``,
    ``w_local``, ``alpha``, ``alpha_applied``, ``residual``), each worker's
    in-flight chunks (``payload (K, C, d)``, ``snaps (K, C, n_k)``,
    ``arrival (K, C)`` float64, ``seq (K, C)``, ``harvested``), LAG's window
    and the accounting totals (float64 / int64 scalars). ``C`` is 1 for lag.
    The launch and server steps are the event engine's op sequences; the
    arrival counts and sequence numbers are host-known and fixed. sigma'
    (``inp["sigma"]``) is read by the kernel per row; each round's snapshot
    lands in row ``inp["eval_slot"][r]`` of ``n_slots`` rows (and a discard
    row).
    """

    def __init__(self, problem, method, inp, *, chunk_steps, needs, comp, lag: bool,
                 n_slots: int):
        K, n_k, d = problem.X.shape
        dev, dt = problem.X.device, problem.X.dtype
        f64, i64 = torch.float64, torch.int64
        C = len(chunk_steps)
        self.K, self.n_k, self.d, self.C = K, n_k, d, C
        self.problem = dataclasses.replace(problem, y=inp["y"])  # the graph's buffer
        self.norms_sq = inp["norms_sq"]
        self.inp = inp
        self.chunk_steps, self.needs, self.comp = chunk_steps, needs, comp
        self.lag, self.n_slots = lag, n_slots
        self.gamma, self.sigma = inp["gamma"], inp["sigma"]
        self.dense = isinstance(comp, compress_lib.Dense)
        self.up_bytes = comp.wire_bytes(d)
        self.w_server = torch.zeros((d,), dtype=dt, device=dev)
        self.dw_tilde = torch.zeros((K, d), dtype=dt, device=dev)
        self.w_local = torch.zeros((K, d), dtype=dt, device=dev)
        self.alpha = torch.zeros((K, n_k), dtype=dt, device=dev)
        self.alpha_applied = torch.zeros((K, n_k), dtype=dt, device=dev)
        self.residual = torch.zeros((K, d), dtype=dt, device=dev)
        self.payload = torch.zeros((K, C, d), dtype=dt, device=dev)
        self.snaps = torch.zeros((K, C, n_k), dtype=dt, device=dev)
        self.applied = torch.ones((K,), dtype=torch.bool, device=dev)
        self.arrival = torch.zeros((K, C), dtype=f64, device=dev)
        self.seq = torch.zeros((K, C), dtype=i64, device=dev)
        self.harvested = torch.zeros((K, C), dtype=torch.bool, device=dev)
        if lag:
            self.ref_buf = torch.zeros((K, method.lag_window), dtype=dt, device=dev)
            self.ref_len = torch.zeros((K,), dtype=torch.int32, device=dev)
        self.bytes_up = torch.zeros((), dtype=i64, device=dev)
        self.bytes_down = torch.zeros((), dtype=i64, device=dev)
        self.compute_t = torch.zeros((), dtype=f64, device=dev)
        self.comm_t = torch.zeros((), dtype=f64, device=dev)
        self.map_error = sdca_kernel.map_error_word(dev)
        self.seq_ctr = 0
        self.wave = 0
        self.trail: list = []
        self.eval_w = _snapshot_buffer(n_slots, (d,), self.w_server)
        self.eval_alpha = _snapshot_buffer(n_slots, (K, n_k), self.alpha)
        self._round = None

    # -- the launch wave ------------------------------------------------------

    def _link(self, widx, nbytes):
        """``p2p_time`` per rank: latency + bytes * f_k / bandwidth, float64."""
        inp = self.inp
        return inp["latency"] + nbytes.double() * inp["link_factors"].index_select(
            0, widx) / inp["bandwidth"]

    def launch(self, widx: torch.Tensor, B: int, starts, billing=None,
               solved=None) -> None:
        """Relaunch the workers ``widx`` (B ranks; ``starts`` float64):
        ``C`` kernel launches with the device worker map, then the
        accounting per rank in the host's order (reply billing, then per
        chunk compute and upload). ``solved``: the one chunk's
        ``engine.group_local_finish`` result when a sweep launched it."""
        wave, C = self.wave, self.C
        wmap = widx.to(torch.int32)
        res = self.residual.index_select(0, widx)
        skip = None
        for c, h in enumerate(self.chunk_steps):
            idx = self.inp[f"orders_{c}"][wave, :B]
            if solved is None:
                a_c, dw, sent, res = engine.group_local_rounds(
                    self.w_local, self.alpha, res, widx, wmap, idx, self.problem,
                    self.norms_sq, self.problem.n, self.sigma, self.gamma, self.comp,
                    map_error=self.map_error)
            else:
                a_c, dw, sent, res = solved
            if self.lag:
                sent, res, skip = engine.lag_skip(self.ref_buf, self.ref_len, widx,
                                                  self.inp["xi"], dw, sent, res)
            self.payload[:, c].index_copy_(0, widx, sent)
            self.snaps[:, c].index_copy_(0, widx, a_c)
        self.residual.index_copy_(0, widx, res)
        self.harvested.index_fill_(0, widx, False)
        if self.lag:
            self.applied.index_copy_(0, widx, ~skip)
            nbytes = self.up_bytes + (engine.LagProtocol.HEARTBEAT_BYTES
                                      - self.up_bytes) * skip.long()
        else:
            nbytes = torch.full((B,), self.up_bytes, dtype=torch.int64, device=widx.device)
        up_t = self._link(widx, nbytes)
        dur = self.inp["durations"][wave].reshape(C, self.K).index_select(1, widx)
        t = starts
        for c in range(C):
            t = t + dur[c]
            self.arrival[:, c].index_copy_(0, widx, t + up_t)
        base = self.seq_ctr + 1
        self.seq.index_copy_(0, widx, torch.arange(
            base, base + B * C, dtype=torch.int64, device=widx.device).view(B, C))
        self.seq_ctr += B * C
        for j in range(B):
            if billing is not None:
                self.comm_t = self.comm_t + billing[1][j]
            for c in range(C):
                self.compute_t = self.compute_t + dur[c, j]
                self.comm_t = self.comm_t + up_t[j]
        if billing is not None:
            self.bytes_down = self.bytes_down + billing[0].sum()
        self.bytes_up = self.bytes_up + nbytes.sum() * C
        self.wave += 1

    def first_wave(self):
        """The t=0 wave's ``(widx, B, starts, billing)``: every worker, in
        worker order, no reply."""
        dev = self.alpha.device
        widx = torch.arange(self.K, dtype=torch.int64, device=dev)
        return widx, self.K, torch.zeros((self.K,), dtype=torch.float64, device=dev), None

    # -- the server round -----------------------------------------------------

    def server(self, r: int):
        """Round ``r``'s server step (pop, fold in, reply, bill). Returns
        ``(widx, need, starts, billing)`` of the next wave and records the
        round's server time and harvested chunk count."""
        need, C = self.needs[r], self.C
        fin_a, fin_s = self.arrival[:, C - 1], self.seq[:, C - 1]
        perm = _lexsort(fin_a, fin_s)
        widx = perm[:need]
        last = perm[need - 1:need]
        server_time = fin_a.index_select(0, last)[0]
        if C == 1:
            # lag: the need earliest messages, in pop order.
            payloads = self.payload[:, 0].index_select(0, widx)
            self.w_server, self.dw_tilde = engine.aggregate(
                self.w_server, self.dw_tilde, payloads.unbind(0), self.gamma)
            self.alpha_applied = engine.apply_snapshots(
                self.alpha_applied, widx, self.snaps[:, 0].index_select(0, widx),
                self.applied.index_select(0, widx))
            count = None
        else:
            # partial_work: every pending chunk at or before the deadline key,
            # folded in global arrival order (where-masked: the host's sum).
            cut_s = fin_s.index_select(0, last)[0]
            take = ~self.harvested & ((self.arrival < server_time) | (
                (self.arrival == server_time) & (self.seq <= cut_s)))
            KC = self.K * C
            order = _lexsort(self.arrival.reshape(KC), self.seq.reshape(KC))
            take_sorted = take.reshape(KC).index_select(0, order)
            pays = self.payload.reshape(KC, self.d).index_select(0, order)
            self.w_server, self.dw_tilde = engine.aggregate_masked(
                self.w_server, self.dw_tilde, pays.unbind(0), take_sorted.unbind(0),
                self.gamma)
            any_k = take.any(dim=1)
            last_c = (C - 1) - torch.argmax(take.flip(1).to(torch.int32), dim=1)
            snap = self.snaps.gather(1, last_c[:, None, None].expand(
                self.K, 1, self.n_k))[:, 0]
            self.alpha_applied = torch.where(any_k[:, None], snap, self.alpha_applied)
            self.harvested = self.harvested | take
            count = take.sum()
        reply_sq, nnz = engine.reply(self.w_local, self.dw_tilde, widx)
        if self.lag:
            engine.lag_window_append(self.ref_buf, self.ref_len, widx, reply_sq)
        if self.dense:
            rbytes = torch.full((need,), self.d * 4, dtype=torch.int64, device=widx.device)
        else:
            rbytes = nnz.to(torch.int64) * 8
        down = self._link(widx, rbytes)
        self._round = (server_time, count)
        return widx, need, server_time + down, (rbytes, down)

    def record(self, r: int) -> None:
        """Keep round ``r``'s accounting totals and its snapshot (in its slot)
        after its wave launched."""
        server_time, count = self._round
        self.trail.append((server_time, self.bytes_up, self.bytes_down, self.compute_t,
                           self.comm_t, count))
        at = self.inp["eval_slot"][r:r + 1]
        self.eval_w.index_copy_(0, at, self.w_server[None])
        self.eval_alpha.index_copy_(0, at, self.alpha_applied[None])

    def run(self, R: int) -> dict[str, torch.Tensor]:
        self.launch(*self.first_wave())
        for r in range(R):
            self.launch(*self.server(r))
            self.record(r)
        return self.outputs()

    def outputs(self) -> dict[str, torch.Tensor]:
        sims, bus, bds, cts, cms, counts = zip(*self.trail)
        out = {"w": self.w_server, "alpha": self.alpha, "alpha_applied": self.alpha_applied,
               "sim": torch.stack(sims), "bytes_up": torch.stack(bus),
               "bytes_down": torch.stack(bds), "compute": torch.stack(cts),
               "comm": torch.stack(cms), "map_error": self.map_error,
               "eval_ws": self.eval_w[:self.n_slots],
               "eval_alphas": self.eval_alpha[:self.n_slots]}
        if counts[0] is not None:
            out["harvested"] = torch.stack(counts)
        return out


def queue_accounts(out, needs, T: int) -> list[RoundAccount]:
    """RoundAccounts from a queue run's per-round outputs (one pull each)."""
    sim = out["sim"].cpu().numpy()
    bu, bd = out["bytes_up"].cpu().numpy(), out["bytes_down"].cpu().numpy()
    ct, cm = out["compute"].cpu().numpy(), out["comm"].cpu().numpy()
    arrivals = (out["harvested"].cpu().numpy() if "harvested" in out
                else np.asarray(needs))
    return [RoundAccount(int(arrivals[r]), r % T == T - 1, float(sim[r]), int(bu[r]),
                         int(bd[r]), float(ct[r]), float(cm[r]))
            for r in range(len(needs))]


def queue_inputs(problem, method, cluster, norms_sq, draws, key, *, R, seed, needs,
                 chunk_steps, evals, xi=True):
    """The per-run inputs of a queue run (host work, before the graph)."""
    dev = problem.X.device
    K = problem.X.shape[0]
    if len(chunk_steps) == 1 and method.protocol == "lag":
        durations, delay = lag_durations(method, cluster, num_rounds=R, seed=seed)
    else:
        durations, delay = partial_durations(method, cluster, num_rounds=R, seed=seed)
    waves = (K,) + tuple(needs)
    f64, f32 = torch.float64, torch.float32
    inp = {"durations": host_input(np.reshape(durations, (R + 1, -1)), f64, dev),
           "link_factors": host_input(delay.link_factors(), f64, dev),
           "latency": host_input(cluster.latency, f64, dev),
           "bandwidth": host_input(cluster.bandwidth, f64, dev),
           "gamma": host_input(method.gamma, f32, dev),
           "sigma": host_input(method.resolved_sigma_prime(K), f32, dev),
           "eval_slot": _slot_input(R, evals, dev),
           "y": problem.y, "norms_sq": norms_sq}
    if xi:
        inp["xi"] = host_input(method.lag_xi, f32, dev)
    for c, o in enumerate(queue_draw(draws, key, problem, waves, chunk_steps)):
        inp[f"orders_{c}"] = o
    return inp


def _queue_key(kind, problem, method, comp, needs, n_slots, chunk_steps):
    return (kind, str(problem.X.device), tuple(problem.X.shape), problem.loss,
            chunk_steps, comp, needs, n_slots, method.lag_window,
            lam_n_f32(problem.lam, problem.n))


def _run_queue(problem, method, cluster, *, num_outer, seed, eval_every, norms_sq,
               draws, key, lag: bool) -> ScanRun:
    K, n_k, d = problem.X.shape
    T = method.T
    R = num_outer * T
    if R == 0:
        return _empty(problem, method, applied=True)
    chunk_steps = ((method.H,) if lag else engine.chunk_steps(method.H, method.n_chunks))
    needs = lag_needs(method, K, R)
    comp = compress_lib.for_method(method, d)
    evals = _eval_indices(R, eval_every)
    n_slots = eval_slots(evals)
    inp = queue_inputs(problem, method, cluster, norms_sq, draws, key, R=R, seed=seed,
                       needs=needs, chunk_steps=chunk_steps, evals=evals, xi=lag)
    stat = "lag" if lag else "partial"

    def body(inp):
        return QueueRun(problem, method, inp, chunk_steps=chunk_steps, needs=needs,
                        comp=comp, lag=lag, n_slots=n_slots).run(R)

    run = _compiled(_queue_key(stat, problem, method, comp, needs, n_slots, chunk_steps),
                    [problem.X],
                    lambda: Graphed(body, problem.X.device, stat,
                                    _prepare_kernel(problem, (K,) + needs)))
    out = run(inp)
    sdca_kernel.raise_map_error(out["map_error"].cpu(), K)
    rounds = queue_accounts(out, needs, T)
    E = len(evals)
    return ScanRun(method, rounds, evals, out["eval_ws"][:E], out["eval_alphas"][:E],
                   out["w"], out["alpha"], alpha_applied=out["alpha_applied"])


# ---------------------------------------------------------------------------
# Divergence certificates + checkpointed lockstep runs.
# ---------------------------------------------------------------------------


def finite_certificates(variants) -> np.ndarray:
    """Per-cell finiteness of sweep results' final ``(w, alpha)``: one
    reduction over the stacked cells, so a NaN-poisoned cell is reported on
    its own instead of failing the whole batch."""
    ws = torch.stack([torch.as_tensor(v.result.w) for v in variants])
    alphas = torch.stack([torch.as_tensor(v.result.alpha) for v in variants])
    fw = torch.isfinite(ws).reshape(ws.shape[0], -1).all(dim=1)
    fa = torch.isfinite(alphas).reshape(alphas.shape[0], -1).all(dim=1)
    return (fw & fa).numpy()


def checkpoint_supported(method: MethodConfig, cluster: ClusterModel, *,
                         target_gap: float | None = None,
                         time_budget: float | None = None) -> tuple[bool, str]:
    """Can this run checkpoint/resume bit-identically? (ok, why-not).

    Checkpointed runs execute as fixed-length lockstep segments
    (:func:`run_lockstep_checkpointed`).
    """
    if method.exact_dual_feedback:
        return False, ("exact_dual_feedback needs a host lstsq per round "
                       "(reference path only)")
    if target_gap is not None or time_budget is not None:
        return False, ("early stop (target_gap/time_budget) makes the "
                       "checkpoint boundary data-dependent; run without a "
                       "stop target to checkpoint")
    if method.protocol not in LOCKSTEP_PROTOCOLS:
        return False, (
            f"checkpoint segments scan from a (key, w, alpha) carry, which "
            f"only the lockstep protocols {LOCKSTEP_PROTOCOLS} expose; "
            f"{method.protocol!r} threads whole-run operand streams")
    return True, ""


def checkpoint_run_id(problem, method: MethodConfig, cluster: ClusterModel,
                      *, seed: int, num_outer: int, eval_every: int) -> str:
    """Stable per-run subdirectory name: a digest of everything that shapes
    the run's trajectory (resuming another configuration would splice two
    runs; the id check makes that loud)."""
    sig = (dataclasses.asdict(method), dataclasses.asdict(cluster),
           tuple(problem.X.shape), str(problem.X.dtype).removeprefix("torch."),
           problem.loss, float(problem.lam), int(seed), int(num_outer), int(eval_every))
    return f"run_{zlib.crc32(repr(sig).encode()):08x}"


def checkpoint_manifest(checkpoint_dir, run_id: str) -> dict | None:
    """The latest durable snapshot manifest of run ``run_id``, or ``None``,
    read from the json sidecar alone (written before its ``.npz``)."""
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    cdir = pathlib.Path(checkpoint_dir) / run_id
    latest = ckpt_lib.latest_step(cdir)
    if latest is None:
        return None
    try:
        manifest = json.loads((cdir / f"ckpt_{latest:08d}.json").read_text())
    except (OSError, ValueError):
        return None
    extra = dict(manifest.get("extra", {}))
    extra.setdefault("run", run_id)
    extra.setdefault("round", int(manifest.get("step", latest)))
    extra["path"] = str(cdir)
    return extra


def run_lockstep_checkpointed(problem, method: MethodConfig, cluster: ClusterModel, *,
                              num_outer: int, seed: int, eval_every: int,
                              checkpoint_dir, checkpoint_every: int, norms_sq=None,
                              segment_hook=None, draws=None, key=None) -> ScanRun:
    """A lockstep run executed in resumable segments of ``checkpoint_every``
    rounds, the carry saved after every segment.

    After each segment the draw source's position, ``w``, ``alpha`` and the
    eval-boundary snapshots so far land in
    ``checkpoint_dir/<run id>/ckpt_<round>.npz``; the same call after a kill
    resumes from the latest snapshot and runs only the remaining segments.
    Segments chain the carry exactly and the accounting is recomputed from
    ``seed``, so the result equals the unbroken run bit for bit.
    ``segment_hook(start_round)`` is called before each segment (a hook
    that raises kills the run after the previous segment's checkpoint was
    written). The draw source must be able to ``save`` its position
    (``TorchDraws``).
    """
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    ok, why = checkpoint_supported(method, cluster)
    if not ok:
        raise ValueError(f"run cannot checkpoint: {why}")
    from repro_torch.checkpoint import checkpoint as ckpt_lib

    if norms_sq is None:
        norms_sq = torch.sum(problem.X * problem.X, dim=-1)
    if draws is None:
        draws, key = _draws_for(None, seed, problem.X.device)
    if not (hasattr(draws, "save") and hasattr(draws, "restore")):
        raise ValueError(f"a checkpointed run saves its draw source's position; "
                         f"{type(draws).__name__} has no save/restore (use TorchDraws)")
    K, n_k, d = problem.X.shape
    dt, dev = problem.X.dtype, problem.X.device
    R = num_outer
    if R == 0:
        return _empty(problem, method, applied=False)
    run_id = checkpoint_run_id(problem, method, cluster, seed=seed, num_outer=R,
                               eval_every=eval_every)
    cdir = pathlib.Path(checkpoint_dir) / run_id
    evals = _eval_indices(R, eval_every)
    rounds = lockstep_accounts(method, cluster, d, num_rounds=R, seed=seed)
    sigma_p = method.resolved_sigma_prime(K)
    w = torch.zeros((d,), dtype=dt, device=dev)
    alpha = torch.zeros((K, n_k), dtype=dt, device=dev)
    snap_ws: list = []
    snap_alphas: list = []
    start = 0

    latest = ckpt_lib.latest_step(cdir)
    if latest is not None:
        if not 0 < latest <= R:
            raise ValueError(f"checkpoint at round {latest} is outside this run's "
                             f"budget of {R} rounds ({cdir})")
        n_done = sum(1 for e in evals if e < latest)
        reference = {"key": draws.save(key), "w": w, "alpha": alpha,
                     "eval_ws": np.zeros((n_done, d), np.float32),
                     "eval_alphas": np.zeros((n_done, K, n_k), np.float32)}
        tree, extra = ckpt_lib.load_checkpoint(cdir, reference, latest, device=dev)
        if extra.get("run") != run_id or extra.get("round") != latest:
            raise ValueError(
                f"checkpoint manifest under {cdir} does not match this run "
                f"(expected run={run_id!r} round={latest}, got "
                f"run={extra.get('run')!r} round={extra.get('round')!r})")
        key = draws.restore(tree["key"].cpu().numpy())
        w, alpha = tree["w"], tree["alpha"]
        if n_done:
            snap_ws.append(tree["eval_ws"])
            snap_alphas.append(tree["eval_alphas"])
        start = latest

    def stacked():
        if not snap_ws:
            return (torch.zeros((0, d), dtype=dt, device=dev),
                    torch.zeros((0, K, n_k), dtype=dt, device=dev))
        return torch.cat(snap_ws), torch.cat(snap_alphas)

    while start < R:
        if segment_hook is not None:
            segment_hook(start)
        length = min(checkpoint_every, R - start)
        seg_evals = [e - start for e in evals if start <= e < start + length]
        # A segment keeps every round's state, so segments of one length share
        # a graph whatever their eval rounds; the snapshots are picked after.
        every = list(range(length))
        key, solver, inp = _lockstep_inputs(problem, method, norms_sq, draws, key, sigma_p,
                                            length, w=w, alpha=alpha, evals=every)
        n_slots = eval_slots(every)
        run = _compiled(_lockstep_key("lockstep_segment", problem, method, length,
                                      n_slots), [problem.X],
                        lambda: Graphed(lockstep_body(problem, solver, length=length,
                                                      n_slots=n_slots),
                                        dev, "lockstep_segment",
                                        _prepare_kernel(problem, [K])))
        out = run(inp)
        w, alpha = out["w"], out["alpha"]
        if seg_evals:
            pick = torch.tensor(seg_evals, dtype=torch.int64, device=dev)
            snap_ws.append(out["eval_ws"].index_select(0, pick))
            snap_alphas.append(out["eval_alphas"].index_select(0, pick))
        start += length
        eval_ws, eval_alphas = stacked()
        ckpt_lib.save_checkpoint(
            cdir, start,
            {"key": draws.save(key), "w": w, "alpha": alpha, "eval_ws": eval_ws,
             "eval_alphas": eval_alphas},
            extra={"run": run_id, "round": start, "seed": int(seed),
                   "num_outer": int(R), "eval_every": int(eval_every),
                   "sim_time": rounds[start - 1].sim_time})

    eval_ws, eval_alphas = stacked()
    if not evals:
        eval_ws = eval_alphas = None
    return ScanRun(method, rounds, evals, eval_ws, eval_alphas, w, alpha)
