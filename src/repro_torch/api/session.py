"""Streaming run sessions: the engine's round loop as a typed event stream.

PyTorch counterpart of ``repro.api.session``. A :class:`Session` owns the
priority-queue event loop of the protocol engine
(:mod:`repro_torch.core.engine`) and yields typed events as the simulation
advances:

* :class:`RoundEvent` -- one server round applied: live sim-clock and
  byte/time accounting;
* :class:`SyncEvent`  -- the round was a full-K barrier (the T-periodic sync
  for the group family, every round for the CoCoA lineage);
* :class:`EvalEvent`  -- a duality-gap certificate (streamed per eval
  boundary in ``eval_mode="stream"``, or emitted in one deferred batch after
  the loop in the ``"batched"``/``"replay"`` modes);
* :class:`StopEvent`  -- why the session ended (``completed``,
  ``target_gap``, or ``time_budget``).

Early stop: ``target_gap`` stops once the streamed gap reaches the target
(forces ``eval_mode="stream"``); ``time_budget`` stops once the simulated
clock passes the budget. ``repro_torch.core.acpd.run_method`` drains the
stream and returns its ``RunResult``.

Two backends produce the same stream: the event loop, and the whole-run
executor (:mod:`repro_torch.core.executor`: one captured CUDA graph per run
on the card), which runs first and then replays the identical events from
its accounting. :class:`Experiment` binds an
:class:`repro_torch.api.spec.ExperimentSpec` to its problem.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator

import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine, objectives
from repro_torch.core import executor as executor_lib
from repro_torch.core import solvers as solvers_lib
from repro_torch.core.acpd import MethodConfig, RunRecord, RunResult
from repro_torch.core.simulate import ClusterModel
from repro_torch.device import resolve_device
from repro_torch.tracing import span

# ---------------------------------------------------------------------------
# Events.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundEvent:
    """One server round applied; accounting totals as of this round."""

    iteration: int
    sim_time: float
    arrivals: int
    bytes_up: int
    bytes_down: int
    compute_time: float
    comm_time: float


@dataclasses.dataclass(frozen=True)
class SyncEvent:
    """The round just applied was a full-K barrier."""

    iteration: int
    sim_time: float


@dataclasses.dataclass(frozen=True)
class EvalEvent:
    """A duality-gap certificate at an eval boundary (mirrors RunRecord)."""

    iteration: int
    sim_time: float
    gap: float
    gap_server: float
    primal: float
    dual: float
    bytes_up: int
    bytes_down: int
    compute_time: float
    comm_time: float

    def to_record(self) -> RunRecord:
        return RunRecord(**dataclasses.asdict(self))


@dataclasses.dataclass(frozen=True)
class StopEvent:
    """The session ended: ``completed`` | ``target_gap`` | ``time_budget``."""

    reason: str
    iteration: int
    sim_time: float


SessionEvent = RoundEvent | SyncEvent | EvalEvent | StopEvent


# ---------------------------------------------------------------------------
# The session.
# ---------------------------------------------------------------------------


class Session:
    """A streaming run of one method through the protocol engine.

    Iterate :meth:`events` (or the session itself) for live consumption, or
    call :meth:`run` to drain and get the folded :class:`RunResult`.

    ``eval_mode``:

    * ``"batched"`` (default) -- gap certificates deferred to after the loop,
      all snapshots scored by two float32 passes over ``X``; ``EvalEvent``\\ s
      arrive at the end. Within float32 rounding of ``"replay"``.
    * ``"replay"``  -- deferred, one ``gap_certificate`` per snapshot (the
      reference loops' ops).
    * ``"stream"``  -- certificates computed at each eval boundary and
      streamed live; required for (and implied by) ``target_gap``.

    ``executor``:

    * ``"auto"`` (default) -- the whole-run executor whenever the run
      qualifies (``executor.scan_supported``: the lockstep protocols always,
      with a ``target_gap`` up to ``executor.GAP_SCAN_AUTO_MAX_ROUNDS``
      rounds; ``lag`` and ``partial_work`` when the delay stream can be
      pre-sampled; never with ``time_budget``), the event loop otherwise.
      Both give the same results bit for bit.
    * ``"event"`` -- force the per-round priority-queue loop.
    * ``"scan"``  -- force the whole-run executor; ``ValueError`` with the
      reason when the run cannot.

    ``checkpoint_dir``/``checkpoint_every`` (together or not at all) run a
    lockstep run as resumable segments on the executor
    (``executor.run_lockstep_checkpointed``).

    ``device``: where the run computes, CUDA unless given; the problem must
    live there. ``draws``: the source of the device-side random draws
    (``repro_torch.core.sdca.TorchDraws(seed)`` on that device by default).
    """

    def __init__(self, problem: objectives.Problem, method: MethodConfig,
                 cluster: ClusterModel, *, num_outer: int, seed: int = 0,
                 eval_every: int = 1, eval_mode: str = "batched",
                 target_gap: float | None = None,
                 time_budget: float | None = None,
                 executor: str = "auto",
                 checkpoint_dir=None, checkpoint_every: int | None = None,
                 draws=None, device: str | torch.device | None = None,
                 _segment_hook=None):
        if (checkpoint_every is None) != (checkpoint_dir is None):
            raise ValueError("checkpoint_dir and checkpoint_every come "
                             "together: set both or neither")
        if checkpoint_every is not None:
            if checkpoint_every < 1:
                raise ValueError(
                    f"checkpoint_every must be >= 1, got {checkpoint_every}")
            ok, why = executor_lib.checkpoint_supported(
                method, cluster, target_gap=target_gap, time_budget=time_budget)
            if not ok:
                raise ValueError(f"run cannot checkpoint: {why}")
            executor = "scan"  # segments run on the whole-run executor
        if target_gap is not None:
            eval_mode = "stream"  # gap early-stop needs live certificates
        if eval_mode not in ("batched", "replay", "stream"):
            raise ValueError(f"unknown eval_mode {eval_mode!r}")
        if executor not in ("auto", "event", "scan"):
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"'auto', 'event' or 'scan'")
        dev = resolve_device(device)
        if problem.X.device != dev:
            raise ValueError(f"the problem lives on {problem.X.device}, the run was "
                             f"asked for {dev}; build the problem on {dev}")
        # Resolve names the run might otherwise check late or never: the
        # sync protocols ignore the compressor, and only the CoCoA lineage
        # resolves the local solver.
        if method.compressor is not None:
            compress_lib.get_compressor(method.compressor)
        solvers_lib.get_solver(method.local_solver)
        # The protocol instance is built for both executors: its __init__
        # carries the per-protocol validation, and its untouched draw source
        # and key are what the whole-run executor draws from.
        with span("session.setup"):
            self.proto = engine.get_protocol(method.protocol)(
                problem, method, cluster, seed=seed, draws=draws)
        ok, why = executor_lib.scan_supported(
            method, cluster, eval_mode=eval_mode, target_gap=target_gap,
            time_budget=time_budget)
        if executor == "scan" and not ok:
            raise ValueError(f"executor='scan' cannot run this spec: {why}")
        # auto + target_gap: the gap run computes masked rounds to the end of
        # the budget, so past GAP_SCAN_AUTO_MAX_ROUNDS the event loop's
        # stop-at-the-hit wins; executor="scan" still forces it.
        auto_ok = ok and not (target_gap is not None
                              and num_outer > executor_lib.GAP_SCAN_AUTO_MAX_ROUNDS)
        self.executor = ("scan" if executor == "scan" or (executor == "auto" and auto_ok)
                         else "event")
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self._segment_hook = _segment_hook
        self.problem = problem
        self.method = method
        self.cluster = cluster
        self.seed = seed
        self.num_outer = num_outer
        self.eval_every = eval_every
        self.eval_mode = eval_mode
        self.target_gap = target_gap
        self.time_budget = time_budget
        self._result: RunResult | None = None
        self._events: Iterator[SessionEvent] | None = None

    # -- streaming ---------------------------------------------------------

    def events(self) -> Iterator[SessionEvent]:
        """The event stream. Single-use; created lazily on first call."""
        if self._events is None:
            self._events = self._generate()
        return self._events

    def __iter__(self) -> Iterator[SessionEvent]:
        return self.events()

    def run(self) -> RunResult:
        """Drain the stream and return the folded RunResult."""
        with span("session.run"):
            for _ in self.events():
                pass
            return self.result()

    def result(self) -> RunResult:
        if self._result is None:
            raise RuntimeError("session not finished; drain events() or call "
                               "run() first")
        return self._result

    # -- the loop ----------------------------------------------------------

    def _eval_stream(self, snap) -> EvalEvent:
        cert = objectives.gap_certificate(self.problem, snap.alpha, w=snap.w)
        return EvalEvent(
            iteration=snap.iteration, sim_time=snap.sim_time,
            gap=cert["gap"], gap_server=cert["gap_server"],
            primal=cert["primal"], dual=cert["dual"],
            bytes_up=snap.bytes_up, bytes_down=snap.bytes_down,
            compute_time=snap.compute_time, comm_time=snap.comm_time)

    def _generate(self) -> Iterator[SessionEvent]:
        if self.executor == "scan":
            yield from self._generate_scan()
            return
        proto = self.proto
        queue: list[engine.Message] = []
        for msg in proto.initial_messages():
            heapq.heappush(queue, msg)

        snaps = []  # deferred-eval snapshots ("batched"/"replay")
        records: list[RunRecord] = []  # streamed records ("stream")
        streaming = self.eval_mode == "stream"
        iteration = 0
        reason = "completed"

        for r in range(proto.num_rounds(self.num_outer)):
            with span("engine.round"):  # closed before the round's events
                need = proto.arrivals_needed(r)
                arrived = [heapq.heappop(queue) for _ in range(need)]
                for msg in proto.process_round(r, arrived):
                    heapq.heappush(queue, msg)
            iteration += 1

            yield RoundEvent(
                iteration=iteration, sim_time=proto.sim_time,
                arrivals=len(arrived), bytes_up=proto.bytes_up,
                bytes_down=proto.bytes_down, compute_time=proto.compute_time,
                comm_time=proto.comm_time)
            if proto.is_sync_round(r):
                yield SyncEvent(iteration=iteration, sim_time=proto.sim_time)

            evaluated = iteration % self.eval_every == 0
            if evaluated:
                snap = proto.snapshot(iteration)
                if streaming:
                    ev = self._eval_stream(snap)
                    records.append(ev.to_record())
                    yield ev
                    if (self.target_gap is not None
                            and ev.gap <= self.target_gap):
                        reason = "target_gap"
                        break
                else:
                    snaps.append(snap)

            if (self.time_budget is not None
                    and proto.sim_time >= self.time_budget):
                reason = "time_budget"
                if not evaluated:
                    # Terminal certificate so the result reflects the state
                    # at the stop point.
                    snap = proto.snapshot(iteration)
                    if streaming:
                        ev = self._eval_stream(snap)
                        records.append(ev.to_record())
                        yield ev
                    else:
                        snaps.append(snap)
                break

        if not streaming:
            with span("engine.eval", timed=True):
                records = engine._materialize_records(snaps, self.problem,
                                                      self.eval_mode)
            for rec in records:
                yield EvalEvent(**dataclasses.asdict(rec))
        self._result = proto.finalize(records)
        yield StopEvent(reason=reason, iteration=iteration,
                        sim_time=proto.sim_time)

    def _generate_scan(self) -> Iterator[SessionEvent]:
        """The whole-run executor's stream: the run executes first, then the
        identical event sequence is replayed from its per-round accounting
        (``EvalEvent``\\ s interleaved at their boundaries for a
        ``target_gap`` run, at the end otherwise, as the event loop does)."""
        kw = dict(num_outer=self.num_outer, seed=self.seed, eval_every=self.eval_every,
                  norms_sq=self.proto.norms_sq, draws=self.proto.draws,
                  key=self.proto.key)
        if self.checkpoint_every is not None:
            run = executor_lib.run_lockstep_checkpointed(
                self.problem, self.method, self.cluster,
                checkpoint_dir=self.checkpoint_dir,
                checkpoint_every=self.checkpoint_every,
                segment_hook=self._segment_hook, **kw)
        else:
            run = executor_lib.run_scan(self.problem, self.method, self.cluster,
                                        target_gap=self.target_gap, **kw)
        records = run.materialize_records(self.problem, self.eval_mode)
        streaming = self.eval_mode == "stream"
        rec_iter = iter(records)
        iteration = 0
        for acct in run.rounds:
            iteration += 1
            yield RoundEvent(
                iteration=iteration, sim_time=acct.sim_time,
                arrivals=acct.arrivals, bytes_up=acct.bytes_up,
                bytes_down=acct.bytes_down, compute_time=acct.compute_time,
                comm_time=acct.comm_time)
            if acct.is_sync:
                yield SyncEvent(iteration=iteration, sim_time=acct.sim_time)
            if streaming and iteration % self.eval_every == 0:
                yield EvalEvent(**dataclasses.asdict(next(rec_iter)))
        if not streaming:
            for rec in records:
                yield EvalEvent(**dataclasses.asdict(rec))
        self._result = run.finalize(records)
        yield StopEvent(reason=run.stop_reason, iteration=iteration,
                        sim_time=run.rounds[-1].sim_time if run.rounds else 0.0)


# ---------------------------------------------------------------------------
# Spec-level execution.
# ---------------------------------------------------------------------------


class Experiment:
    """An :class:`repro_torch.api.spec.ExperimentSpec` bound to its built
    problem, on the session's device (CUDA unless ``device`` names another).

    Builds the dataset once; hands out one :class:`Session` per method entry.
    """

    def __init__(self, spec, *, checkpoint_dir=None,
                 device: str | torch.device | None = None):
        if spec.checkpoint_every is not None and checkpoint_dir is None:
            raise ValueError(
                "spec sets checkpoint_every: pass checkpoint_dir to "
                "Experiment (where should the snapshots live?)")
        self.spec = spec
        self.device = resolve_device(device)
        self.problem = spec.problem.build(device=self.device)
        self.cluster = spec.cluster
        self.checkpoint_dir = checkpoint_dir

    def session(self, entry, *, eval_mode: str | None = None,
                executor: str | None = None, _segment_hook=None) -> Session:
        spec = self.spec
        if entry.config.exact_dual_feedback:
            raise ValueError(
                "exact_dual_feedback runs on the reference path (host lstsq "
                "per round) and cannot stream; use "
                "repro_torch.core.acpd.run_method")
        if eval_mode is None:
            eval_mode = "stream" if spec.target_gap is not None else "batched"
        ckpt_every = spec.checkpoint_every
        return Session(self.problem, entry.config, self.cluster,
                       num_outer=entry.num_outer, seed=spec.seed,
                       eval_every=spec.eval_every, eval_mode=eval_mode,
                       target_gap=spec.target_gap, time_budget=spec.time_budget,
                       executor=spec.executor if executor is None else executor,
                       checkpoint_dir=(self.checkpoint_dir
                                       if ckpt_every is not None else None),
                       checkpoint_every=ckpt_every, device=self.device,
                       _segment_hook=_segment_hook)

    def run_entry(self, entry) -> RunResult:
        if entry.config.exact_dual_feedback:
            from repro_torch.core.acpd import run_method

            return run_method(self.problem, entry.config, self.cluster,
                              num_outer=entry.num_outer, seed=self.spec.seed,
                              eval_every=self.spec.eval_every, device=self.device)
        return self.session(entry).run()

    def run(self) -> dict[str, RunResult]:
        """Run every method entry; keyed by ``MethodConfig.name``."""
        return {entry.config.name: self.run_entry(entry)
                for entry in self.spec.methods}
