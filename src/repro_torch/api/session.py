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

Not here yet: the scan executor (``executor="scan"``, ROADMAP A4),
checkpointed segments (``checkpoint_dir``/``checkpoint_every``, ROADMAP A6)
and ``Experiment``, which waits for ``api/spec.py`` (ROADMAP A3).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator

import torch

from repro_torch.core import compress as compress_lib
from repro_torch.core import engine, objectives
from repro_torch.core import solvers as solvers_lib
from repro_torch.core.acpd import MethodConfig, RunRecord, RunResult
from repro_torch.core.simulate import ClusterModel
from repro_torch.device import resolve_device

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

    ``executor``: ``"event"`` runs the per-round priority-queue loop.
    ``"auto"`` resolves to ``"event"`` until the scan executor is ported;
    ``"scan"`` raises ``NotImplementedError`` (ROADMAP A4), and so do the
    checkpoint arguments (ROADMAP A6).

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
                 draws=None, device: str | torch.device | None = None):
        if checkpoint_dir is not None or checkpoint_every is not None:
            raise NotImplementedError(
                "checkpointed sessions are not ported yet (ROADMAP A6: "
                "checkpoint, faults and serve layer)")
        if target_gap is not None:
            eval_mode = "stream"  # gap early-stop needs live certificates
        if eval_mode not in ("batched", "replay", "stream"):
            raise ValueError(f"unknown eval_mode {eval_mode!r}")
        if executor not in ("auto", "event", "scan"):
            raise ValueError(f"unknown executor {executor!r}; expected "
                             f"'auto', 'event' or 'scan'")
        if executor == "scan":
            raise NotImplementedError(
                "executor='scan' is not ported yet (ROADMAP A4: whole-run "
                "executor); use executor='event' or 'auto'")
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
        self.proto = engine.get_protocol(method.protocol)(
            problem, method, cluster, seed=seed, draws=draws)
        self.executor = "event"
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
            records = engine._materialize_records(snaps, self.problem,
                                                  self.eval_mode)
            for rec in records:
                yield EvalEvent(**dataclasses.asdict(rec))
        self._result = proto.finalize(records)
        yield StopEvent(reason=reason, iteration=iteration,
                        sim_time=proto.sim_time)
