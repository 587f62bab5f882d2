"""Pluggable fault-injection models: the chaos axis of the serve layer.

PyTorch port's copy of ``repro.core.faults``: the same registry entries,
typed faults and parameters, and the same decisions bit for bit (numpy
generators seeded from ``zlib.crc32`` digests); it lives here because
importing the JAX package's module pulls in JAX.

The paper's claim is straggler *agnosticism* (arXiv:1910.04235), and the
delay registry (:mod:`repro_torch.core.delays`) covers the slow-worker half of
that story.  This module covers the broken-worker half: a ``FaultModel`` is
a seeded, deterministic, spec-round-trippable schedule of injected failures
that the multi-tenant experiment service (:mod:`repro_torch.serve`) consults at
every dispatch, so the recovery machinery -- quarantine-and-bisect retry,
execution deadlines, the per-key circuit breaker, divergence masking and
checkpoint/resume (:mod:`repro_torch.serve.recovery`) -- can be exercised and
benchmarked under a *pinned* fault schedule instead of ad-hoc monkeypatching.

A fault model answers two questions:

* ``on_dispatch(kind, key, attempt)`` -- called immediately before the
  service executes work. ``kind`` is the lane (``"batch"`` for a coalesced
  cohort, ``"solo"`` for a per-request Session, ``"segment"`` for one
  checkpoint segment of a resumable run, where ``attempt`` is the 0-based
  starting round of the segment), ``key`` is a stable hashable identity for
  the work (the coalescer's batch key, or a per-request tuple), ``attempt``
  the 0-based retry count.  The model may **raise** a typed
  :class:`InjectedFault` (crash / transient error / compile failure) or
  **sleep** (slow-batch overrun); returning normally means no fault.
* ``poison_cells(n_cells, key)`` -- which cell indices of a coalesced batch
  get a NaN-poisoned operand (the service substitutes ``gamma = NaN`` for
  those cells, so divergence is *real* in the compiled run and the per-cell
  finite certificates must genuinely catch it).  Must be attempt-stable:
  the poison travels with the request, not with the retry.

Registry entries:

* ``none``               -- the default: never faults.
* ``transient_executor`` -- the first ``failures`` attempts of every batch
  raise :class:`TransientExecutorError` (transient: the service retries the
  whole cohort with exponential backoff + deterministic jitter).
* ``worker_crash``       -- a worker process dies mid-batch: the first
  ``crashes`` attempts of every batch raise :class:`WorkerCrashError`
  (transient); with ``crash_round`` set, a checkpointed solo run is killed
  at that segment boundary (persistent for that run -- the tenant resubmits
  and the run resumes from the last checkpoint, bit-identically).
* ``compile_failure``    -- every attempt of every batch raises
  :class:`CompileFailureError` (persistent: retries cannot help, so
  repeated failures on one batch key open the circuit breaker).
* ``nan_poison``         -- ``count`` deterministic cells per batch get a
  NaN gamma; the run itself succeeds and the per-cell finite certificates
  isolate exactly the poisoned tenants.
* ``slow_batch``         -- the first ``slow_attempts`` attempts of every
  batch sleep ``delay_s`` seconds before executing, tripping the service's
  execution deadline (typed ``JobTimeoutError`` + solo-lane requeue).
* ``chaos``              -- the pinned composite schedule the chaos bench
  drives: per process-order dispatch index, one deadline overrun, one
  transient fault, and one NaN-poisoned cell (stateful like ``markov``:
  build a fresh instance per service run; reproducible from ``seed`` +
  submission order alone).

**The network-fault family** (the cluster-transport seam,
:mod:`repro_torch.serve.cluster`): replicated serving moves messages -- job
records, heartbeats, result records -- between processes through a shared
cluster directory, and these entries decide each message's fate
(:meth:`FaultModel.message_fate`) and each replica's fate
(:meth:`FaultModel.replica_fate` / :meth:`FaultModel.segment_fate`)
deterministically, so every cross-process chaos scenario replays exactly:

* ``net_drop``      -- each selected message is dropped (never written);
  senders re-send, so progress relies on at-least-once retry + idempotent
  delivery, which is exactly what the cluster tests pin.
* ``net_duplicate`` -- each selected message is delivered twice; receivers
  must dedupe (exactly-once via idempotent job keys).
* ``net_reorder``   -- each selected message is held for one transport tick,
  so the NEXT message overtakes it.
* ``net_delay``     -- each selected message is held for ``ticks`` transport
  ticks before delivery.
* ``net_partition`` -- the named replica is unreachable (reads nothing,
  its writes are dropped) for a tick window.
* ``replica_kill``  -- the named replica dies abruptly: after ``after_steps``
  scheduler steps, or mid-run at checkpoint-segment ``at_segment`` (a true
  SIGKILL in subprocess replicas; an uncatchable control-flow kill
  in-process).  Leases and heartbeats are left behind un-released -- crash
  semantics, which is the point.
* ``cluster_chaos`` -- the pinned composite the cluster bench and
  ``make cluster-smoke`` drive: one replica killed + seeded message drop.

Determinism: models never consult wall-clock or global RNG state -- every
decision is a pure function of ``(seed, key, attempt)`` (plus an explicit
per-instance dispatch counter for ``chaos``), with key identity reduced via
``zlib.crc32`` (Python's ``hash()`` is salted per process and would break
cross-run reproducibility).  Network-fault decisions are keyed on
``(seed, message kind, message key, send sequence number)`` so a re-sent
message is a NEW draw -- a dropped result is not dropped forever.

Extending: subclass :class:`FaultModel`, decorate with
:func:`register_fault`, accept parameters as JSON-scalar keyword arguments
(they round-trip through :meth:`FaultModel.spec`).  The
``docs/fault-tolerance.md`` guide walks the registry end to end.
"""

from __future__ import annotations

import time  # analysis: host-ok (slow-batch faults sleep on the host)
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# Typed injected faults.
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    """Base of every injected failure; ``transient`` drives the service's
    retry-vs-quarantine classification (:mod:`repro_torch.serve.recovery`)."""

    transient = False


class WorkerCrashError(InjectedFault):
    """A worker process died mid-batch; a relaunch can succeed (transient)."""

    transient = True


class TransientExecutorError(InjectedFault):
    """A one-off executor failure (OOM blip, preempted device); retryable."""

    transient = True


class CompileFailureError(InjectedFault):
    """Compilation of the batch's computation fails deterministically;
    retrying the same key can never help (persistent)."""

    transient = False


class ReplicaKilled(BaseException):
    """The in-process analogue of SIGKILL for a cluster replica.

    Deliberately a ``BaseException``: nothing in the serve stack's typed
    recovery machinery may catch, retry, or convert it -- a killed replica
    writes no result, releases no lease, and says no goodbye, exactly like
    a process that took a real SIGKILL.  Subprocess replicas take the real
    signal instead (:mod:`repro_torch.serve.cluster`)."""


# ---------------------------------------------------------------------------
# Registry.
# ---------------------------------------------------------------------------

_FAULTS: dict[str, type["FaultModel"]] = {}


def register_fault(name: str):
    """Class decorator: make a FaultModel constructible by registry name."""

    def deco(cls: type["FaultModel"]) -> type["FaultModel"]:
        cls.fault_name = name
        _FAULTS[name] = cls
        return cls

    return deco


def available_faults() -> tuple[str, ...]:
    return tuple(sorted(_FAULTS))


def get_fault(name: str) -> type["FaultModel"]:
    try:
        return _FAULTS[name]
    except KeyError:
        raise ValueError(
            f"unknown fault model {name!r}; available: {available_faults()}"
        ) from None


def fault_from_spec(spec: dict) -> "FaultModel":
    """Build a model from its :meth:`FaultModel.spec` dict (JSON-safe)."""
    return get_fault(spec["fault_model"])(**spec.get("fault_params", {}))


def key_digest(key) -> int:
    """A process-stable 32-bit digest of a work identity.

    ``repr`` + crc32, NOT ``hash()``: string hashing is salted per process,
    and fault schedules must reproduce across service restarts (the
    checkpoint/resume and pinned-bench contracts)."""
    return zlib.crc32(repr(key).encode())


# ---------------------------------------------------------------------------
# Base class.
# ---------------------------------------------------------------------------


class FaultModel:
    """Deterministic injected-failure schedule; see the module docstring.

    ``stateful`` marks models carrying per-instance counters (``chaos``):
    like the ``markov`` delay model, build a FRESH instance per service run
    so schedules reproduce from ``(seed, submission order)`` alone.
    """

    fault_name = "abstract"
    stateful = False

    def __init__(self, *, seed: int = 0):
        self.seed = int(seed)

    # -- the two injection hooks ------------------------------------------

    def on_dispatch(self, kind: str, key, attempt: int) -> None:
        """Called before the service executes ``key`` (lane ``kind``) for
        the ``attempt``-th time.  Raise an :class:`InjectedFault` to fail
        the dispatch, sleep to overrun a deadline, or return for no fault."""

    def poison_cells(self, n_cells: int, key) -> tuple[int, ...]:
        """Cell indices of batch ``key`` whose gamma is replaced by NaN.
        Attempt-stable by contract (no ``attempt`` argument on purpose)."""
        return ()

    # -- the cluster-transport hooks (replicated serving) ------------------

    def message_fate(self, kind: str, key, seq: int) -> tuple[int, int]:
        """``(copies, delay_ticks)`` for one cluster-transport send.

        ``kind`` is the message class (``"job"``/``"result"``/
        ``"heartbeat"``), ``key`` the message identity (job key or replica
        id), ``seq`` the sender's per-transport send counter -- so a RE-sent
        message is a fresh draw.  ``copies=0`` drops the message, ``2``
        duplicates it; ``delay_ticks > 0`` holds delivery for that many
        subsequent transport ticks (``1`` lets the next message overtake:
        reordering).  Default: deliver one copy now."""
        return (1, 0)

    def replica_fate(self, replica: str, tick: int) -> str:
        """``"ok"`` | ``"partitioned"`` | ``"killed"`` for one replica at
        one scheduler tick.  Partitioned replicas read nothing and their
        sends are dropped; killed replicas stop abruptly (no lease release,
        no final heartbeat)."""
        return "ok"

    def segment_fate(self, replica: str, start_round: int) -> bool:
        """True iff ``replica`` must die at the checkpoint segment starting
        at ``start_round`` -- the mid-run kill hook (the previous segment's
        snapshot is already durable when this fires)."""
        return False

    # -- spec round-trip ---------------------------------------------------

    def params(self) -> dict:
        """JSON-scalar constructor kwargs; subclasses extend."""
        return {"seed": self.seed}

    def spec(self) -> dict:
        """The JSON-safe description: ``fault_from_spec(m.spec())`` builds
        an equivalent model."""
        return {"fault_model": self.fault_name, "fault_params": self.params()}

    def _rng(self, key) -> np.random.Generator:
        return np.random.default_rng([self.seed, key_digest(key)])


@register_fault("none")
class NoFault(FaultModel):
    """The default: never injects anything."""


@register_fault("transient_executor")
class TransientExecutorFault(FaultModel):
    """First ``failures`` attempts of every batch raise a transient error."""

    def __init__(self, *, seed: int = 0, failures: int = 1):
        super().__init__(seed=seed)
        if failures < 0:
            raise ValueError(f"failures must be >= 0, got {failures}")
        self.failures = int(failures)

    def on_dispatch(self, kind, key, attempt):
        if kind == "batch" and attempt < self.failures:
            raise TransientExecutorError(
                f"injected transient executor failure "
                f"(attempt {attempt} < failures={self.failures})")

    def params(self):
        return {**super().params(), "failures": self.failures}


@register_fault("worker_crash")
class WorkerCrashFault(FaultModel):
    """A worker dies mid-batch (transient), and/or a checkpointed run is
    killed at segment boundary ``crash_round`` (resume from checkpoint)."""

    def __init__(self, *, seed: int = 0, crashes: int = 1,
                 crash_round: int | None = None):
        super().__init__(seed=seed)
        if crashes < 0:
            raise ValueError(f"crashes must be >= 0, got {crashes}")
        self.crashes = int(crashes)
        self.crash_round = None if crash_round is None else int(crash_round)

    def on_dispatch(self, kind, key, attempt):
        if kind == "batch" and attempt < self.crashes:
            raise WorkerCrashError(
                f"injected worker crash mid-batch (attempt {attempt})")
        if (kind == "segment" and self.crash_round is not None
                and attempt >= self.crash_round):
            raise WorkerCrashError(
                f"injected service kill at round {attempt} "
                f"(crash_round={self.crash_round}); resume from checkpoint")

    def params(self):
        return {**super().params(), "crashes": self.crashes,
                "crash_round": self.crash_round}


@register_fault("compile_failure")
class CompileFailureFault(FaultModel):
    """Every batch attempt fails persistently: the circuit-breaker regime."""

    def on_dispatch(self, kind, key, attempt):
        if kind == "batch":
            raise CompileFailureError(
                "injected deterministic compile failure (persistent; "
                "retries cannot help)")


@register_fault("nan_poison")
class NanPoisonFault(FaultModel):
    """``count`` deterministic cells per batch get a NaN gamma operand."""

    def __init__(self, *, seed: int = 0, count: int = 1):
        super().__init__(seed=seed)
        if count < 0:
            raise ValueError(f"count must be >= 0, got {count}")
        self.count = int(count)

    def poison_cells(self, n_cells, key):
        k = min(self.count, n_cells)
        if k == 0:
            return ()
        idx = self._rng(key).choice(n_cells, size=k, replace=False)
        return tuple(sorted(int(i) for i in idx))

    def params(self):
        return {**super().params(), "count": self.count}


@register_fault("slow_batch")
class SlowBatchFault(FaultModel):
    """First ``slow_attempts`` attempts of every batch sleep ``delay_s``
    before executing -- the deadline-overrun regime (watchdog -> typed
    ``JobTimeoutError`` -> solo-lane requeue)."""

    def __init__(self, *, seed: int = 0, delay_s: float = 0.5,
                 slow_attempts: int = 1):
        super().__init__(seed=seed)
        if delay_s < 0 or slow_attempts < 0:
            raise ValueError(
                f"need delay_s >= 0 and slow_attempts >= 0, got "
                f"{delay_s}, {slow_attempts}")
        self.delay_s = float(delay_s)
        self.slow_attempts = int(slow_attempts)

    def on_dispatch(self, kind, key, attempt):
        if kind == "batch" and attempt < self.slow_attempts:
            time.sleep(self.delay_s)

    def params(self):
        return {**super().params(), "delay_s": self.delay_s,
                "slow_attempts": self.slow_attempts}


@register_fault("chaos")
class ChaosFault(FaultModel):
    """The pinned composite schedule of the chaos bench: per batch-dispatch
    process order, dispatch 0 overruns the deadline, dispatch 1 fails
    transiently, and the first batch asked about poisoning gets ``poison``
    NaN cells.  Stateful (fresh instance per run, like ``markov``)."""

    stateful = True

    def __init__(self, *, seed: int = 0, delay_s: float = 0.3,
                 poison: int = 1):
        super().__init__(seed=seed)
        if delay_s < 0 or poison < 0:
            raise ValueError(
                f"need delay_s >= 0 and poison >= 0, got {delay_s}, {poison}")
        self.delay_s = float(delay_s)
        self.poison = int(poison)
        self._dispatches = 0
        self._poison_key = None

    def on_dispatch(self, kind, key, attempt):
        if kind != "batch":
            return
        n = self._dispatches
        self._dispatches += 1
        if n == 0:
            time.sleep(self.delay_s)  # deadline overrun
        elif n == 1:
            raise TransientExecutorError(
                "injected chaos transient fault (dispatch 1)")

    def poison_cells(self, n_cells, key):
        if self._poison_key is None:
            self._poison_key = key_digest(key)
        if key_digest(key) != self._poison_key:
            return ()
        k = min(self.poison, n_cells)
        if k == 0:
            return ()
        idx = self._rng(key).choice(n_cells, size=k, replace=False)
        return tuple(sorted(int(i) for i in idx))

    def params(self):
        return {**super().params(), "delay_s": self.delay_s,
                "poison": self.poison}


# ---------------------------------------------------------------------------
# The network-fault family (cluster-transport seam).
# ---------------------------------------------------------------------------

#: Message kinds the cluster transport routes; the ``kinds`` parameter of
#: the per-message entries is a comma-joined subset of these.
MESSAGE_KINDS = ("job", "result", "heartbeat")


class _PerMessageFault(FaultModel):
    """Shared machinery: select messages at ``rate`` over ``kinds``.

    Selection is a pure function of ``(seed, kind, key, seq)`` -- the send
    SEQUENCE enters the draw, so a retried message is a fresh coin flip and
    at-least-once senders always make progress eventually."""

    def __init__(self, *, seed: int = 0, rate: float = 0.5,
                 kinds: str = "job,result,heartbeat"):
        super().__init__(seed=seed)
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self.kinds = str(kinds)
        parsed = tuple(k.strip() for k in self.kinds.split(",") if k.strip())
        unknown = [k for k in parsed if k not in MESSAGE_KINDS]
        if unknown:
            raise ValueError(
                f"unknown message kinds {unknown}; known: {MESSAGE_KINDS}")
        self._kinds = frozenset(parsed)

    def _selected(self, kind: str, key, seq: int) -> bool:
        if kind not in self._kinds or self.rate == 0.0:
            return False
        if self.rate >= 1.0:
            return True
        rng = np.random.default_rng(
            [self.seed, key_digest(kind), key_digest(key), int(seq)])
        return bool(rng.random() < self.rate)

    def params(self):
        return {**super().params(), "rate": self.rate, "kinds": self.kinds}


@register_fault("net_drop")
class NetDropFault(_PerMessageFault):
    """Selected messages are dropped: never written to the cluster dir.
    Progress then depends on at-least-once re-send + idempotent delivery."""

    def message_fate(self, kind, key, seq):
        return (0, 0) if self._selected(kind, key, seq) else (1, 0)


@register_fault("net_duplicate")
class NetDuplicateFault(_PerMessageFault):
    """Selected messages are delivered TWICE; receivers must dedupe
    (exactly-once delivery via idempotent job keys)."""

    def message_fate(self, kind, key, seq):
        return (2, 0) if self._selected(kind, key, seq) else (1, 0)


@register_fault("net_reorder")
class NetReorderFault(_PerMessageFault):
    """Selected messages are held one transport tick, so the next message
    overtakes them -- pairwise reordering."""

    def message_fate(self, kind, key, seq):
        return (1, 1) if self._selected(kind, key, seq) else (1, 0)


@register_fault("net_delay")
class NetDelayFault(_PerMessageFault):
    """Selected messages are held for ``ticks`` transport ticks."""

    def __init__(self, *, seed: int = 0, rate: float = 1.0, ticks: int = 2,
                 kinds: str = "job,result,heartbeat"):
        super().__init__(seed=seed, rate=rate, kinds=kinds)
        if ticks < 1:
            raise ValueError(f"ticks must be >= 1, got {ticks}")
        self.ticks = int(ticks)

    def message_fate(self, kind, key, seq):
        return ((1, self.ticks) if self._selected(kind, key, seq)
                else (1, 0))

    def params(self):
        return {**super().params(), "ticks": self.ticks}


@register_fault("net_partition")
class NetPartitionFault(FaultModel):
    """Replica ``replica`` is unreachable for scheduler ticks
    ``[start_tick, start_tick + duration)``: it reads nothing and its sends
    are dropped.  ``duration=None`` partitions it forever (the
    no-hung-handles regime: consumers must still observe bounded, typed
    outcomes)."""

    def __init__(self, *, seed: int = 0, replica: str = "",
                 start_tick: int = 0, duration: int | None = None):
        super().__init__(seed=seed)
        if not replica:
            raise ValueError("net_partition needs replica=<replica id>")
        if start_tick < 0:
            raise ValueError(f"start_tick must be >= 0, got {start_tick}")
        if duration is not None and duration < 1:
            raise ValueError(f"duration must be >= 1 or None, got {duration}")
        self.replica = str(replica)
        self.start_tick = int(start_tick)
        self.duration = None if duration is None else int(duration)

    def replica_fate(self, replica, tick):
        if replica != self.replica or tick < self.start_tick:
            return "ok"
        if self.duration is not None and tick >= self.start_tick + self.duration:
            return "ok"
        return "partitioned"

    def params(self):
        return {**super().params(), "replica": self.replica,
                "start_tick": self.start_tick, "duration": self.duration}


@register_fault("replica_kill")
class ReplicaKillFault(FaultModel):
    """Replica ``replica`` dies abruptly -- crash semantics: no lease
    release, no final heartbeat.  ``after_steps=N`` kills it at its N-th
    scheduler step; ``at_segment=R`` kills it mid-run, at the checkpoint
    segment starting at round R (the previous snapshot is already durable).
    Subprocess replicas take a real SIGKILL; in-process replicas raise the
    uncatchable :class:`ReplicaKilled`."""

    def __init__(self, *, seed: int = 0, replica: str = "",
                 after_steps: int | None = None,
                 at_segment: int | None = None):
        super().__init__(seed=seed)
        if not replica:
            raise ValueError("replica_kill needs replica=<replica id>")
        if after_steps is None and at_segment is None:
            raise ValueError(
                "replica_kill needs after_steps and/or at_segment")
        if after_steps is not None and after_steps < 0:
            raise ValueError(f"after_steps must be >= 0, got {after_steps}")
        if at_segment is not None and at_segment < 1:
            raise ValueError(
                f"at_segment must be >= 1 (segment 0's kill would precede "
                f"any checkpoint), got {at_segment}")
        self.replica = str(replica)
        self.after_steps = None if after_steps is None else int(after_steps)
        self.at_segment = None if at_segment is None else int(at_segment)

    def replica_fate(self, replica, tick):
        if (replica == self.replica and self.after_steps is not None
                and tick >= self.after_steps):
            return "killed"
        return "ok"

    def segment_fate(self, replica, start_round):
        return (replica == self.replica and self.at_segment is not None
                and start_round >= self.at_segment)

    def params(self):
        return {**super().params(), "replica": self.replica,
                "after_steps": self.after_steps,
                "at_segment": self.at_segment}


@register_fault("cluster_chaos")
class ClusterChaosFault(FaultModel):
    """The pinned composite the cluster bench and ``make cluster-smoke``
    drive: ``kill_replica`` dies (mid-segment if ``at_segment`` is set,
    else at step ``after_steps``) while every message is dropped at
    ``drop_rate``.  Deterministic: delegates to :class:`ReplicaKillFault`
    and :class:`NetDropFault` built from the same seed."""

    def __init__(self, *, seed: int = 0, kill_replica: str = "",
                 after_steps: int | None = None,
                 at_segment: int | None = None, drop_rate: float = 0.2):
        super().__init__(seed=seed)
        self._kill = ReplicaKillFault(seed=seed, replica=kill_replica,
                                      after_steps=after_steps,
                                      at_segment=at_segment)
        self._drop = NetDropFault(seed=seed, rate=drop_rate)
        self.kill_replica = self._kill.replica
        self.after_steps = self._kill.after_steps
        self.at_segment = self._kill.at_segment
        self.drop_rate = self._drop.rate

    def message_fate(self, kind, key, seq):
        return self._drop.message_fate(kind, key, seq)

    def replica_fate(self, replica, tick):
        return self._kill.replica_fate(replica, tick)

    def segment_fate(self, replica, start_round):
        return self._kill.segment_fate(replica, start_round)

    def params(self):
        return {**super().params(), "kill_replica": self.kill_replica,
                "after_steps": self.after_steps,
                "at_segment": self.at_segment, "drop_rate": self.drop_rate}
