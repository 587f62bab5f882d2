"""Replicated multi-process serving: N replicas over one cluster directory.

PyTorch counterpart of ``repro.serve.cluster``. A replica's service computes
on the device its ``service_kwargs`` name (the card unless ``device="cpu"``);
a subprocess replica is ``python -m repro_torch serve --replica-of
<cluster-dir> --replica-id <id> [--device cpu]``.

The single-process serve stack heals everything that can fail INSIDE one process --
this module makes the process itself redundant.  N
:class:`~repro_torch.serve.service.ExperimentService` replicas (in-process objects
for deterministic tests, or separate processes spawned with ``python -m
repro_torch serve --replica-of <cluster-dir> --replica-id <id>``) coordinate
through a shared filesystem **cluster directory**; there is no broker and no
inter-replica socket, just the atomic-rename/link idiom of
:mod:`repro_torch.serve.leases` (and of the shareable ``checkpoint_dir``,
which lives inside the cluster directory so every replica can resume every
replica's runs)::

    <cluster-dir>/
      replicas/     heartbeat files        (leases.LeaseManager)
      leases/       per-job ownership      (leases.LeaseManager)
      jobs/         submitted job records  (client -> replicas)
      results/      delivered results      (replicas -> client, link-once)
      checkpoints/  shared lockstep checkpoint segments

**Job flow.**  A :class:`ClusterClient` content-hashes ``(spec, method,
tenant)`` into an idempotent :func:`job_key` and writes a job record; it
re-sends every unfinished record on each :meth:`~ClusterClient.pump` --
at-least-once.  Replicas scan ``jobs/``, claim unowned jobs through
mutually-exclusive lease acquisition, execute through their embedded
``ExperimentService`` (same admission, recovery, and bit-identity contracts
as solo serving), and deliver ``(events, result)`` as a result record.
Delivery is **exactly-once** in the only sense that matters -- at most one
result record per job key ever becomes visible -- because records are
created with ``os.link`` (first writer wins, duplicates count as
``deduped_results``), while the at-least-once re-send loop guarantees the
record eventually appears under message drops.

**Failure detection + takeover.**  A replica that dies (real SIGKILL in
subprocess mode; the uncatchable :class:`~repro_torch.core.faults.ReplicaKilled`
in-process) leaves its heartbeat to go stale and its lease held.  A
surviving replica steals the lease through the raced-rename takeover of
:meth:`~repro_torch.serve.leases.LeaseManager.try_takeover` (epoch bumped), then
simply re-runs the job: ``run_lockstep_checkpointed`` finds the dead
owner's last durable segment under the shared ``checkpoints/`` and resumes
-- the delivered stream is bit-identical to an uninterrupted run.  The
bumped epoch fences the ghost: a presumed-dead owner that comes back fails
:meth:`~repro_torch.serve.leases.LeaseManager.still_owner` and discards its late
result (``fenced_results``) instead of double-delivering.

**Chaos seam.**  Every cross-process interaction -- job records, result
records, heartbeats, and the replica scheduler itself -- routes through
:class:`ClusterTransport` / :meth:`ClusterReplica.step`, where the
:mod:`repro_torch.core.faults` network family (``net_drop`` / ``net_duplicate`` /
``net_reorder`` / ``net_delay`` / ``net_partition`` / ``replica_kill`` /
``cluster_chaos``) applies deterministically: message fates are pure
functions of ``(seed, kind, key, seq)`` and replica fates of ``(replica,
tick)``, so replaying one ``(seed, fault model, submission order)``
schedule reproduces the identical recovery counters.

The single-process contracts survive replica death: consumers never hang
(:meth:`ClusterClient.result` bounds its wait and raises the typed
:class:`ClusterUnavailableError`), errors stay typed end-to-end (error
records rebuild the ORIGINAL typed error class client-side, so the pinned
HTTP statuses of ``serve/http.py`` keep applying), and a replica's teardown
still poisons its local streams.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import signal
import tempfile

import numpy as np

from repro_torch.api.spec import ExperimentSpec
from repro_torch.core.acpd import RunRecord, RunResult
from repro_torch.core.faults import FaultModel, NoFault, ReplicaKilled
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock
from repro_torch.serve.http import event_from_dict, event_to_dict
from repro_torch.serve.leases import LeaseManager, _atomic_write, _fname, _read_json
from repro_torch.serve.recovery import (
    CellDivergenceError,
    CircuitOpenError,
    JobTimeoutError,
    ServiceStoppedError,
)
from repro_torch.serve.service import (
    BackpressureError,
    ExperimentService,
    SpecValidationError,
)

# ---------------------------------------------------------------------------
# Typed cluster errors + error-record reconstruction.
# ---------------------------------------------------------------------------


class ClusterUnavailableError(RuntimeError):
    """No replica delivered this job within the caller's wait bound -- the
    cluster is unreachable, partitioned away, or wholly dead.  The bounded
    typed outcome that replaces a hung ``result()``/``events()``."""


class ClusterJobError(RuntimeError):
    """A job failed on a replica with an error type this client cannot
    reconstruct; ``error_type`` carries the original class name."""

    def __init__(self, error_type: str, message: str):
        super().__init__(f"{error_type}: {message}")
        self.error_type = error_type


#: Error classes a result record may carry and the client re-raises AS-IS,
#: preserving the pinned HTTP statuses in serve/http.py end-to-end.
_TYPED_ERRORS = {cls.__name__: cls for cls in (
    SpecValidationError, BackpressureError, JobTimeoutError,
    CellDivergenceError, CircuitOpenError, ServiceStoppedError,
)}


def _raise_from_record(record: dict):
    err = record["error"]
    cls = _TYPED_ERRORS.get(err["error_type"])
    if cls is not None:
        raise cls(err["message"])
    raise ClusterJobError(err["error_type"], err["message"])


# ---------------------------------------------------------------------------
# Idempotent job identity + result (de)serialization.
# ---------------------------------------------------------------------------


def job_key(tenant: str, spec: ExperimentSpec, method: str | None) -> str:
    """Content-hash of ``(spec, method, tenant)``: the idempotency token.

    Two submissions of the same work map to the SAME key, so a duplicated
    or re-sent job record cannot run twice into two deliveries -- the lease
    admits one owner per key and the result link admits one record.  The
    spec enters through its canonical ``to_dict`` JSON (sorted keys), not
    object identity, so the key is stable across processes and restarts."""
    blob = json.dumps({"tenant": tenant, "spec": spec.to_dict(),
                       "method": method}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:20]


def result_to_record(events, result: RunResult) -> dict:
    """JSON-safe ``(events, result)``: exact round-trip (float repr)."""
    return {
        "events": [event_to_dict(e) for e in events],
        "records": [dataclasses.asdict(r) for r in result.records],
        "w": np.asarray(result.w).tolist(),
        "alpha": np.asarray(result.alpha).tolist(),
        "alpha_applied": (None if result.alpha_applied is None
                          else np.asarray(result.alpha_applied).tolist()),
        "dtype": str(np.asarray(result.w).dtype),
    }


def record_to_result(record: dict, method_config) -> tuple[list, RunResult]:
    """Inverse of :func:`result_to_record`; ``method_config`` comes from the
    CLIENT's own spec (method identity is part of the job key, so it is the
    config the producing replica ran)."""
    dt = record["dtype"]
    result = RunResult(
        method=method_config,
        records=[RunRecord(**r) for r in record["records"]],
        w=np.asarray(record["w"], dtype=dt),
        alpha=np.asarray(record["alpha"], dtype=dt),
        alpha_applied=(None if record["alpha_applied"] is None
                       else np.asarray(record["alpha_applied"], dtype=dt)))
    return [event_from_dict(d) for d in record["events"]], result


# ---------------------------------------------------------------------------
# The fault-injectable transport.
# ---------------------------------------------------------------------------


class ClusterTransport:
    """All cross-process writes of one sender, with the network-fault seam.

    A "message" is a closure performing one atomic filesystem write.  For
    each send the fault model's ``message_fate(kind, key, seq)`` decides
    ``(copies, delay_ticks)``: 0 copies drops the write, 2 duplicates it,
    and a positive delay holds the closure until ``delay_ticks`` calls to
    :meth:`tick` later (1 tick = the next message overtakes = reordering).
    The send SEQUENCE feeds the fate draw, so at-least-once re-senders
    always converge under sub-1.0 drop rates.

    Result records are written with ``os.link`` -- first writer wins -- so
    duplicate copies and racing peers dedupe instead of double-delivering
    (counted in ``deduped_results``).
    """

    def __init__(self, cluster_dir, *, fault: FaultModel | None = None,
                 sender: str = "client"):
        self.cluster_dir = pathlib.Path(cluster_dir)
        self.fault = fault or NoFault()
        self.sender = str(sender)
        self.jobs_dir = self.cluster_dir / "jobs"
        self.results_dir = self.cluster_dir / "results"
        for d in (self.jobs_dir, self.results_dir):
            d.mkdir(parents=True, exist_ok=True)
        self._seq = 0
        self._tick = 0
        self._held: list[tuple[int, int, object]] = []  # (due, seq, closure)
        self.counters = {"sent": 0, "dropped": 0, "duplicated": 0,
                         "delayed": 0, "deduped_results": 0}

    def tick(self) -> None:
        """Advance transport time; deliver every held message now due."""
        self._tick += 1
        due = [h for h in self._held if h[0] <= self._tick]
        self._held = [h for h in self._held if h[0] > self._tick]
        for _, _, write in sorted(due, key=lambda h: (h[0], h[1])):
            write()

    def _send(self, kind: str, key, write) -> None:
        copies, delay = self.fault.message_fate(kind, key, self._seq)
        self._seq += 1
        if copies == 0:
            self.counters["dropped"] += 1
            return
        if copies > 1:
            self.counters["duplicated"] += copies - 1
        for _ in range(copies):
            if delay > 0:
                self.counters["delayed"] += 1
                self._held.append((self._tick + delay, self._seq, write))
            else:
                self.counters["sent"] += 1
                write()

    # -- message kinds -----------------------------------------------------

    def send_job(self, key: str, record: dict) -> None:
        """Idempotent by content: duplicates/re-sends overwrite with the
        identical record (atomic replace)."""
        path = self.jobs_dir / f"{_fname(key)}.json"
        self._send("job", key, lambda: _atomic_write(path, record))

    def send_result(self, key: str, record: dict) -> None:
        """Exactly-once visible: first ``link`` wins, the rest dedupe."""
        path = self.results_dir / f"{_fname(key)}.json"

        def write():
            with tempfile.NamedTemporaryFile("w", dir=self.results_dir,
                                             suffix=".tmp", delete=False) as f:
                f.write(json.dumps(record))
                tmp = pathlib.Path(f.name)
            try:
                os.link(tmp, path)
            except FileExistsError:
                self.counters["deduped_results"] += 1
            finally:
                os.unlink(tmp)

        self._send("result", key, write)

    def send_heartbeat(self, lease: LeaseManager) -> None:
        """The heartbeat is a message too: droppable, delayable."""
        self._send("heartbeat", lease.replica_id, lease.heartbeat)

    # -- reads (fault-free: reads are local) -------------------------------

    def read_job(self, key: str) -> dict | None:
        return _read_json(self.jobs_dir / f"{_fname(key)}.json")

    def read_result(self, key: str) -> dict | None:
        return _read_json(self.results_dir / f"{_fname(key)}.json")

    def list_jobs(self) -> list[str]:
        return sorted(p.stem for p in self.jobs_dir.glob("*.json"))

    def has_result(self, key: str) -> bool:
        return (self.results_dir / f"{_fname(key)}.json").exists()


# ---------------------------------------------------------------------------
# Replica.
# ---------------------------------------------------------------------------


class _ReplicaFault(FaultModel):
    """Adapter handed to the embedded service: forwards the service-level
    hooks to the cluster fault model and turns ``segment_fate`` into death.

    ``on_dispatch(kind="segment", ...)`` is the service's checkpoint-segment
    boundary hook (the previous snapshot is durable when it fires); when the
    schedule says this replica dies there, subprocess replicas take a REAL
    ``SIGKILL`` and in-process replicas raise :class:`ReplicaKilled` -- a
    ``BaseException`` no recovery trap may catch, so the service writes no
    result, releases no lease, and says no goodbye."""

    def __init__(self, inner: FaultModel, replica_id: str, *,
                 subprocess_kill: bool):
        super().__init__(seed=inner.seed)
        self.inner = inner
        self.replica_id = replica_id
        self.subprocess_kill = subprocess_kill
        self.fault_name = f"replica({inner.fault_name})"

    def _die(self, where: str):
        if self.subprocess_kill:
            os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, no goodbye
        raise ReplicaKilled(f"replica {self.replica_id} killed {where}")

    def on_dispatch(self, kind: str, key, attempt: int) -> None:
        if kind == "segment" and self.inner.segment_fate(self.replica_id,
                                                         attempt):
            self._die(f"at checkpoint segment starting round {attempt}")
        return self.inner.on_dispatch(kind, key, attempt)

    def poison_cells(self, n_cells: int, key):
        return self.inner.poison_cells(n_cells, key)


class ClusterReplica:
    """One member: an ``ExperimentService`` plus lease/heartbeat/transport.

    Drive it with :meth:`step` -- one deterministic scheduler tick: check
    this replica's fate, flush the transport, heartbeat, deliver any
    completed-but-unconfirmed results, claim and execute at most one job,
    then attempt takeover of at most one expired lease.  ``run_forever``
    (subprocess mode) is just ``step`` + ``clock.sleep`` in a loop.
    """

    def __init__(self, cluster_dir, replica_id: str, *,
                 fault: FaultModel | None = None, clock: Clock | None = None,
                 lease_ttl_s: float = 10.0, subprocess_kill: bool = False,
                 service_kwargs: dict | None = None):
        self.cluster_dir = pathlib.Path(cluster_dir)
        self.replica_id = str(replica_id)
        self.clock = clock or SYSTEM_CLOCK
        fault = fault or NoFault()
        self.fault = fault
        self.lease = LeaseManager(self.cluster_dir, replica_id,
                                  clock=self.clock, lease_ttl_s=lease_ttl_s)
        self.transport = ClusterTransport(self.cluster_dir, fault=fault,
                                          sender=replica_id)
        kwargs = dict(service_kwargs or {})
        kwargs.setdefault("result_cache_entries", 64)
        self.service = ExperimentService(
            fault=_ReplicaFault(fault, self.replica_id,
                                subprocess_kill=subprocess_kill),
            checkpoint_dir=self.cluster_dir / "checkpoints",
            clock=self.clock, **kwargs)
        self.service.cluster_health = self.cluster_health
        self.tick = 0
        self._undelivered: dict[str, dict] = {}  # job_key -> result record
        self.counters = {"steps": 0, "claims": 0, "takeovers": 0,
                         "completed": 0, "errored": 0, "fenced_results": 0,
                         "partitioned_ticks": 0}

    # -- the scheduler tick ------------------------------------------------

    def step(self) -> bool:
        """One tick; returns True iff this replica executed a job.

        Raises :class:`ReplicaKilled` (never returns) when the fault
        schedule kills this replica here -- in subprocess mode the process
        is already gone."""
        self.tick += 1
        fate = self.fault.replica_fate(self.replica_id, self.tick)
        if fate == "killed":
            self.service.fault._die(f"at scheduler tick {self.tick}")
        if fate == "partitioned":
            # Reads nothing, sends nothing; held messages stay held.
            self.counters["partitioned_ticks"] += 1
            return False
        self.counters["steps"] += 1
        self.transport.tick()
        self.transport.send_heartbeat(self.lease)
        self._redeliver()
        did = self._claim_and_run()
        if not did:
            did = self._try_takeover_one()
        return did

    def _redeliver(self) -> None:
        """At-least-once: re-send completed results until visible."""
        for key in sorted(self._undelivered):
            if self.transport.has_result(key):
                del self._undelivered[key]
            else:
                self.transport.send_result(key, self._undelivered[key])

    def _claimable(self) -> list[str]:
        return [k for k in self.transport.list_jobs()
                if not self.transport.has_result(k)
                and k not in self._undelivered]

    def _claim_and_run(self) -> bool:
        for key in self._claimable():
            if self.lease.read_lease(key) is not None:
                continue
            lease = self.lease.try_acquire(key, epoch=0)
            if lease is None:
                continue  # raced: someone else claimed between read and link
            self.counters["claims"] += 1
            self._execute(key, lease)
            return True
        return False

    def _try_takeover_one(self) -> bool:
        for key in self._claimable():
            lease = self.lease.read_lease(key)
            if lease is None or not self.lease.expired(lease):
                continue
            stolen = self.lease.try_takeover(key)
            if stolen is None:
                continue  # lost the steal race, or the owner was superseded
            self.counters["takeovers"] += 1
            self._execute(key, stolen)
            return True
        return False

    def _execute(self, key: str, lease: dict) -> None:
        """Run one owned job through the embedded service and deliver.

        A mid-run kill (``segment_fate``) escapes as ``ReplicaKilled``
        before any delivery: the lease stays held, the heartbeat goes
        stale, and a peer resumes from the last durable checkpoint segment
        under the shared ``checkpoints/`` directory."""
        record = self.transport.read_job(key)
        if record is None:  # job record vanished (never: records are kept)
            self.lease.release(key, lease["epoch"])
            return
        try:
            spec = ExperimentSpec.from_dict(record["spec"])
            handle = self.service.submit(record["tenant"], spec,
                                         method=record.get("method"))
            self.service.drain()
            events = list(handle.events(timeout=5.0))
            result = handle.result(timeout=5.0)
            payload = {"job": key, "owner": self.replica_id,
                       "epoch": lease["epoch"],
                       **result_to_record(events, result)}
            self.counters["completed"] += 1
        except ReplicaKilled:
            raise
        except Exception as e:  # analysis: fail-fast-ok (delivered as a typed error record, re-raised client-side)
            payload = {"job": key, "owner": self.replica_id,
                       "epoch": lease["epoch"],
                       "error": {"error_type": type(e).__name__,
                                 "message": str(e)}}
            self.counters["errored"] += 1
        # Epoch fencing: if this replica was presumed dead and superseded
        # while running, its lease shows a different (owner, epoch) now --
        # the late result must be DISCARDED, the new owner's delivery wins.
        if not self.lease.still_owner(key, lease["epoch"]):
            self.counters["fenced_results"] += 1
            return
        self._undelivered[key] = payload
        self.transport.send_result(key, payload)
        if self.transport.has_result(key):
            del self._undelivered[key]
        self.lease.release(key, lease["epoch"])

    # -- lifecycle ---------------------------------------------------------

    def run_forever(self, *, interval_s: float = 0.2) -> None:
        """Subprocess main loop (``python -m repro_torch serve --replica-of``)."""
        try:
            while True:
                self.step()
                self.clock.sleep(interval_s)
        finally:
            self.retire()

    def retire(self) -> None:
        """Graceful exit: withdraw the heartbeat, poison local streams."""
        self.lease.retire()
        if self.service._thread is not None:
            self.service.stop(drain=False)
        else:
            self.service._poison_all(ServiceStoppedError(
                f"replica {self.replica_id} retired"))

    # -- observability -----------------------------------------------------

    def cluster_health(self) -> dict:
        """Membership + lease table + heartbeat ages, for ``GET /health``."""
        return {
            "replica_id": self.replica_id,
            "tick": self.tick,
            "membership": self.lease.membership(),
            "leases": self.lease.lease_table(),
            "undelivered": sorted(self._undelivered),
            "transport": dict(self.transport.counters),
        }

    def stats(self) -> dict:
        return {
            "replica_id": self.replica_id,
            **self.counters,
            "transport": dict(self.transport.counters),
            "service": {k: self.service.counters[k]
                        for k in ("submitted", "solo_requests", "failed")},
        }


# ---------------------------------------------------------------------------
# Client.
# ---------------------------------------------------------------------------


class ClusterClient:
    """Submit-and-await against the cluster directory (no replica pinning:
    any live replica may serve any job).

    At-least-once submission: :meth:`pump` re-sends every unfinished job
    record (dropped sends get fresh fate draws).  Bounded waits: both
    :meth:`result` and :meth:`events` raise the typed
    :class:`ClusterUnavailableError` at their deadline instead of hanging,
    whatever the cluster's state -- the cross-process form of the
    zero-hung-jobs contract.
    """

    def __init__(self, cluster_dir, *, fault: FaultModel | None = None,
                 clock: Clock | None = None):
        self.cluster_dir = pathlib.Path(cluster_dir)
        self.clock = clock or SYSTEM_CLOCK
        self.transport = ClusterTransport(self.cluster_dir, fault=fault,
                                          sender="client")
        self._pending: dict[str, dict] = {}   # key -> job record
        self._methods: dict[str, object] = {}  # key -> MethodConfig
        self.counters = {"submitted": 0, "resent": 0, "completed": 0,
                         "errored": 0, "unavailable": 0}

    def submit(self, tenant: str, spec: ExperimentSpec,
               method: str | None = None) -> str:
        """Validate locally, send the job record, return its idempotent key
        (a resubmission of identical work returns the same key)."""
        try:
            spec.validate()
        except ValueError as e:
            raise SpecValidationError(str(e)) from None
        entry = (spec.methods[0] if method is None
                 else spec.method_named(method))
        key = job_key(tenant, spec, method)
        record = {"job": key, "tenant": tenant, "spec": spec.to_dict(),
                  "method": method}
        self._pending[key] = record
        self._methods[key] = entry.config
        self.counters["submitted"] += 1
        self.transport.send_job(key, record)
        return key

    def pump(self) -> None:
        """Advance transport time and re-send unfinished job records."""
        self.transport.tick()
        for key in sorted(self._pending):
            if self.transport.has_result(key):
                continue
            self.counters["resent"] += 1
            self.transport.send_job(key, self._pending[key])

    def try_result(self, key: str):
        """``(events, result)`` if delivered, ``None`` if still pending;
        raises the job's reconstructed typed error if it failed."""
        record = self.transport.read_result(key)
        if record is None:
            return None
        self._pending.pop(key, None)
        if "error" in record:
            self.counters["errored"] += 1
            _raise_from_record(record)
        self.counters["completed"] += 1
        return record_to_result(record, self._methods.get(key))

    def result(self, key: str, *, timeout_s: float = 30.0,
               poll_s: float = 0.05) -> RunResult:
        """Block (bounded!) for the folded result."""
        return self._await(key, timeout_s, poll_s)[1]

    def events(self, key: str, *, timeout_s: float = 30.0,
               poll_s: float = 0.05) -> list:
        """Block (bounded!) for the full typed event stream."""
        return self._await(key, timeout_s, poll_s)[0]

    def _await(self, key: str, timeout_s: float, poll_s: float):
        deadline = self.clock.monotonic() + timeout_s
        while True:
            out = self.try_result(key)
            if out is not None:
                return out
            if self.clock.monotonic() >= deadline:
                self.counters["unavailable"] += 1
                raise ClusterUnavailableError(
                    f"job {key} not delivered within {timeout_s:g}s -- no "
                    f"live replica completed it (cluster dead, partitioned, "
                    f"or still recovering)")
            self.pump()
            self.clock.sleep(poll_s)

    def unfinished(self) -> list[str]:
        return [k for k in sorted(self._pending)
                if not self.transport.has_result(k)]


# ---------------------------------------------------------------------------
# Deterministic in-process scheduler loop (tests, chip_smoke.py).
# ---------------------------------------------------------------------------


def run_cluster(replicas: list[ClusterReplica], client: ClusterClient, *,
                max_ticks: int = 200, clock=None,
                advance_s: float = 0.0) -> dict:
    """Drive an in-process cluster to completion, deterministically.

    Round-robin over replicas in list order, one :meth:`ClusterReplica.step`
    each per tick, client :meth:`~ClusterClient.pump` between rounds --
    a fixed schedule, so one ``(seed, fault model, submission order)``
    triple always replays the identical interleaving and the identical
    counters.  Replicas that die (``ReplicaKilled``) are recorded and
    dropped; the loop ends when every submitted job has a result record or
    ``max_ticks`` elapses (it never hangs).

    When the cluster shares one :class:`~repro_torch.serve.clock.ManualClock`,
    pass it as ``clock`` with ``advance_s > 0``: each tick ages the clock
    by that much, so heartbeats go stale and lease takeover happens on the
    fixed schedule instead of wall time.
    """
    dead: dict[str, str] = {}
    ticks = 0
    for _ in range(max_ticks):
        if not client.unfinished():
            break
        ticks += 1
        if clock is not None and advance_s > 0:
            clock.advance(advance_s)
        client.pump()
        for replica in replicas:
            if replica.replica_id in dead:
                continue
            try:
                replica.step()
            except ReplicaKilled as e:
                dead[replica.replica_id] = str(e)
    return {
        "ticks": ticks,
        "dead": dict(dead),
        "hung_jobs": len(client.unfinished()),
        "client": dict(client.counters),
        "replicas": {r.replica_id: r.stats() for r in replicas},
    }
