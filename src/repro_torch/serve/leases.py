"""Filesystem leases + heartbeats: who owns which job, and who is alive.

PyTorch port's copy of ``repro.serve.leases``.

The replicated serve cluster (:mod:`repro_torch.serve.cluster`) coordinates
through a shared **cluster directory** -- the same idiom as the shareable
``checkpoint_dir``: no broker process, no sockets between replicas, just
atomic filesystem operations every POSIX rename/link gives us.  This module
is the coordination substrate; the cluster layer builds job routing and
takeover on top of it.

Three primitives, three guarantees:

* **Lease acquisition is mutually exclusive.**  A lease is claimed by
  writing a tmp file with the FULL lease record and then ``os.link``-ing it
  to ``leases/<job>.json``.  ``link`` fails with ``EEXIST`` if the name is
  taken -- unlike ``rename``, which would silently replace the current
  owner (last-writer-wins is exactly the wrong semantics for ownership).
  Exactly one of N concurrent claimants wins, and the winner's record is
  complete the instant the name exists (no torn reads).

* **Heartbeats are atomic snapshots.**  Each replica periodically renames a
  tmp file over ``replicas/<replica>.json`` carrying its own
  ``clock.time()``; readers age that stamp against THEIR clock.  In-process
  test clusters share one :class:`~repro_torch.serve.clock.ManualClock` (ages are
  exact and sleep-free); cross-process clusters use the system clock, whose
  epoch is comparable between processes on one host.  A replica whose
  heartbeat is older than ``lease_ttl_s`` is presumed dead.

* **Takeover is raced through a rename.**  To steal a dead owner's lease, a
  claimant atomically renames the lease file to a private claim name --
  only one concurrent claimant's rename succeeds (the loser gets ENOENT) --
  and then re-acquires with the dead owner's ``epoch + 1``.  The epoch is
  the fencing token: a resurrected owner still holding epoch ``e`` fails
  its :meth:`LeaseManager.still_owner` check against the epoch-``e+1``
  lease and must discard its work instead of double-delivering.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import tempfile

from repro_torch.serve.clock import SYSTEM_CLOCK, Clock

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _fname(key: str) -> str:
    return _SAFE.sub("_", str(key))


def _atomic_write(path: pathlib.Path, payload: dict) -> None:
    """Full-content atomic replace: readers see old or new, never torn."""
    with tempfile.NamedTemporaryFile("w", dir=path.parent, suffix=".tmp",
                                     delete=False) as f:
        f.write(json.dumps(payload))
        tmp = pathlib.Path(f.name)
    os.replace(tmp, path)


def _read_json(path: pathlib.Path) -> dict | None:
    """None on missing; raises on torn content (atomic writes make torn
    reads a bug, not a race)."""
    try:
        text = path.read_text()
    except FileNotFoundError:
        return None
    return json.loads(text)


class LeaseManager:
    """One replica's view of the shared lease/heartbeat state.

    ``lease_ttl_s`` is both the heartbeat staleness threshold and therefore
    the failure-detection latency: a replica that has not heartbeat for
    ``lease_ttl_s`` seconds is presumed dead and its leases become
    stealable.  ``clock`` is injectable so every timing behavior here is
    testable with a :class:`~repro_torch.serve.clock.ManualClock`.
    """

    def __init__(self, cluster_dir, replica_id: str, *,
                 clock: Clock | None = None, lease_ttl_s: float = 10.0):
        if lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s must be positive, got {lease_ttl_s}")
        self.cluster_dir = pathlib.Path(cluster_dir)
        self.replica_id = str(replica_id)
        self.clock = clock or SYSTEM_CLOCK
        self.lease_ttl_s = float(lease_ttl_s)
        self._replicas = self.cluster_dir / "replicas"
        self._leases = self.cluster_dir / "leases"
        for d in (self._replicas, self._leases):
            d.mkdir(parents=True, exist_ok=True)
        self._beats = 0

    # -- heartbeats --------------------------------------------------------

    def heartbeat(self) -> None:
        """Publish this replica's liveness stamp (atomic replace)."""
        self._beats += 1
        _atomic_write(self._replicas / f"{_fname(self.replica_id)}.json",
                      {"replica": self.replica_id,
                       "time": self.clock.time(), "seq": self._beats})

    def retire(self) -> None:
        """Graceful shutdown: withdraw the heartbeat so peers stop counting
        this replica as a member (a CRASHED replica never calls this --
        that is the whole point of staleness detection)."""
        try:
            os.unlink(self._replicas / f"{_fname(self.replica_id)}.json")
        except FileNotFoundError:
            pass

    def membership(self) -> dict:
        """Every replica that ever heartbeat: ``{replica: {"age_s", "alive",
        "seq"}}``, aged against THIS replica's clock."""
        now = self.clock.time()
        out = {}
        for path in sorted(self._replicas.glob("*.json")):
            beat = _read_json(path)
            if beat is None:  # unlinked between glob and read
                continue
            age = max(0.0, now - beat["time"])
            out[beat["replica"]] = {
                "age_s": round(age, 6),
                "alive": age < self.lease_ttl_s,
                "seq": beat["seq"],
            }
        return out

    def alive(self, replica: str) -> bool:
        beat = _read_json(self._replicas / f"{_fname(replica)}.json")
        if beat is None:
            return False
        return max(0.0, self.clock.time() - beat["time"]) < self.lease_ttl_s

    # -- leases ------------------------------------------------------------

    def _lease_path(self, job_key: str) -> pathlib.Path:
        return self._leases / f"{_fname(job_key)}.json"

    def try_acquire(self, job_key: str, *, epoch: int = 0) -> dict | None:
        """Claim ``job_key`` at ``epoch``; the full lease record on the win,
        ``None`` if any owner (any epoch) already holds the name."""
        record = {"job": str(job_key), "owner": self.replica_id,
                  "epoch": int(epoch), "time": self.clock.time()}
        path = self._lease_path(job_key)
        with tempfile.NamedTemporaryFile("w", dir=self._leases,
                                         suffix=".tmp", delete=False) as f:
            f.write(json.dumps(record))
            tmp = pathlib.Path(f.name)
        try:
            os.link(tmp, path)  # atomic: EEXIST iff someone owns the job
        except FileExistsError:
            return None
        finally:
            os.unlink(tmp)
        return record

    def read_lease(self, job_key: str) -> dict | None:
        return _read_json(self._lease_path(job_key))

    def still_owner(self, job_key: str, epoch: int) -> bool:
        """The fencing check: does this replica still hold ``job_key`` at
        ``epoch``?  A replica that was presumed dead and superseded sees
        ``False`` (higher epoch or different owner) and must DISCARD its
        late work rather than deliver it."""
        lease = self.read_lease(job_key)
        return (lease is not None and lease["owner"] == self.replica_id
                and lease["epoch"] == int(epoch))

    def release(self, job_key: str, epoch: int) -> bool:
        """Release a lease this replica holds at ``epoch``; True if
        released.  Never touches a lease someone else won in the meantime."""
        if not self.still_owner(job_key, epoch):
            return False
        try:
            os.unlink(self._lease_path(job_key))
        except FileNotFoundError:
            pass
        return True

    def expired(self, lease: dict) -> bool:
        """Is this lease's owner presumed dead (heartbeat stale/missing)?
        Self-owned leases are never expired -- a replica trusts its own
        liveness."""
        return lease["owner"] != self.replica_id and not self.alive(lease["owner"])

    def try_takeover(self, job_key: str) -> dict | None:
        """Steal ``job_key`` from a presumed-dead owner; the new lease
        record (epoch bumped) on the win, ``None`` otherwise.

        The steal itself is raced through an atomic rename of the lease
        file to a claimant-private name: of N concurrent claimants exactly
        one rename succeeds, the losers get ENOENT and report ``None`` --
        so mutual exclusion holds even during takeover.
        """
        lease = self.read_lease(job_key)
        if lease is None or not self.expired(lease):
            return None
        path = self._lease_path(job_key)
        claim = self._leases / f"{path.name}.claim.{_fname(self.replica_id)}"
        try:
            os.replace(path, claim)  # atomic: one claimant wins the steal
        except FileNotFoundError:
            return None  # another claimant already renamed it away
        try:
            stolen = _read_json(claim)
            if stolen is not None and stolen["epoch"] != lease["epoch"]:
                # The file we renamed was a NEWER lease than the stale one
                # we decided to steal (the old owner was superseded between
                # our read and our rename).  Put it back and stand down.
                os.replace(claim, path)
                return None
            return self.try_acquire(job_key, epoch=lease["epoch"] + 1)
        finally:
            try:
                os.unlink(claim)
            except FileNotFoundError:
                pass

    def lease_table(self) -> dict:
        """Every live lease file: ``{job: {"owner", "epoch", "age_s",
        "owner_alive"}}`` -- the ``GET /health`` view."""
        now = self.clock.time()
        membership = self.membership()
        out = {}
        for path in sorted(self._leases.glob("*.json")):
            lease = _read_json(path)
            if lease is None:
                continue
            out[lease["job"]] = {
                "owner": lease["owner"],
                "epoch": lease["epoch"],
                "age_s": round(max(0.0, now - lease["time"]), 6),
                "owner_alive": membership.get(lease["owner"],
                                              {"alive": False})["alive"],
            }
        return out
