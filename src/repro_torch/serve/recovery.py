"""Recovery machinery for the experiment service: typed errors, retry
backoff, execution deadlines, and the per-key circuit breaker.

PyTorch port's copy of ``repro.serve.recovery``.

The service (:mod:`repro_torch.serve.service`) composes these primitives into its
self-healing dispatch path:

* transient faults (``exc.transient`` is true -- see
  :mod:`repro_torch.core.faults`) are retried with exponential backoff and
  deterministic jitter, up to ``RecoveryPolicy.max_attempts``;
* persistent batch failures are *quarantined by bisection*: the cohort is
  split in half and each half retried independently (depth bounded by
  ``max_bisect_depth``), so only the poison request fails;
* every batch/solo execution can carry a deadline
  (``batch_deadline_s`` / ``solo_deadline_s``); an overrun becomes a typed
  :class:`JobTimeoutError` (batched work is then requeued on the solo
  lane) instead of a hang;
* repeated failures on one ``batch_key`` open a :class:`CircuitBreaker`
  for that key (fast-fail with :class:`CircuitOpenError`), with a
  half-open probe after ``breaker_cooldown_s``.

Everything here is deterministic given the policy seed and the sequence of
calls -- jitter comes from ``numpy`` generators keyed on
``(seed, key digest, attempt)``, never from global RNG state or wall-clock.
The one time-dependent component (breaker cooldown) reads an injectable
:class:`repro_torch.serve.clock.Clock`, so cooldown behavior is testable with a
``ManualClock`` instead of real sleeps.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core.faults import key_digest
from .clock import SYSTEM_CLOCK, Clock

# ---------------------------------------------------------------------------
# Typed errors.  HTTP status mapping lives in serve/http.py.
# ---------------------------------------------------------------------------


class JobTimeoutError(RuntimeError):
    """A batch or solo execution overran its deadline; the watchdog
    abandoned it (late results are discarded, never delivered)."""


class CellDivergenceError(RuntimeError):
    """This request's cell produced non-finite iterates; it was masked out
    of the coalesced delivery (healthy cohort members were unaffected)."""


class CircuitOpenError(RuntimeError):
    """The circuit breaker for this request's batch key is open after
    repeated failures; fast-failed without dispatching."""


class ServiceStoppedError(RuntimeError):
    """The service (or its dispatcher thread) went away before this job
    finished; the stream was terminated by the teardown poison-pill."""


def is_transient(exc: BaseException) -> bool:
    """Retry classification: injected faults carry a ``transient`` class
    attribute (:mod:`repro_torch.core.faults`); everything else is persistent
    -- a CUDA error included: a failed launch or capture is never retried."""
    return bool(getattr(exc, "transient", False))


# ---------------------------------------------------------------------------
# Policy + deterministic backoff.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """Knobs for the service's self-healing dispatch path.

    ``max_attempts`` counts dispatches of the same cohort (1 = no retry);
    ``backoff_*`` shape the inter-retry sleep
    ``base * factor**attempt * (1 + U(-jitter, jitter))``;
    ``max_bisect_depth`` bounds quarantine recursion (a cohort of 2**d
    splits to singletons at depth d); ``*_deadline_s`` of ``None`` disables
    the watchdog for that lane; the breaker opens after
    ``breaker_threshold`` consecutive failures of one batch key and
    half-opens after ``breaker_cooldown_s``.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_factor: float = 2.0
    backoff_jitter: float = 0.25
    max_bisect_depth: int = 3
    batch_deadline_s: float | None = None
    solo_deadline_s: float | None = None
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 30.0
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.max_bisect_depth < 0:
            raise ValueError(
                f"max_bisect_depth must be >= 0, got {self.max_bisect_depth}")
        if not 0.0 <= self.backoff_jitter < 1.0:
            raise ValueError(
                f"backoff_jitter must be in [0, 1), got {self.backoff_jitter}")
        if self.breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {self.breaker_threshold}")


def backoff_delay(policy: RecoveryPolicy, attempt: int, key) -> float:
    """Deterministic jittered exponential backoff before retry ``attempt``
    (1-based: the sleep before the second dispatch is ``attempt=1``)."""
    base = policy.backoff_base_s * policy.backoff_factor ** (attempt - 1)
    if policy.backoff_jitter <= 0.0:
        return base
    rng = np.random.default_rng([policy.seed, key_digest(key), attempt])
    u = float(rng.uniform(-policy.backoff_jitter, policy.backoff_jitter))
    return base * (1.0 + u)


# ---------------------------------------------------------------------------
# Circuit breaker (per batch key).
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Thread-safe closed -> open -> half-open breaker, keyed by batch key.

    ``allow(key)`` gates a dispatch: closed keys always pass; open keys
    fast-fail until ``cooldown_s`` has elapsed, then exactly one caller is
    admitted as the half-open probe (concurrent callers keep fast-failing
    until the probe resolves).  ``record_success`` closes the key;
    ``record_failure`` re-opens a half-open key immediately, or opens a
    closed key once it accumulates ``threshold`` consecutive failures.
    """

    def __init__(self, threshold: int, cooldown_s: float,
                 clock: Clock | None = None):
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_s)
        self.clock = clock or SYSTEM_CLOCK
        self._lock = threading.Lock()
        # key -> [state, consecutive_failures, opened_at]
        self._keys: dict = {}

    def allow(self, key) -> bool:
        with self._lock:
            st = self._keys.get(key)
            if st is None or st[0] == "closed":
                return True
            if st[0] == "half_open":
                return False  # a probe is already in flight
            if self.clock.monotonic() - st[2] >= self.cooldown_s:
                st[0] = "half_open"
                return True
            return False

    def record_success(self, key) -> None:
        with self._lock:
            self._keys.pop(key, None)

    def record_failure(self, key) -> None:
        with self._lock:
            st = self._keys.setdefault(key, ["closed", 0, 0.0])
            st[1] += 1
            if st[0] == "half_open" or st[1] >= self.threshold:
                st[0] = "open"
                st[2] = self.clock.monotonic()

    def state(self, key) -> str:
        with self._lock:
            st = self._keys.get(key)
            return "closed" if st is None else st[0]

    def snapshot(self) -> dict:
        """JSON-safe view for /stats: open + half-open keys only."""
        with self._lock:
            return {
                "open": sorted(repr(k) for k, st in self._keys.items()
                               if st[0] == "open"),
                "half_open": sorted(repr(k) for k, st in self._keys.items()
                                    if st[0] == "half_open"),
            }

    def states(self) -> dict:
        """JSON-safe FULL per-key state table for ``GET /health``: every
        tracked batch key with its state, consecutive-failure count, and --
        for open keys -- how long the circuit has been open on this
        breaker's clock."""
        with self._lock:
            now = self.clock.monotonic()
            return {
                repr(k): {
                    "state": st[0],
                    "consecutive_failures": st[1],
                    "open_for_s": (round(now - st[2], 6)
                                   if st[0] == "open" else None),
                }
                for k, st in sorted(self._keys.items(), key=lambda kv: repr(kv[0]))
            }


# ---------------------------------------------------------------------------
# Deadline watchdog.
# ---------------------------------------------------------------------------


def run_with_deadline(fn, deadline_s: float | None, *, label: str = "job"):
    """Run ``fn()`` with a wall-clock deadline.

    With ``deadline_s`` of ``None``, calls ``fn`` inline.  Otherwise runs
    it on a daemon thread and joins with the timeout: an overrun raises
    :class:`JobTimeoutError` and the late result (or late error) is
    *abandoned* -- the box is flagged so nothing from the stale attempt can
    ever be delivered to a tenant.  The abandoned thread runs on, and may
    still capture or replay a graph while the caller reruns the work: the
    executor's lock keeps the two apart (:mod:`repro_torch.core.executor`).
    """
    if deadline_s is None:
        return fn()
    box = {"value": None, "error": None, "abandoned": False}

    def target():
        try:
            v = fn()
        except BaseException as e:  # analysis: fail-fast-ok (relayed through the box to the waiting caller)
            if not box["abandoned"]:
                box["error"] = e
            return
        if not box["abandoned"]:
            box["value"] = v

    t = threading.Thread(target=target, name=f"deadline-{label}", daemon=True)
    t.start()
    t.join(timeout=deadline_s)
    if t.is_alive():
        box["abandoned"] = True
        raise JobTimeoutError(
            f"{label} overran its {deadline_s:g}s execution deadline")
    if box["error"] is not None:
        raise box["error"]
    return box["value"]
