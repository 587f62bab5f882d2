"""One injectable clock for every host-time read in the serve layer.

PyTorch port's copy of ``repro.serve.clock``.

The serve stack is full of wall-clock-shaped decisions -- batch max-wait
aging, retry backoff sleeps, circuit-breaker cooldowns, heartbeat staleness,
lease expiry -- and before this module each of them called ``time.time()`` /
``time.monotonic()`` / ``time.sleep()`` directly, which forced every test of
a time-dependent behavior to either real-sleep or pick degenerate thresholds
(``cooldown_s=0`` / ``1e9``).  Now every serve-side component takes a
:class:`Clock` (default :data:`SYSTEM_CLOCK`, the real thing) and tests
inject a :class:`ManualClock` they advance explicitly: deadline, backoff,
breaker-cooldown, heartbeat-staleness and lease-expiry behavior all run
deterministically without a single real sleep.

Two clocks matter for the cluster layer (:mod:`repro_torch.serve.cluster`):
replicas in ONE process under test share one ``ManualClock`` so heartbeat
ages are exact; replicas in SEPARATE processes use ``SYSTEM_CLOCK``, whose
``time()`` epoch is comparable across processes on one host (heartbeat files
carry the writer's ``clock.time()``; readers age them against their own).

This is the one module in ``serve/`` allowed to touch :mod:`time` directly.
"""

from __future__ import annotations

import threading
import time  # analysis: host-ok (the single wall-clock seam of the serve layer)


class Clock:
    """The injectable time source: monotonic + epoch reads and sleep."""

    def monotonic(self) -> float:
        """Monotonic seconds; use for intervals within one process."""
        return time.monotonic()

    def time(self) -> float:
        """Epoch seconds; use for cross-process comparisons (heartbeats)."""
        return time.time()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


#: The default: real host time.  Module-level singleton so components can
#: default to it without each constructing their own.
SYSTEM_CLOCK = Clock()


class ManualClock(Clock):
    """A test clock that only moves when told to (thread-safe).

    ``monotonic()`` and ``time()`` return the same counter (tests don't need
    two epochs); ``sleep(s)`` advances it by ``s`` instead of blocking, so a
    component that "waits out" a backoff or cooldown completes instantly
    while the rest of the system observes the elapsed interval.
    """

    def __init__(self, start: float = 0.0):
        self._lock = threading.Lock()
        self._now = float(start)

    def monotonic(self) -> float:
        with self._lock:
            return self._now

    def time(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(max(0.0, seconds))

    def advance(self, seconds: float) -> float:
        """Move time forward by ``seconds``; returns the new now."""
        with self._lock:
            self._now += float(seconds)
            return self._now
