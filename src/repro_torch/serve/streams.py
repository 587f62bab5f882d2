"""Per-tenant event streams: demultiplexing a batched sweep result.

PyTorch counterpart of ``repro.serve.streams`` (a copy on the port's events).

A coalesced batch runs many tenants' cells through ONE
:func:`repro_torch.api.run_sweep_cells` call; each tenant still observes the exact
typed event stream a solo :class:`repro_torch.api.Session` would have produced.
:func:`replay_events` reconstructs that stream from a
:class:`~repro_torch.api.sweep.SweepVariant`'s per-round accounting
(``variant.rounds``) and eval-boundary records, mirroring
``Session._generate_scan`` in the deferred eval modes: every round emits a
``RoundEvent`` (plus ``SyncEvent`` on full-K barriers), then all
``EvalEvent`` certificates arrive in one trailing batch, then ``StopEvent``.
Bit-identity is pinned by tests/test_torch_service.py: same floats, same ordering,
same event types as ``Session(executor="scan")`` -- which is itself pinned
bit-identical to the event-queue engine.

:class:`JobHandle` is the consumer half: a thread-safe queue of events that
the service's dispatcher feeds (batched or solo lane alike) and the tenant
drains -- iterate :meth:`JobHandle.events` live, or call
:meth:`JobHandle.result` to block for the folded ``RunResult``.  Failures
travel the same channel: an executor error surfaces as a raised exception at
the consuming end, never a hang.
"""

from __future__ import annotations

import dataclasses
import queue as queue_lib  # analysis: host-ok
import threading
from typing import Iterator

from repro_torch.api.session import (
    EvalEvent,
    RoundEvent,
    SessionEvent,
    StopEvent,
    SyncEvent,
)
from repro_torch.core.acpd import RunResult


def replay_events(variant) -> list[SessionEvent]:
    """The solo-Session event sequence of one sweep cell (deferred evals).

    Requires ``variant.rounds`` (explicit-cell sweeps populate it); the
    replay is pure host bookkeeping -- the compiled batch already produced
    every number it emits.
    """
    if variant.rounds is None:
        raise ValueError(
            "variant carries no per-round accounting (rounds=None); serve "
            "batches must run through run_sweep_cells, which populates it")
    events: list[SessionEvent] = []
    iteration = 0
    for acct in variant.rounds:
        iteration += 1
        events.append(RoundEvent(
            iteration=iteration, sim_time=acct.sim_time,
            arrivals=acct.arrivals, bytes_up=acct.bytes_up,
            bytes_down=acct.bytes_down, compute_time=acct.compute_time,
            comm_time=acct.comm_time))
        if acct.is_sync:
            events.append(SyncEvent(iteration=iteration,
                                    sim_time=acct.sim_time))
    for rec in variant.result.records:
        events.append(EvalEvent(**dataclasses.asdict(rec)))
    events.append(StopEvent(
        reason="completed", iteration=iteration,
        sim_time=variant.rounds[-1].sim_time if variant.rounds else 0.0))
    return events


class JobHandle:
    """One tenant request's stream endpoint (thread-safe, single consumer)."""

    def __init__(self, job_id: str, tenant: str):
        self.job_id = job_id
        self.tenant = tenant
        self._queue: queue_lib.Queue = queue_lib.Queue()
        self._result: RunResult | None = None
        self._error: BaseException | None = None
        self._done = threading.Event()

    # -- producer side (the service dispatcher) ----------------------------

    def _push(self, event: SessionEvent) -> None:
        self._queue.put(event)

    def _finish(self, result: RunResult) -> None:
        # First terminal outcome wins: the teardown poison-pill and a racing
        # delivery (or an abandoned deadline attempt) must not clobber each
        # other, so termination is idempotent.
        if self._done.is_set():
            return
        self._result = result
        self._done.set()
        self._queue.put(None)  # wake the consumer

    def _fail(self, error: BaseException) -> None:
        if self._done.is_set():
            return
        self._error = error
        self._done.set()
        self._queue.put(None)

    # -- consumer side (the tenant) ----------------------------------------

    def events(self, timeout: float | None = None) -> Iterator[SessionEvent]:
        """Yield events as they arrive until the stream's ``StopEvent``.

        Raises the job's error (executor failure) instead of hanging;
        ``timeout`` bounds the wait for EACH event (``queue.Empty`` on
        expiry), not the whole stream.
        """
        while True:
            item = self._queue.get(timeout=timeout)
            if item is None:
                if self._error is not None:
                    raise self._error
                return
            yield item
            if isinstance(item, StopEvent):
                # the terminal sentinel is still queued; drain it so a
                # second .events() call (or .result()) sees a clean queue
                continue

    def result(self, timeout: float | None = None) -> RunResult:
        """Block until the job finishes; returns the folded RunResult."""
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"job {self.job_id} did not finish within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    def done(self) -> bool:
        return self._done.is_set()


def deliver(request, variant):
    """Demux one cell of a finished batch into its request's handle.

    Restores the request's OWN method config on the result (the batch ran
    under the shared template; only ``name`` differs -- gamma/sigma_prime
    were per-cell operands) so ``handle.result().method`` round-trips.
    Returns the delivered ``(events, result)`` pair so the service can feed
    its result cache with exactly what the tenant observed.
    """
    result = dataclasses.replace(variant.result, method=request.entry.config)
    events = replay_events(dataclasses.replace(variant, result=result))
    for event in events:
        request.handle._push(event)
    request.handle._finish(result)
    return events, result
