"""The persistent multi-tenant experiment service.

PyTorch counterpart of ``repro.serve.service``: the same admission,
coalescing, recovery and counters, on the port's sweeps and sessions, on one
device (``device=``: the card unless the caller names the CPU).

``ExperimentService`` is the long-lived front of the sweep substrate: tenants
submit one method entry of an :class:`~repro_torch.api.ExperimentSpec` each
(in-process :meth:`~ExperimentService.submit`, or JSON over the stdlib HTTP
front end -- ``python -m repro serve``), and the service

1. **validates at admission** (``spec.validate()``: every registry name plus
   structural invariants, full known-entry listings in the error) so a bad
   spec is rejected synchronously and can never reach a batch and poison its
   cohort;
2. **bounds per-tenant depth** -- submissions past ``max_tenant_depth``
   in-flight jobs raise a typed :class:`BackpressureError` instead of
   queueing unboundedly;
3. **coalesces** compatible requests (same :func:`repro_torch.serve.coalesce.batch_key`)
   into ONE :func:`repro_torch.api.run_sweep_cells` call under the max-wait /
   max-batch policy, round-robin across tenants inside each batch;
4. **streams back** each tenant's typed Round/Sync/Eval/Stop events,
   bit-identical to a solo ``Session`` run (``batch="map"`` default;
   pinned by tests/test_torch_service.py);
5. keeps the **graph cache warm** across tenants (the executor's process-wide
   cache holds the captured graphs; :class:`repro_torch.serve.cache.CompileCache`
   mirrors its keys and reports hit/miss counters through :meth:`stats` /
   ``GET /stats``).

Requests that cannot share a batch -- group-family protocols,
``target_gap``/``time_budget`` early stop (:func:`repro_torch.core.executor.coalesce_supported`),
and checkpointed runs (``spec.checkpoint_every``: snapshots are per-run
state) -- take the **solo lane**: a per-request ``Session`` streamed through
the same ``JobHandle``, so admission control and the API are uniform.

Self-healing (knobs in :class:`repro_torch.serve.recovery.RecoveryPolicy`,
injected failures in :mod:`repro_torch.core.faults`):

* transient batch failures retry with exponential backoff + deterministic
  jitter; persistent ones **quarantine by bisection** -- the cohort splits
  and each half retries independently, so only the poison request fails and
  healthy tenants still get bit-identical results;
* a **watchdog deadline** per dispatch turns overruns into a typed
  :class:`~repro_torch.serve.recovery.JobTimeoutError`; overrun *batches* are
  requeued on the solo lane rather than failed;
* a per-``batch_key`` **circuit breaker** fast-fails keys that keep failing
  (:class:`~repro_torch.serve.recovery.CircuitOpenError`), half-open probe after
  the cooldown;
* **divergence masking**: after every batch, one per-cell finite
  certificate on the host (:func:`repro_torch.core.executor.finite_certificates`) masks
  non-finite cells out of delivery and fails exactly those requests with
  :class:`~repro_torch.serve.recovery.CellDivergenceError`;
* **teardown poison-pill**: if the dispatcher thread dies (or the service
  stops without draining), every unfinished stream terminates with
  :class:`~repro_torch.serve.recovery.ServiceStoppedError` -- never a hang;
* **checkpoint/resume**: specs with ``checkpoint_every`` run as resumable
  scan segments under ``checkpoint_dir``
  (:func:`repro_torch.core.executor.run_lockstep_checkpointed`); a killed service
  resumes them bit-identically from the last snapshot on resubmission.

Threading model: ``submit`` is safe from any thread; one dispatcher thread
(started by :meth:`start`, or driven synchronously by :meth:`drain` for
deterministic tests and batch clients) owns all execution -- except an
attempt abandoned at its deadline, which runs on, on its own thread, beside
the requeued solo runs; the executor's graph lock and the kernels' counters
are safe for that (:mod:`repro_torch.core.executor`).  Datasets are built
once per distinct ``ProblemSpec``, on the service's device, and memoized.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import threading
from typing import Mapping

import numpy as np

import torch

from repro_torch.api import run_sweep_cells
from repro_torch.api.session import Session
from repro_torch.api.spec import ExperimentSpec
from repro_torch.core import executor as executor_lib
from repro_torch.core.faults import FaultModel, NoFault
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.cache import (
    CompileCache,
    TTLCache,
    result_cache_key,
    sweep_cache_key,
    warm_trace_counters,
)
from repro_torch.serve.clock import SYSTEM_CLOCK, Clock
from repro_torch.serve.coalesce import CoalescePolicy, Request, batch_key, form_batch
from repro_torch.serve.recovery import (
    CellDivergenceError,
    CircuitBreaker,
    CircuitOpenError,
    JobTimeoutError,
    RecoveryPolicy,
    ServiceStoppedError,
    backoff_delay,
    is_transient,
    run_with_deadline,
)
from repro_torch.serve.streams import JobHandle, deliver


class SpecValidationError(ValueError):
    """Rejected at admission: the spec names unknown registry entries or
    violates a structural invariant (message lists the known entries)."""


class BackpressureError(RuntimeError):
    """Rejected at admission: the tenant already has ``max_tenant_depth``
    unfinished jobs; retry after draining some."""


class ExperimentService:
    """See module docstring.  One instance per process; thread-safe submit.

    ``device``: where every problem is built and every batch and solo run
    computes -- the card unless given (``"cpu"`` for the host); without a
    card and a named device it raises.
    """

    def __init__(self, policy: CoalescePolicy | None = None, *,
                 recovery: RecoveryPolicy | None = None,
                 fault: FaultModel | None = None,
                 checkpoint_dir=None, clock: Clock | None = None,
                 result_cache_entries: int = 0,
                 result_cache_ttl_s: float | None = None,
                 problem_cache_entries: int = 32,
                 problem_cache_ttl_s: float | None = None,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.policy = policy or CoalescePolicy()
        self.recovery = recovery or RecoveryPolicy()
        self.fault = fault or NoFault()
        self.checkpoint_dir = checkpoint_dir
        self.clock = clock or SYSTEM_CLOCK
        self.compile_cache = CompileCache()
        # Result cache is OPT-IN (entries=0 disables): serving a repeat from
        # cache skips the dispatch entirely, which is the point -- but would
        # silently invalidate dispatch/trace counter pins in callers that
        # resubmit identical specs to measure warm-compile behavior.
        self.result_cache = TTLCache(max_entries=result_cache_entries,
                                     ttl_s=result_cache_ttl_s,
                                     clock=self.clock)
        self.breaker = CircuitBreaker(self.recovery.breaker_threshold,
                                      self.recovery.breaker_cooldown_s,
                                      clock=self.clock)
        self.cluster_health = None  # set by repro_torch.serve.cluster.ClusterReplica
        self._lock = threading.Condition()
        self._pending: dict[tuple, list[Request]] = {}  # batch_key -> queue
        self._solo: list[Request] = []
        self._group_opened: dict[tuple, float] = {}  # batch_key -> first enqueue time
        self._inflight: dict[str, int] = {}  # tenant -> unfinished jobs
        self._jobs: dict[str, JobHandle] = {}
        self._order = itertools.count()
        self._problems = TTLCache(max_entries=problem_cache_entries,
                                  ttl_s=problem_cache_ttl_s,
                                  clock=self.clock)  # memoized datasets
        self._thread: threading.Thread | None = None
        self._stopping = False
        self._dead: BaseException | None = None  # the teardown poison-pill
        self.counters = {
            "submitted": 0, "rejected_validation": 0,
            "rejected_backpressure": 0, "batches": 0, "batched_requests": 0,
            "solo_requests": 0, "failed": 0,
            # self-healing accounting
            "retries": 0, "bisects": 0, "quarantined": 0, "timeouts": 0,
            "requeued_solo": 0, "masked_cells": 0, "breaker_rejected": 0,
            # result-cache accounting
            "result_cache_hits": 0,
        }

    # -- admission ---------------------------------------------------------

    def submit(self, tenant: str, spec: ExperimentSpec,
               method: str | None = None) -> JobHandle:
        """Admit one request: ``spec``'s method entry named ``method`` (or
        its only entry).  Validates and applies backpressure synchronously;
        returns the tenant's stream handle."""
        if self._dead is not None:
            raise ServiceStoppedError(
                f"service is dead and cannot accept work: {self._dead}")
        try:
            spec.validate()
        except ValueError as e:
            with self._lock:
                self.counters["rejected_validation"] += 1
            raise SpecValidationError(str(e)) from None
        if method is None:
            if len(spec.methods) != 1:
                raise SpecValidationError(
                    f"spec {spec.name!r} has {len(spec.methods)} method "
                    f"entries {[m.config.name for m in spec.methods]}; pass "
                    f"method=<name> to pick one per request")
            entry = spec.methods[0]
        else:
            try:
                entry = spec.method_named(method)
            except KeyError as e:
                with self._lock:
                    self.counters["rejected_validation"] += 1
                raise SpecValidationError(str(e)) from None

        ok, why = executor_lib.coalesce_supported(
            entry.config, spec.cluster, target_gap=spec.target_gap,
            time_budget=spec.time_budget)
        if ok and spec.checkpoint_every is not None:
            ok, why = False, ("checkpoint/resume snapshots are per-run "
                              "state; served per-request on the solo lane")
        if spec.checkpoint_every is not None and self.checkpoint_dir is None:
            raise SpecValidationError(
                f"spec {spec.name!r} sets checkpoint_every but this service "
                f"has no checkpoint_dir; construct "
                f"ExperimentService(checkpoint_dir=...)")

        if self.result_cache.max_entries:
            hit, cached = self.result_cache.get(result_cache_key(spec, entry))
            if hit:
                # Serve the repeat without dispatching: what was cached IS a
                # previously delivered (events, result) pair, so the replay
                # is bit-identical by construction.  No inflight accounting
                # -- the job is already finished when submit returns.
                with self._lock:
                    order = next(self._order)
                    handle = JobHandle(f"job-{order}", tenant)
                    self._jobs[handle.job_id] = handle
                    self.counters["submitted"] += 1
                    self.counters["result_cache_hits"] += 1
                events, result = cached
                for event in events:
                    handle._push(event)
                handle._finish(result)
                return handle

        with self._lock:
            if (self._inflight.get(tenant, 0)
                    >= self.policy.max_tenant_depth):
                self.counters["rejected_backpressure"] += 1
                raise BackpressureError(
                    f"tenant {tenant!r} has {self._inflight[tenant]} "
                    f"unfinished jobs (max_tenant_depth="
                    f"{self.policy.max_tenant_depth}); drain before "
                    f"resubmitting")
            order = next(self._order)
            handle = JobHandle(f"job-{order}", tenant)
            req = Request(tenant=tenant, spec=spec, entry=entry,
                          handle=handle, order=order,
                          solo_reason=None if ok else why)
            if ok:
                key = batch_key(spec, entry, policy=self.policy)
                self._pending.setdefault(key, []).append(req)
                self._group_opened.setdefault(key, self.clock.monotonic())
            else:
                self._solo.append(req)
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._jobs[handle.job_id] = handle
            self.counters["submitted"] += 1
            self._lock.notify_all()
        return handle

    def submit_json(self, tenant: str, text: str,
                    method: str | None = None) -> JobHandle:
        try:
            spec = ExperimentSpec.from_dict(json.loads(text))
        except (KeyError, TypeError, ValueError) as e:
            with self._lock:
                self.counters["rejected_validation"] += 1
            raise SpecValidationError(f"unparseable spec JSON: {e}") from None
        return self.submit(tenant, spec, method=method)

    def job(self, job_id: str) -> JobHandle:
        with self._lock:
            try:
                return self._jobs[job_id]
            except KeyError:
                raise KeyError(f"unknown job {job_id!r}") from None

    # -- execution ---------------------------------------------------------

    def _problem_for(self, spec: ExperimentSpec):
        key = (spec.problem.kind, tuple(sorted(spec.problem.params.items())))
        hit, problem = self._problems.get(key)
        if not hit:
            # Deterministic build: eviction (TTL or LRU) only costs a
            # rebuild, never changes what any tenant observes.
            problem = spec.problem.build(device=self.device)
            self._problems.put(key, problem)
        return problem

    def _count(self, **deltas: int) -> None:
        with self._lock:
            for k, v in deltas.items():
                self.counters[k] += v

    def _fail_requests(self, reqs: list[Request], error: BaseException,
                       **extra_counts: int) -> None:
        self._count(failed=len(reqs), **extra_counts)
        for r in reqs:
            r.handle._fail(error)
            self._job_done(r.tenant)

    def _dispatch_cells(self, reqs: list[Request], key: tuple):
        """ONE cohort through ``run_sweep_cells``, with fault injection, the
        watchdog deadline, and transient-retry backoff.  Returns the
        variants; raises the FINAL error (the original exception -- tenants
        and tests see the real cause, not a wrapper) once retries are
        exhausted or the failure is persistent."""
        first = reqs[0]
        problem = self._problem_for(first.spec)
        method = first.entry.config
        poisoned = set(self.fault.poison_cells(len(reqs), key))
        cells = [dataclasses.replace(r.cell, gamma=math.nan)
                 if i in poisoned else r.cell for i, r in enumerate(reqs)]
        ckey = sweep_cache_key(
            problem, method, len(cells), num_outer=first.entry.num_outer,
            eval_every=first.spec.eval_every, batch=self.policy.batch)
        attempt = 0
        while True:
            if attempt:
                self.clock.sleep(backoff_delay(self.recovery, attempt, key))
                self._count(retries=1)

            def one_attempt(attempt=attempt):
                # Injection happens INSIDE the watchdog window so slow-batch
                # faults genuinely overrun the deadline; the cache mirror is
                # noted once per actual run_sweep_cells invocation.
                self.fault.on_dispatch("batch", key, attempt)
                self.compile_cache.note(ckey)
                return run_sweep_cells(
                    problem, method, cells,
                    num_outer=first.entry.num_outer,
                    eval_every=first.spec.eval_every,
                    batch=self.policy.batch, shard=self.policy.shard)

            try:
                return run_with_deadline(
                    one_attempt, self.recovery.batch_deadline_s,
                    label=f"batch of {len(reqs)}")
            except JobTimeoutError:
                raise
            except Exception as e:  # analysis: fail-fast-ok (retried if transient, re-raised verbatim otherwise)
                if is_transient(e) and attempt + 1 < self.recovery.max_attempts:
                    attempt += 1
                    continue
                raise

    def _execute_cohort(self, reqs: list[Request], key: tuple,
                        depth: int) -> None:
        """Dispatch a cohort; on persistent failure quarantine-and-bisect so
        only the poison requests fail; on success mask non-finite cells and
        deliver the rest bit-identically."""
        try:
            variants = self._dispatch_cells(reqs, key)
        except JobTimeoutError:
            # Overrun: requeue everyone on the solo lane (per-request runs
            # under the solo deadline) instead of failing them.
            self._count(timeouts=1, requeued_solo=len(reqs))
            with self._lock:
                for r in reqs:
                    r.solo_reason = "batch execution deadline overrun"
                    self._solo.append(r)
                self._lock.notify_all()
            return
        except Exception as e:  # analysis: fail-fast-ok (bisected or failed to tenants as the original typed error)
            if len(reqs) == 1 or depth >= self.recovery.max_bisect_depth:
                self.breaker.record_failure(key)
                self._fail_requests(
                    reqs, e, quarantined=len(reqs) if depth else 0)
                return
            self._count(bisects=1)
            mid = len(reqs) // 2
            self._execute_cohort(reqs[:mid], key, depth + 1)
            self._execute_cohort(reqs[mid:], key, depth + 1)
            return

        self.breaker.record_success(key)
        finite = executor_lib.finite_certificates(variants)
        self._count(batches=1, batched_requests=len(reqs))
        for r, v, ok in zip(reqs, variants, np.asarray(finite)):
            if ok:
                events, result = deliver(r, v)
                if self.result_cache.max_entries:
                    self.result_cache.put(result_cache_key(r.spec, r.entry),
                                          (events, result))
            else:
                self._count(failed=1, masked_cells=1)
                r.handle._fail(CellDivergenceError(
                    f"job {r.handle.job_id}: cell produced non-finite "
                    f"iterates and was masked out of the coalesced batch "
                    f"(cohort of {len(reqs)} unaffected)"))
            self._job_done(r.tenant)

    def _run_batch(self, reqs: list[Request]) -> None:
        """One coalesced dispatch: every request's cell through
        ``run_sweep_cells`` (with recovery), results demuxed per handle."""
        first = reqs[0]
        key = batch_key(first.spec, first.entry, policy=self.policy)
        if not self.breaker.allow(key):
            self._fail_requests(
                reqs,
                CircuitOpenError(
                    f"circuit open for this batch template after repeated "
                    f"failures; retry after the "
                    f"{self.recovery.breaker_cooldown_s:g}s cooldown"),
                breaker_rejected=len(reqs))
            return
        self._execute_cohort(reqs, key, depth=0)

    def _run_solo(self, req: Request) -> None:
        """The solo lane: one Session, streamed live into the handle."""
        spec = req.spec
        solo_key = (req.tenant, req.handle.job_id)
        seen: list = []  # live-streamed events, for the result cache

        def drive():
            self.fault.on_dispatch("solo", solo_key, 0)
            hook = None
            ckpt_dir = ckpt_every = None
            if spec.checkpoint_every is not None:
                ckpt_dir = self.checkpoint_dir
                ckpt_every = spec.checkpoint_every
                hook = (lambda start:
                        self.fault.on_dispatch("segment", solo_key, start))
            session = Session(
                self._problem_for(spec), req.entry.config, spec.cluster,
                num_outer=req.entry.num_outer, seed=spec.seed,
                eval_every=spec.eval_every,
                target_gap=spec.target_gap, time_budget=spec.time_budget,
                executor=spec.executor, checkpoint_dir=ckpt_dir,
                checkpoint_every=ckpt_every, device=self.device,
                _segment_hook=hook)
            for event in session.events():
                seen.append(event)
                req.handle._push(event)
            return session.result()

        try:
            result = run_with_deadline(drive, self.recovery.solo_deadline_s,
                                       label=f"solo {req.handle.job_id}")
            req.handle._finish(result)
            if self.result_cache.max_entries:
                self.result_cache.put(result_cache_key(spec, req.entry),
                                      (list(seen), result))
        except Exception as e:  # analysis: fail-fast-ok (delivered to the tenant as the job's typed terminal error)
            req.handle._fail(e)
            self._count(failed=1,
                        timeouts=1 if isinstance(e, JobTimeoutError) else 0)
        else:
            self._count(solo_requests=1)
        self._job_done(req.tenant)

    def _job_done(self, tenant: str) -> None:
        with self._lock:
            self._inflight[tenant] = max(0, self._inflight.get(tenant, 0) - 1)
            self._lock.notify_all()

    # -- dispatch policy ---------------------------------------------------

    def _due_groups(self, now: float, *, flush: bool) -> list[tuple]:
        """Keys whose batch should close now: full, aged out, or flushing."""
        due = []
        for key, reqs in self._pending.items():
            if not reqs:
                continue
            if (flush or len(reqs) >= self.policy.max_batch
                    or now - self._group_opened[key]
                    >= self.policy.max_wait_s):
                due.append(key)
        return due

    def _take_batch(self, key: tuple) -> list[Request]:
        reqs = self._pending[key]
        picked = form_batch(reqs, max_batch=self.policy.max_batch)
        remaining = [r for r in reqs if r not in picked]
        if remaining:
            self._pending[key] = remaining
            self._group_opened[key] = self.clock.monotonic()  # restart the clock
        else:
            del self._pending[key]
            del self._group_opened[key]
        return picked

    def _dispatch_once(self, *, flush: bool) -> bool:
        """Run at most one batch or one solo request; True if work was done.

        Execution happens OUTSIDE the lock -- submissions keep flowing while
        a batch runs.
        """
        with self._lock:
            due = self._due_groups(self.clock.monotonic(), flush=flush)
            if due:
                # oldest group first: bounded wait under cross-key load
                key = min(due, key=lambda k: self._group_opened[k])
                batch = self._take_batch(key)
            elif self._solo:
                batch = None
                solo = self._solo.pop(0)
            else:
                return False
        if due:
            self._run_batch(batch)
        else:
            self._run_solo(solo)
        return True

    def drain(self) -> None:
        """Synchronously run EVERYTHING queued (max-wait ignored: pending
        groups flush at their current size).  The deterministic path for
        tests, benches and one-shot batch clients."""
        while self._dispatch_once(flush=True):
            pass

    # -- the dispatcher thread --------------------------------------------

    def start(self) -> "ExperimentService":
        if self._thread is not None:
            raise RuntimeError("service already started")
        self._stopping = False
        self._thread = threading.Thread(target=self._loop,
                                        name="experiment-service",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, *, drain: bool = True) -> None:
        with self._lock:
            self._stopping = True
            self._lock.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if drain:
            self.drain()
        else:
            # Teardown poison-pill: whatever never ran terminates with a
            # typed error at every waiting consumer -- never a hang.
            self._poison_all(ServiceStoppedError(
                "service stopped before this job ran (stop(drain=False))"))

    def _loop(self) -> None:
        try:
            while True:
                did = self._dispatch_once(flush=False)
                with self._lock:
                    if self._stopping:
                        return
                    if not did:
                        # sleep until new work or the oldest group ages out
                        timeout = self.policy.max_wait_s
                        if self._group_opened:
                            oldest = min(self._group_opened.values())
                            timeout = max(0.0,
                                          oldest + self.policy.max_wait_s
                                          - self.clock.monotonic())
                        self._lock.wait(timeout=min(timeout,
                                                    self.policy.max_wait_s))
        except BaseException as e:  # analysis: fail-fast-ok (the dispatcher's last act is poisoning every stream with a typed error)
            self._poison_all(ServiceStoppedError(
                f"service dispatcher thread died: {e!r}"))

    def _poison_all(self, error: BaseException) -> None:
        """Terminate every unfinished stream with ``error`` and mark the
        service dead.  Idempotent handle termination makes racing deliveries
        safe; subsequent ``submit`` calls raise ``ServiceStoppedError``."""
        with self._lock:
            self._dead = error
            self._pending.clear()
            self._group_opened.clear()
            self._solo.clear()
            self._inflight.clear()
            handles = list(self._jobs.values())
            self._lock.notify_all()
        for h in handles:
            if not h.done():
                h._fail(error)

    # -- observability -----------------------------------------------------

    def health(self) -> dict:
        """Liveness summary for ``GET /health``."""
        with self._lock:
            pending = sum(len(v) for v in self._pending.values())
            solo = len(self._solo)
            dead = self._dead
        alive = self._thread is not None and self._thread.is_alive()
        info = {
            "status": "dead" if dead is not None else "ok",
            "dispatcher_alive": alive,
            "dead_reason": repr(dead) if dead is not None else None,
            "pending_batched": pending,
            "pending_solo": solo,
            "breaker": self.breaker.snapshot(),
            "breaker_states": self.breaker.states(),
        }
        if self.cluster_health is not None:
            # A ClusterReplica wires its membership/lease/heartbeat view in
            # here so GET /health answers for the replicated deployment too.
            info["cluster"] = self.cluster_health()
        return info

    def stats(self) -> dict:
        with self._lock:
            counters = dict(self.counters)
            pending = sum(len(v) for v in self._pending.values())
            solo = len(self._solo)
            inflight = {t: n for t, n in self._inflight.items() if n}
        batches = counters["batches"]
        counters["coalesce_factor"] = (
            counters["batched_requests"] / batches if batches else 0.0)
        return {
            **counters,
            "pending_batched": pending,
            "pending_solo": solo,
            "inflight_by_tenant": inflight,
            "fault_model": self.fault.fault_name,
            "breaker": self.breaker.snapshot(),
            "compile_cache": self.compile_cache.stats(),
            "result_cache": self.result_cache.stats(),
            "problem_cache": self._problems.stats(),
            "trace_counters": warm_trace_counters(),
            "devices": mesh_lib.device_summary(self.device),
        }
