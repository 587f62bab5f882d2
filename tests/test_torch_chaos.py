"""The port's self-healing serve layer under injected faults, on the CPU.

The contract of tests/test_chaos.py, on ``repro_torch.serve``, always under a
pinned schedule from ``repro_torch.core.faults``:

* a NaN-poisoned cell is masked on its own: only its tenant fails
  (``CellDivergenceError``), every other stream is bit for bit its solo
  ``Session`` run;
* transient faults retry with exact accounting; persistent ones quarantine
  by bisection;
* a deadline overrun requeues the batch on the solo lane while the abandoned
  attempt runs on, on its thread, beside the solo runs -- and corrupts none;
* the circuit breaker opens, fast-fails and closes through a half-open probe;
* a dead dispatcher poisons every stream with ``ServiceStoppedError``;
* a killed checkpointed run resumes bit for bit;
* the HTTP error codes, and the composite ``chaos`` schedule.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import baselines, executor, faults
from repro_torch.core.simulate import ClusterModel
from repro_torch.serve import (
    CellDivergenceError,
    CircuitOpenError,
    CoalescePolicy,
    ExperimentService,
    JobTimeoutError,
    ManualClock,
    RecoveryPolicy,
    ServiceStoppedError,
    SpecValidationError,
    serve_http,
)
from repro_torch.serve.coalesce import batch_key

K, D = 4, 256


def _spec(name="t", method=None, seed=0, num_outer=4, eval_every=2, **kw):
    return api.ExperimentSpec(
        name=name,
        problem=api.ProblemSpec("linear_synthetic",
                                {"num_workers": K, "n_per_worker": 48, "d": D,
                                 "nnz_per_row": 12, "seed": 0, "lam": 1e-3}),
        cluster=ClusterModel(num_workers=K, straggler_sigma=5.0, delay_model="constant"),
        methods=(api.MethodEntry(method or baselines.cocoa_plus(K, H=8), num_outer),),
        eval_every=eval_every, seed=seed, **kw)


def _policy(**kw):
    kw.setdefault("batch", "map")
    kw.setdefault("shard", "none")
    kw.setdefault("max_wait_s", 0.0)
    kw.setdefault("max_tenant_depth", 8)
    return CoalescePolicy(**kw)


def _recovery(**kw):
    kw.setdefault("backoff_base_s", 0.001)
    return RecoveryPolicy(**kw)


def _service(policy=None, **kw):
    return ExperimentService(policy or _policy(), device="cpu", **kw)


def _solo_events(spec):
    entry = spec.methods[0]
    sess = api.Session(spec.problem.build(device="cpu"), entry.config, spec.cluster,
                       num_outer=entry.num_outer, seed=spec.seed,
                       eval_every=spec.eval_every, executor="scan", device="cpu")
    events = list(sess.events())
    return events, sess.result()


def _assert_bit_identical(handle, spec):
    solo_events, solo_result = _solo_events(spec)
    assert list(handle.events(timeout=60)) == solo_events
    np.testing.assert_array_equal(handle.result(timeout=60).w, solo_result.w)


class TestDivergenceMasking:
    @pytest.mark.parametrize("method", ["cocoa_plus", "cocoa_plus_solver", "lag"])
    def test_nan_poison_fails_only_the_poisoned_tenant(self, method):
        """The poisoned cell's gamma is NaN; for cocoa_plus_solver and lag
        sigma' is derived from it and NaN too. The batch still runs in one
        call and captures nothing new."""
        m = {"cocoa_plus": baselines.cocoa_plus(K, H=8),
             "cocoa_plus_solver": baselines.cocoa_plus_solver(K, H=8),
             "lag": baselines.acpd_lag(K, D, B=2, T=2, rho_d=32, H=8)}[method]
        stat = "sweep_lag" if method == "lag" else "sweep"
        specs = {t: _spec(method=m, seed=i, num_outer=1 if method == "lag" else 4)
                 for i, t in enumerate("abcd")}
        svc = _service(recovery=_recovery())
        for t, s in specs.items():
            svc.submit(t, s)
        svc.drain()  # a healthy wave captures the batch's graph
        svc.fault = faults.get_fault("nan_poison")(seed=3, count=1)
        calls, traces = executor.STATS[f"{stat}_calls"], executor.STATS[f"{stat}_traces"]
        handles = {t: svc.submit(t, s) for t, s in specs.items()}
        svc.drain()
        assert executor.STATS[f"{stat}_calls"] == calls + 1
        assert executor.STATS[f"{stat}_traces"] == traces
        assert svc.counters["masked_cells"] == 1 and svc.counters["failed"] == 1
        failed = []
        for t, h in handles.items():
            assert h.done()
            try:
                h.result(timeout=1.0)
            except CellDivergenceError as e:
                assert "masked out" in str(e)
                failed.append(t)
        assert len(failed) == 1
        key = batch_key(specs["a"], specs["a"].methods[0], policy=svc.policy)
        idx = faults.get_fault("nan_poison")(seed=3, count=1).poison_cells(4, key)
        assert list("abcd")[idx[0]] == failed[0]
        for t, h in handles.items():
            if t not in failed:
                _assert_bit_identical(h, specs[t])

    def test_poison_stream_terminates_with_typed_error(self):
        svc = _service(fault=faults.get_fault("nan_poison")(count=1))
        h = svc.submit("a", _spec())
        svc.drain()
        with pytest.raises(CellDivergenceError):
            list(h.events(timeout=5.0))


class TestRetryAndBisect:
    def test_transient_fault_retries_with_exact_accounting(self):
        svc = _service(recovery=_recovery(max_attempts=3),
                       fault=faults.get_fault("transient_executor")(failures=2))
        sa, sb = _spec(seed=0), _spec(seed=1)
        ha, hb = svc.submit("a", sa), svc.submit("b", sb)
        svc.drain()
        c = svc.counters
        assert (c["retries"], c["batches"], c["failed"], c["bisects"]) == (2, 1, 0, 0)
        _assert_bit_identical(ha, sa)
        _assert_bit_identical(hb, sb)

    def test_exhausted_transient_bisects_then_fails_typed(self):
        svc = _service(recovery=_recovery(max_attempts=2),
                       fault=faults.get_fault("transient_executor")(failures=99))
        ha, hb = svc.submit("a", _spec(seed=0)), svc.submit("b", _spec(seed=1))
        svc.drain()
        for h in (ha, hb):
            with pytest.raises(faults.TransientExecutorError):
                h.result(timeout=1.0)
        c = svc.counters
        assert (c["retries"], c["bisects"], c["quarantined"], c["failed"],
                c["batches"]) == (3, 1, 2, 2, 0)

    def test_bisect_isolates_the_poison_request(self, monkeypatch):
        import repro_torch.serve.service as service_mod

        svc = _service(recovery=_recovery())
        specs = {t: _spec(seed=i) for i, t in enumerate("abcd")}
        specs["c"] = dataclasses.replace(specs["c"], seed=7)
        orig = service_mod.run_sweep_cells

        def guarded(problem, method, cells, **kw):
            if any(c.seed == 7 for c in cells):
                raise RuntimeError("persistent poison-cell failure")
            return orig(problem, method, cells, **kw)

        monkeypatch.setattr(service_mod, "run_sweep_cells", guarded)
        handles = {t: svc.submit(t, s) for t, s in specs.items()}
        svc.drain()
        with pytest.raises(RuntimeError, match="poison-cell"):
            handles["c"].result(timeout=1.0)
        c = svc.counters
        assert (c["bisects"], c["quarantined"], c["failed"], c["batches"],
                c["batched_requests"]) == (2, 1, 1, 2, 3)
        for t in "abd":
            _assert_bit_identical(handles[t], specs[t])


class TestDeadlines:
    def test_overrun_batch_runs_on_beside_the_solo_lane(self):
        """The batch sleeps past its deadline inside the watchdog window and is
        requeued solo; the abandoned attempt wakes up and runs the same batch
        on its own thread while the solo lane runs the same requests."""
        svc = _service(recovery=_recovery(batch_deadline_s=0.1),
                       fault=faults.get_fault("slow_batch")(delay_s=0.3,
                                                            slow_attempts=1))
        specs = [_spec(seed=i) for i in range(3)]
        calls = executor.STATS["sweep_calls"]
        handles = [svc.submit(f"t{i}", s) for i, s in enumerate(specs)]
        svc.drain()
        c = svc.counters
        assert (c["timeouts"], c["requeued_solo"], c["solo_requests"], c["failed"],
                c["batches"]) == (1, 3, 3, 0, 0)
        for t in threading.enumerate():
            if t.name.startswith("deadline-batch"):
                t.join(timeout=60)
        assert executor.STATS["sweep_calls"] == calls + 1  # the abandoned attempt ran
        for h, s in zip(handles, specs):
            _assert_bit_identical(h, s)

    def test_solo_deadline_fails_with_typed_timeout(self):
        class SlowSolo(faults.FaultModel):
            fault_name = "test-slow-solo"

            def on_dispatch(self, kind, key, attempt):
                if kind == "solo":
                    import time

                    time.sleep(1.0)

        svc = _service(recovery=_recovery(solo_deadline_s=0.1), fault=SlowSolo())
        h = svc.submit("a", _spec(method=baselines.acpd(K, D, H=8)))
        svc.drain()
        with pytest.raises(JobTimeoutError, match="deadline"):
            h.result(timeout=1.0)
        assert svc.counters["timeouts"] == 1 and svc.counters["failed"] == 1


class TestCircuitBreaker:
    def test_opens_after_threshold_and_fast_fails(self):
        svc = _service(recovery=_recovery(max_attempts=1, max_bisect_depth=0,
                                          breaker_threshold=2, breaker_cooldown_s=30.0),
                       fault=faults.get_fault("compile_failure")(), clock=ManualClock())
        for i in range(2):
            h = svc.submit("a", _spec(seed=i))
            svc.drain()
            with pytest.raises(faults.CompileFailureError):
                h.result(timeout=1.0)
        h = svc.submit("a", _spec(seed=9))
        svc.drain()
        with pytest.raises(CircuitOpenError, match="circuit open"):
            h.result(timeout=1.0)
        assert svc.counters["breaker_rejected"] == 1
        assert svc.stats()["breaker"]["open"]

    def test_half_open_probe_closes_on_success(self):
        clock = ManualClock()
        svc = _service(recovery=_recovery(max_attempts=1, max_bisect_depth=0,
                                          breaker_threshold=1, breaker_cooldown_s=30.0),
                       fault=faults.get_fault("compile_failure")(), clock=clock)
        h = svc.submit("a", _spec())
        svc.drain()
        with pytest.raises(faults.CompileFailureError):
            h.result(timeout=1.0)
        assert svc.stats()["breaker"]["open"]
        clock.advance(30.0)
        svc.fault = faults.NoFault()
        spec = _spec(seed=1)
        h2 = svc.submit("a", spec)
        svc.drain()
        _assert_bit_identical(h2, spec)
        assert svc.stats()["breaker"] == {"open": [], "half_open": []}


class TestPoisonPill:
    def test_dispatcher_death_terminates_every_stream(self):
        svc = _service(_policy(max_wait_s=0.005))

        def boom(*, flush):
            with svc._lock:
                busy = bool(svc._solo or any(svc._pending.values()))
            if busy:
                raise RuntimeError("synthetic dispatcher crash")
            return False

        svc._dispatch_once = boom
        svc.start()
        h = svc.submit("a", _spec())
        with pytest.raises(ServiceStoppedError, match="dispatcher thread died"):
            h.result(timeout=30.0)
        with pytest.raises(ServiceStoppedError):
            list(h.events(timeout=30.0))
        assert svc.health()["status"] == "dead"
        with pytest.raises(ServiceStoppedError, match="cannot accept work"):
            svc.submit("a", _spec())
        svc.stop()

    def test_stop_without_drain_poisons_leftovers(self):
        svc = _service()
        h = svc.submit("a", _spec())
        svc.stop(drain=False)
        with pytest.raises(ServiceStoppedError, match="before this job ran"):
            h.result(timeout=1.0)
        assert svc.health()["status"] == "dead"


class TestCheckpointResume:
    def test_killed_run_resumes_bit_identically(self, tmp_path):
        spec = _spec(num_outer=6, checkpoint_every=2)
        svc1 = _service(checkpoint_dir=str(tmp_path),
                        fault=faults.get_fault("worker_crash")(crashes=0, crash_round=4))
        h1 = svc1.submit("a", spec)
        svc1.drain()
        with pytest.raises(faults.WorkerCrashError, match="resume"):
            h1.result(timeout=1.0)
        saved = sorted(p.name for p in tmp_path.rglob("ckpt_*.npz"))
        assert saved == ["ckpt_00000002.npz", "ckpt_00000004.npz"]
        segs = executor.STATS["lockstep_segment_calls"]
        svc2 = _service(checkpoint_dir=str(tmp_path))
        h2 = svc2.submit("a", spec)
        svc2.drain()
        assert executor.STATS["lockstep_segment_calls"] == segs + 1
        result = h2.result(timeout=30.0)
        solo_events, solo_result = _solo_events(dataclasses.replace(spec,
                                                                    checkpoint_every=None))
        np.testing.assert_array_equal(result.w, solo_result.w)
        np.testing.assert_array_equal(result.alpha, solo_result.alpha)
        assert list(h2.events(timeout=5.0)) == solo_events

    def test_checkpoint_specs_need_a_dir_and_ride_the_solo_lane(self, tmp_path):
        with pytest.raises(SpecValidationError, match="checkpoint_dir"):
            _service().submit("a", _spec(checkpoint_every=2))
        svc = _service(checkpoint_dir=str(tmp_path))
        svc.submit("a", _spec(checkpoint_every=2))
        svc.submit("b", _spec(seed=1))
        assert svc.stats()["pending_solo"] == 1 and svc.stats()["pending_batched"] == 1
        svc.drain()
        assert svc.counters["solo_requests"] == 1


@pytest.fixture
def http_service():
    made = []

    def make(**svc_kw):
        svc = _service(_policy(max_wait_s=0.01), **svc_kw).start()
        server = serve_http(svc, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        made.append((svc, server))
        return svc, f"http://127.0.0.1:{server.server_address[1]}"

    yield make
    for svc, server in made:
        server.shutdown()
        svc.stop()


def _post(base, spec):
    req = urllib.request.Request(f"{base}/submit", method="POST", data=json.dumps(
        {"tenant": "a", "spec": spec if isinstance(spec, dict) else spec.to_dict()}).encode())
    return urllib.request.urlopen(req, timeout=30)


class TestHttpErrors:
    def test_validation_error_is_structured_400(self, http_service):
        _, base = http_service()
        spec = _spec().to_dict()
        spec["problem"]["kind"] = "nope"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base, spec)
        assert ei.value.code == 400
        payload = json.loads(ei.value.read())
        assert payload["error_type"] == "SpecValidationError"
        assert "linear_synthetic" in payload["message"]
        assert payload["error"] == payload["message"]

    @pytest.mark.parametrize("fault,code,error_type", [
        (("nan_poison", {"count": 1}), 422, "CellDivergenceError"),
        (("compile_failure", {}), 500, "CompileFailureError")])
    def test_job_errors_map_to_their_codes(self, http_service, fault, code, error_type):
        _, base = http_service(recovery=_recovery(max_attempts=1, max_bisect_depth=0),
                               fault=faults.get_fault(fault[0])(**fault[1]))
        with _post(base, _spec()) as r:
            job = json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/events/{job['job_id']}", timeout=60)
        assert ei.value.code == code
        payload = json.loads(ei.value.read())
        assert payload["error_type"] == error_type and payload["job_id"] == job["job_id"]

    def test_health_and_fault_counters_in_stats(self, http_service):
        svc, base = http_service(fault=faults.get_fault("nan_poison")(count=1))
        with urllib.request.urlopen(f"{base}/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["dispatcher_alive"]
        with _post(base, _spec()) as r:
            job = json.loads(r.read())
        svc.job(job["job_id"])._done.wait(timeout=60)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["fault_model"] == "nan_poison" and stats["masked_cells"] == 1
        assert stats["breaker"] == {"open": [], "half_open": []}


def test_shuffled_tenants_under_composite_chaos_schedule():
    """8 jobs of 4 tenants, shuffled, under ``chaos``: one deadline overrun
    (the abandoned attempt runs on beside the solo lane), one transient
    fault, one NaN cell. Zero hung jobs, only the poisoned tenant fails,
    survivors bit for bit, exact counters."""
    # A cold first batch in a fresh process can outlast the 0.1 s deadline:
    # warm the sweep path on a service of its own first.
    warm = _service(_policy(max_batch=4))
    for i in range(4):
        warm.submit(f"tenant{i}", _spec(seed=100 + i))
    warm.drain()
    svc = _service(_policy(max_batch=4),
                   recovery=_recovery(max_attempts=3, batch_deadline_s=0.1),
                   fault=faults.get_fault("chaos")(seed=5, delay_s=0.3, poison=1))
    jobs = [(f"tenant{i % 4}", _spec(seed=i)) for i in range(8)]
    handles = {}
    for i in np.random.default_rng(123).permutation(len(jobs)):
        handles[i] = (svc.submit(*jobs[i]), jobs[i][1])
    svc.drain()
    failed = {}
    for i, (h, spec) in handles.items():
        assert h.done()
        try:
            h.result(timeout=60.0)
        except Exception as e:  # analysis: fail-fast-ok (collected and asserted typed below)
            failed[i] = e
    assert len(failed) == 1
    assert isinstance(next(iter(failed.values())), CellDivergenceError)
    for t in threading.enumerate():
        if t.name.startswith("deadline-batch"):
            t.join(timeout=60)
    for i, (h, spec) in handles.items():
        if i not in failed:
            _assert_bit_identical(h, spec)
    c = svc.counters
    assert c["submitted"] == 8
    assert c["timeouts"] == 1 and c["requeued_solo"] == 4 and c["retries"] == 1
    assert c["batches"] == 1 and c["batched_requests"] == 4 and c["solo_requests"] == 4
    assert c["failed"] == 1 and c["masked_cells"] == 1
    assert c["bisects"] == 0 and c["quarantined"] == 0 and c["breaker_rejected"] == 0
    stats = svc.stats()
    assert stats["inflight_by_tenant"] == {}
    assert stats["pending_batched"] == 0 and stats["pending_solo"] == 0
