"""The port's multi-tenant experiment service (``repro_torch.serve``) on the CPU.

The contract of ``repro.serve`` (tests/test_serve.py), on the port:

* admission: typed ``SpecValidationError`` / ``BackpressureError`` with the
  JAX package's texts; a bad spec never reaches a batch;
* coalescing: compatible tenant requests run as ONE ``run_sweep_cells`` call,
  each delivered stream bit for bit the port's solo ``Session`` run, and the
  graph-cache mirror (``CompileCache``) agrees with ``executor.STATS``
  captures -- including batches that differ only in gamma (sigma' derived
  from it) and batches of 3 and 4 cells (one padded bucket);
* fairness, the solo lane, streams, the HTTP front end;
* the same submission schedule through ``repro.serve.ExperimentService``
  (JAX on the CPU) gives equal service counters, equal event-type
  sequences and equal host-side accounting of every record.
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import api as japi
from repro.serve import CoalescePolicy as JPolicy
from repro.serve import ExperimentService as JService
from repro_torch import api
from repro_torch.api.session import EvalEvent, RoundEvent, StopEvent, SyncEvent
from repro_torch.core import baselines, executor, faults
from repro_torch.core.simulate import ClusterModel
from repro_torch.serve import (
    BackpressureError,
    CoalescePolicy,
    ExperimentService,
    SpecValidationError,
    batch_key,
    form_batch,
    serve_http,
    sweep_cache_key,
)
from repro_torch.serve.coalesce import Request

K, D = 4, 256


def _problem_spec(seed=0):
    return api.ProblemSpec("linear_synthetic",
                           {"num_workers": K, "n_per_worker": 48, "d": D,
                            "nnz_per_row": 12, "seed": seed, "lam": 1e-3})


def _cluster(delay="constant", params=None, sigma=5.0):
    return ClusterModel(num_workers=K, straggler_sigma=sigma, delay_model=delay,
                        delay_params=tuple((params or {}).items()))


def _spec(name="t", method=None, cluster=None, seed=0, num_outer=4, eval_every=2, **kw):
    method = method or baselines.cocoa_plus(K, H=8)
    return api.ExperimentSpec(
        name=name, problem=_problem_spec(), cluster=cluster or _cluster(),
        methods=(api.MethodEntry(method, num_outer),), eval_every=eval_every,
        seed=seed, **kw)


def _policy(**kw):
    kw.setdefault("batch", "map")
    kw.setdefault("shard", "none")
    kw.setdefault("max_wait_s", 0.0)
    return CoalescePolicy(**kw)


def _service(policy=None, **kw):
    return ExperimentService(policy or _policy(), device="cpu", **kw)


def _started():
    """A service with its dispatcher thread running. A nonzero max-wait: with
    0 the idle dispatcher spins on the lock and starves the test's thread."""
    return _service(_policy(max_wait_s=0.01)).start()


def _solo_events(spec, method_name=None):
    entry = spec.methods[0] if method_name is None else spec.method_named(method_name)
    sess = api.Session(spec.problem.build(device="cpu"), entry.config, spec.cluster,
                       num_outer=entry.num_outer, seed=spec.seed,
                       eval_every=spec.eval_every, executor="scan", device="cpu")
    events = list(sess.events())
    return events, sess.result()


def _assert_bit_identical(handle, spec):
    solo_events, solo_result = _solo_events(spec)
    assert list(handle.events(timeout=60)) == solo_events
    result = handle.result(timeout=60)
    np.testing.assert_array_equal(result.w, solo_result.w)
    np.testing.assert_array_equal(result.alpha, solo_result.alpha)


# ---------------------------------------------------------------------------
# The device: the card unless named.
# ---------------------------------------------------------------------------


def test_service_runs_on_the_card_unless_given_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ExperimentService()
    svc = _service()
    assert svc.device.type == "cpu"
    assert svc.stats()["devices"] == {"platform": "cpu", "device_count": 1,
                                      "kind": "cpu", "sweep_shards": 1}
    h = svc.submit("a", _spec())
    svc.drain()
    assert h.result(timeout=30).records
    assert svc._problem_for(_spec()).X.device.type == "cpu"


# ---------------------------------------------------------------------------
# Admission: validation and backpressure, with the JAX package's texts.
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_unknown_problem_rejected_at_enqueue(self):
        svc = _service()
        spec = _spec()
        bad = dataclasses.replace(spec, problem=dataclasses.replace(spec.problem,
                                                                    kind="nope"))
        with pytest.raises(SpecValidationError, match="linear_synthetic"):
            svc.submit("a", bad)
        assert svc.stats()["pending_batched"] == 0
        assert svc.counters["rejected_validation"] == 1

    def test_unknown_registry_names_list_entries(self):
        svc = _service()
        spec = _spec(method=dataclasses.replace(baselines.cocoa_plus(K, H=8),
                                                compressor="zstd"))
        with pytest.raises(SpecValidationError, match="topk_q8"):
            svc.submit("a", spec)
        with pytest.raises(SpecValidationError, match="pareto"):
            svc.submit("a", _spec(cluster=ClusterModel(num_workers=K, delay_model="wat")))

    def test_method_selector_errors(self):
        svc = _service()
        with pytest.raises(SpecValidationError, match="no method named"):
            svc.submit("a", _spec(), method="nope")
        spec = _spec()
        multi = dataclasses.replace(spec, methods=spec.methods + (
            api.MethodEntry(baselines.cocoa_v1(K, H=8), 4),))
        with pytest.raises(SpecValidationError, match="method=<name>"):
            svc.submit("a", multi)
        h = svc.submit("a", multi, method="CoCoA+")
        svc.drain()
        assert h.result().method.name == "CoCoA+"

    def test_texts_equal_the_jax_package(self):
        ours = _service(_policy(max_tenant_depth=1))
        theirs = JService(JPolicy(batch="map", shard="none", max_wait_s=0.0,
                                  max_tenant_depth=1))
        jspec = japi.ExperimentSpec.from_dict(_spec().to_dict())
        bad = _spec().to_dict()
        bad["problem"]["kind"] = "nope"
        texts = []
        for svc, spec in ((ours, _spec()), (theirs, jspec)):
            got = []
            for call in (lambda: svc.submit_json("a", json.dumps(bad)),
                         lambda: svc.submit_json("a", "{not json"),
                         lambda: svc.submit("a", spec, method="nope")):
                with pytest.raises(Exception) as e:
                    call()
                got.append((type(e.value).__name__, str(e.value)))
            svc.submit("a", spec)
            with pytest.raises(Exception) as e:
                svc.submit("a", spec)
            got.append((type(e.value).__name__, str(e.value)))
            texts.append(got)
        assert texts[0] == texts[1]

    def test_backpressure_typed_rejection_not_hang(self):
        svc = _service(_policy(max_tenant_depth=2))
        svc.submit("a", _spec())
        svc.submit("a", _spec())
        with pytest.raises(BackpressureError, match="max_tenant_depth=2"):
            svc.submit("a", _spec())
        svc.submit("b", _spec())
        assert svc.counters["rejected_backpressure"] == 1
        svc.drain()
        h = svc.submit("a", _spec())
        svc.drain()
        assert h.done()


# ---------------------------------------------------------------------------
# Coalescing: one dispatch, one capture, bit-identical streams.
# ---------------------------------------------------------------------------


class TestCoalescing:
    def test_two_tenants_share_one_dispatch_and_capture(self):
        svc = _service()
        m = baselines.cocoa_plus(K, H=8)
        sa = _spec("alice-exp", method=m)
        sb = _spec("bob-exp", method=dataclasses.replace(m, gamma=0.5),
                   cluster=_cluster("shifted_exponential", {"tail_mean": 1.0}))
        calls = executor.STATS["sweep_calls"]
        ha, hb = svc.submit("alice", sa), svc.submit("bob", sb)
        svc.drain()
        assert executor.STATS["sweep_calls"] == calls + 1
        assert svc.counters["batches"] == 1 and svc.counters["batched_requests"] == 2
        assert svc.stats()["coalesce_factor"] == 2.0
        prob = svc._problem_for(sa)
        keys = [sweep_cache_key(prob, s.methods[0].config, 2, num_outer=4, eval_every=2,
                                batch="map") for s in (sa, sb)]
        assert keys[0] == keys[1]
        _assert_bit_identical(ha, sa)
        _assert_bit_identical(hb, sb)

    @pytest.mark.parametrize("batch", ["map", "vmap"])
    def test_cache_mirror_agrees_with_captures(self, batch):
        """A mirrored hit means no capture: for a method whose sigma' comes
        from gamma (cocoa_plus_solver), a wave differing only in seeds and
        gammas, and waves of 3 and 4 cells (one bucket), capture nothing new."""
        svc = _service(_policy(batch=batch))
        m = baselines.cocoa_plus_solver(K, H=8)
        assert m.sigma_prime is None

        def wave(n, seed0, gammas):
            hs = [(svc.submit(f"t{i}", s), s) for i, s in enumerate(
                _spec(method=dataclasses.replace(m, gamma=gammas[i % len(gammas)]),
                      seed=seed0 + i, num_outer=3, eval_every=1) for i in range(n))]
            svc.drain()
            return hs

        executor.clear_cache()
        traces = executor.STATS["sweep_traces"]
        first = wave(3, 0, (0.5, 1.0))
        assert executor.STATS["sweep_traces"] == traces + 1
        assert svc.compile_cache.stats()["misses"] == 1
        second = wave(4, 10, (0.25, 0.75))  # other seeds and gammas, 4 cells
        assert executor.STATS["sweep_traces"] == traces + 1
        assert svc.compile_cache.hits == 1 and svc.compile_cache.misses == 1
        for h, spec in first + second:
            if batch == "map":
                _assert_bit_identical(h, spec)
            else:
                _, solo = _solo_events(spec)
                np.testing.assert_allclose(h.result().w, solo.w, rtol=1e-5, atol=1e-7)

    def test_warm_cache_hit_on_repeat_batch_shape(self):
        svc = _service()
        for _ in range(2):
            svc.submit("a", _spec())
            svc.submit("b", _spec(seed=0, cluster=_cluster(sigma=2.0)))
            svc.drain()
        assert svc.compile_cache.stats() == {"entries": 1, "hits": 1, "misses": 1,
                                             "hit_rate": 0.5}

    def test_incompatible_keys_do_not_coalesce(self):
        svc = _service()
        svc.submit("a", _spec(num_outer=4))
        svc.submit("b", _spec(num_outer=6))
        svc.drain()
        assert svc.counters["batches"] == 2
        assert svc.stats()["coalesce_factor"] == 1.0

    def test_lag_tenants_coalesce_across_delay_models(self):
        m = baselines.acpd_lag(K, D, B=2, T=2, rho_d=32, gamma=0.5, H=8)
        sa = _spec("a", method=m, cluster=_cluster("pareto", {"shape": 1.8, "scale": 0.5}))
        sb = _spec("b", method=dataclasses.replace(m, gamma=0.25),
                   cluster=_cluster("shifted_exponential", {"tail_mean": 1.0}))
        svc = _service()
        lag_calls = executor.STATS["sweep_lag_calls"]
        ha, hb = svc.submit("a", sa), svc.submit("b", sb)
        svc.drain()
        assert executor.STATS["sweep_lag_calls"] == lag_calls + 1
        _assert_bit_identical(ha, sa)
        _assert_bit_identical(hb, sb)

    def test_solo_lane_group_protocol_and_early_stop(self):
        svc = _service()
        hg = svc.submit("a", _spec(method=baselines.acpd(K, D, H=8)))
        hs = svc.submit("a", _spec(target_gap=1e-12))
        svc.drain()
        assert svc.counters["solo_requests"] == 2 and svc.counters["batches"] == 0
        assert isinstance(list(hg.events())[-1], StopEvent)
        assert hs.result().records

    def test_failed_batch_raises_not_hangs(self, monkeypatch):
        import repro_torch.serve.service as service_mod

        svc = _service()
        h = svc.submit("a", _spec())

        def boom(*a, **k):
            raise RuntimeError("synthetic executor failure")

        monkeypatch.setattr(service_mod, "run_sweep_cells", boom)
        svc.drain()
        with pytest.raises(RuntimeError, match="synthetic"):
            h.result(timeout=1.0)
        assert svc.counters["failed"] == 1
        monkeypatch.undo()
        svc.submit("a", _spec())
        svc.drain()


# ---------------------------------------------------------------------------
# Fairness.
# ---------------------------------------------------------------------------


class TestFairness:
    def test_round_robin_across_tenants(self):
        spec = _spec()
        reqs = [Request("slow", spec, spec.methods[0], None, i) for i in range(6)]
        reqs.append(Request("fast", spec, spec.methods[0], None, 6))
        picked = form_batch(reqs, max_batch=4)
        assert [r.tenant for r in picked].count("fast") == 1
        slow = [r.order for r in picked if r.tenant == "slow"]
        assert slow == sorted(slow) == [0, 1, 2]

    def test_fast_tenant_not_starved_end_to_end(self):
        svc = _service(_policy(max_batch=2, max_tenant_depth=8))
        slow = [svc.submit("slow", _spec(seed=i)) for i in range(4)]
        fast = svc.submit("fast", _spec(seed=9))
        svc._dispatch_once(flush=True)
        assert fast.done()
        assert sum(h.done() for h in slow) == 1
        svc.drain()
        assert all(h.done() for h in slow)

    def test_batch_key_groups_what_should_group(self):
        pol = _policy()
        a = _spec("a")
        b = _spec("b", cluster=_cluster("pareto", {"shape": 1.8, "scale": 0.5}), seed=3)
        c = _spec("c", method=dataclasses.replace(baselines.cocoa_plus(K, H=8), gamma=0.25,
                                                  name="other"))
        assert (batch_key(a, a.methods[0], policy=pol) == batch_key(b, b.methods[0], policy=pol)
                == batch_key(c, c.methods[0], policy=pol))
        h = _spec("d", method=baselines.cocoa_plus(K, H=16))
        assert batch_key(a, a.methods[0], policy=pol) != batch_key(h, h.methods[0], policy=pol)


# ---------------------------------------------------------------------------
# Streams and HTTP.
# ---------------------------------------------------------------------------


class TestStreamsAndHttp:
    def test_event_stream_types_and_order(self):
        svc = _service()
        h = svc.submit("a", _spec())
        svc.drain()
        kinds = [type(e) for e in h.events(timeout=5.0)]
        assert kinds[0] is RoundEvent and kinds[-1] is StopEvent
        assert SyncEvent in kinds and EvalEvent in kinds
        last_round = max(i for i, k in enumerate(kinds) if k is RoundEvent)
        assert min(i for i, k in enumerate(kinds) if k is EvalEvent) > last_round

    def test_dispatcher_thread_end_to_end(self):
        svc = ExperimentService(CoalescePolicy(max_batch=8, max_wait_s=0.02,
                                               max_tenant_depth=8, batch="map",
                                               shard="none"), device="cpu").start()
        try:
            ha, hb = svc.submit("alice", _spec()), svc.submit("bob", _spec(seed=1))
            assert ha.result(timeout=120).records and hb.result(timeout=120).records
            assert svc.counters["batches"] >= 1
        finally:
            svc.stop()

    def test_http_round_trip(self):
        svc = _started()
        server = serve_http(svc, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        try:
            spec = _spec()
            body = json.dumps({"tenant": "alice", "spec": spec.to_dict()}).encode()
            req = urllib.request.Request(f"{base}/submit", data=body, method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                job = json.loads(r.read())
            assert job["tenant"] == "alice"
            with urllib.request.urlopen(f"{base}/events/{job['job_id']}", timeout=120) as r:
                payload = json.loads(r.read())
            solo_events, _ = _solo_events(spec)
            from repro_torch.serve import event_from_dict

            assert [event_from_dict(e) for e in payload["events"]] == solo_events
            with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
                stats = json.loads(r.read())
            assert stats["submitted"] >= 1 and "compile_cache" in stats
            assert stats["devices"]["platform"] == "cpu"
        finally:
            server.shutdown()
            svc.stop()

    def test_http_rejects_bad_spec_with_listing(self):
        svc = _started()
        server = serve_http(svc, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            spec = _spec().to_dict()
            spec["problem"]["kind"] = "nope"
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/submit",
                data=json.dumps({"tenant": "a", "spec": spec}).encode(), method="POST")
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            assert ei.value.code == 400
            assert "linear_synthetic" in json.loads(ei.value.read())["error"]
        finally:
            server.shutdown()
            svc.stop()


# ---------------------------------------------------------------------------
# The same schedule through the JAX package's service.
# ---------------------------------------------------------------------------


def _schedule():
    """Specs as JSON: lockstep tenants over three delay models, two gammas,
    two round budgets, two waves of 3 and 4 cells, a time-budgeted spec (solo
    lane), and a multi-method spec; every record's accounting is host-side."""
    m = baselines.cocoa_plus_solver(K, H=8)
    waves = []
    for wave, n in ((0, 3), (1, 4)):
        specs = []
        for i in range(n):
            delay = ("constant", "pareto", "shifted_exponential")[i % 3]
            params = {"pareto": {"shape": 1.8, "scale": 0.5},
                      "shifted_exponential": {"tail_mean": 1.0}}.get(delay)
            specs.append((f"tenant{i % 2}", _spec(
                f"w{wave}-{i}", method=dataclasses.replace(m, gamma=(0.5, 1.0)[i % 2]),
                cluster=_cluster(delay, params, sigma=2.0 + i), seed=wave * 10 + i,
                num_outer=3 + wave, eval_every=1 + i % 2), None))
        waves.append(specs)
    waves.append([("solo", _spec("tb", time_budget=12.0, num_outer=6), None)])
    return [[(t, s.to_dict(), meth) for t, s, meth in w] for w in waves]


FIELDS = ("iteration", "sim_time", "bytes_up", "bytes_down", "compute_time", "comm_time")


@pytest.mark.parametrize("fault", [None, ("nan_poison", {"seed": 3, "count": 1}),
                                   ("transient_executor", {"failures": 1})])
def test_same_schedule_as_the_jax_service(fault):
    from repro.core import faults as jfaults
    from repro.serve import RecoveryPolicy as JRecovery
    from repro_torch.serve import RecoveryPolicy

    runs = []
    for side in ("torch", "jax"):
        if side == "torch":
            svc = ExperimentService(_policy(max_batch=4), device="cpu",
                                    recovery=RecoveryPolicy(backoff_base_s=0.001),
                                    fault=None if fault is None else faults.get_fault(
                                        fault[0])(**fault[1]))
            load = api.ExperimentSpec.from_dict
        else:
            svc = JService(JPolicy(batch="map", shard="none", max_wait_s=0.0, max_batch=4),
                           recovery=JRecovery(backoff_base_s=0.001),
                           fault=None if fault is None else jfaults.get_fault(
                               fault[0])(**fault[1]))
            load = japi.ExperimentSpec.from_dict
        outcomes = []
        for wave in _schedule():
            handles = [svc.submit(t, load(d), method=meth) for t, d, meth in wave]
            svc.drain()
            for h in handles:
                events = list(h._queue.queue)
                kinds = [type(e).__name__ for e in events if e is not None]
                err = None
                try:
                    res = h.result(timeout=60)
                    acct = [tuple(getattr(r, f) for f in FIELDS) for r in res.records]
                except Exception as e:  # analysis: fail-fast-ok (the typed outcome is compared)
                    err, acct = type(e).__name__, None
                rounds = [tuple(getattr(e, f) for f in ("iteration", "sim_time", "arrivals",
                                                         "bytes_up", "bytes_down"))
                          for e in events if type(e).__name__ == "RoundEvent"]
                outcomes.append((kinds, acct, rounds, err))
        stats = svc.stats()
        counters = {k: v for k, v in stats.items()
                    if isinstance(v, (int, float)) and not isinstance(v, bool)}
        runs.append((outcomes, counters, stats["compile_cache"], stats["result_cache"],
                     stats["inflight_by_tenant"]))
    assert runs[0] == runs[1]
