"""The port's replicated serve cluster on the CPU: leases, delivery, takeover.

The contract of tests/test_cluster.py, on ``repro_torch.serve``:

* lease acquisition is mutually exclusive under concurrent claimants, and
  takeover of an expired lease has one winner with the epoch bumped;
* a cluster delivers every tenant's stream bit for bit the port's solo
  ``Session`` run;
* a replica killed mid-checkpoint-segment leaves its lease to expire and a
  peer resumes from the shared checkpoints bit for bit;
* delivery is exactly once under ``net_duplicate`` and converges under
  ``net_drop``; nothing hangs under ``net_partition``;
* replaying one ``(seed, fault model, submission order)`` schedule gives the
  same counters -- the JAX package's counters too;
* the result cache; and one subprocess replica, ``python -m repro_torch serve
  --replica-of ... --device cpu``, SIGKILLed and taken over by a peer.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import numpy as np
import pytest

from repro_torch import api
from repro_torch.core import baselines, faults
from repro_torch.core.simulate import ClusterModel
from repro_torch.serve import (
    CellDivergenceError,
    ClusterClient,
    ClusterReplica,
    ClusterUnavailableError,
    CoalescePolicy,
    ExperimentService,
    LeaseManager,
    ManualClock,
    RecoveryPolicy,
    SpecValidationError,
    TTLCache,
    job_key,
    run_cluster,
)

K, D = 4, 256
REPO = pathlib.Path(__file__).resolve().parents[1]


def _spec(name="t", seed=0, num_outer=4, eval_every=2, **kw):
    return api.ExperimentSpec(
        name=name,
        problem=api.ProblemSpec("linear_synthetic",
                                {"num_workers": K, "n_per_worker": 48, "d": D,
                                 "nnz_per_row": 12, "seed": 0, "lam": 1e-3}),
        cluster=ClusterModel(num_workers=K, straggler_sigma=5.0, delay_model="constant"),
        methods=(api.MethodEntry(baselines.cocoa_plus(K, H=8), num_outer),),
        eval_every=eval_every, seed=seed, **kw)


def _policy():
    return CoalescePolicy(batch="map", shard="none", max_wait_s=0.0, max_tenant_depth=8)


def _service_kwargs():
    return dict(policy=_policy(), recovery=RecoveryPolicy(backoff_base_s=0.001),
                device="cpu")


def _replicas(cluster_dir, clock, ids, fault_by_id=None, **kw):
    fault_by_id = fault_by_id or {}
    return [ClusterReplica(cluster_dir, rid, clock=clock, fault=fault_by_id.get(rid),
                           service_kwargs=_service_kwargs(), **kw) for rid in ids]


def _solo_events(spec):
    entry = spec.methods[0]
    sess = api.Session(spec.problem.build(device="cpu"), entry.config, spec.cluster,
                       num_outer=entry.num_outer, seed=spec.seed,
                       eval_every=spec.eval_every, device="cpu")
    events = list(sess.events())
    return events, sess.result()


def _reference_run(spec, checkpoint_dir):
    """An uninterrupted run of ``spec`` through a solo service."""
    svc = ExperimentService(_policy(), checkpoint_dir=checkpoint_dir, device="cpu")
    h = svc.submit("ref", spec)
    svc.drain()
    return list(h.events(timeout=60)), h.result(timeout=60)


class TestLeases:
    def test_concurrent_claim_has_exactly_one_winner(self, tmp_path):
        n = 8
        managers = [LeaseManager(tmp_path, f"r{i}") for i in range(n)]
        barrier = threading.Barrier(n)
        wins = [None] * n

        def claim(i):
            barrier.wait()
            wins[i] = managers[i].try_acquire("job-x", epoch=0)

        threads = [threading.Thread(target=claim, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = [i for i, w in enumerate(wins) if w is not None]
        assert len(winners) == 1
        assert managers[0].read_lease("job-x")["owner"] == f"r{winners[0]}"

    def test_concurrent_takeover_has_exactly_one_winner(self, tmp_path):
        clock = ManualClock()
        owner = LeaseManager(tmp_path, "dead", clock=clock, lease_ttl_s=5.0)
        owner.heartbeat()
        assert owner.try_acquire("job-x") is not None
        clock.advance(6.0)
        managers = [LeaseManager(tmp_path, f"r{i}", clock=clock, lease_ttl_s=5.0)
                    for i in range(6)]
        for m in managers:
            m.heartbeat()
        barrier = threading.Barrier(6)
        wins = [None] * 6

        def steal(i):
            barrier.wait()
            wins[i] = managers[i].try_takeover("job-x")

        threads = [threading.Thread(target=steal, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = [i for i, w in enumerate(wins) if w is not None]
        assert len(winners) == 1
        lease = owner.read_lease("job-x")
        assert lease["owner"] == f"r{winners[0]}" and lease["epoch"] == 1

    def test_epoch_fences_a_superseded_owner(self, tmp_path):
        clock = ManualClock()
        r0 = LeaseManager(tmp_path, "r0", clock=clock, lease_ttl_s=5.0)
        r1 = LeaseManager(tmp_path, "r1", clock=clock, lease_ttl_s=5.0)
        r0.heartbeat()
        r1.heartbeat()
        assert r0.try_acquire("j") is not None and r0.still_owner("j", 0)
        clock.advance(6.0)
        r1.heartbeat()
        stolen = r1.try_takeover("j")
        assert stolen is not None and stolen["epoch"] == 1
        assert not r0.still_owner("j", 0) and not r0.release("j", 0)
        assert r1.still_owner("j", 1) and r1.release("j", 1)

    def test_membership_ages_and_retire_withdraws(self, tmp_path):
        clock = ManualClock()
        r0 = LeaseManager(tmp_path, "r0", clock=clock, lease_ttl_s=5.0)
        r1 = LeaseManager(tmp_path, "r1", clock=clock, lease_ttl_s=5.0)
        r0.heartbeat()
        clock.advance(3.0)
        r1.heartbeat()
        m = r0.membership()
        assert m["r0"]["age_s"] == 3.0 and m["r0"]["alive"] and m["r1"]["alive"]
        clock.advance(3.0)
        assert not r0.membership()["r0"]["alive"]
        r1.retire()
        assert "r1" not in r0.membership()
        assert r1.try_takeover("nothing") is None


class TestClusterDelivery:
    def test_cluster_run_is_bit_identical_to_solo(self, tmp_path):
        clock = ManualClock()
        replicas = _replicas(tmp_path, clock, ["r0", "r1", "r2"])
        client = ClusterClient(tmp_path, clock=clock)
        specs = {"alice": _spec(seed=0), "bob": _spec(seed=1)}
        keys = {t: client.submit(t, s) for t, s in specs.items()}
        summary = run_cluster(replicas, client)
        assert summary["hung_jobs"] == 0 and not summary["dead"]
        for tenant, spec in specs.items():
            events, result = client.try_result(keys[tenant])
            solo_events, solo_result = _solo_events(spec)
            assert events == solo_events
            np.testing.assert_array_equal(result.w, solo_result.w)
            np.testing.assert_array_equal(result.alpha, solo_result.alpha)
        assert replicas[0].service.device.type == "cpu"

    def test_job_key_and_resubmission(self, tmp_path):
        a = _spec(seed=0)
        assert job_key("t", a, None) == job_key("t", _spec(seed=0), None)
        assert job_key("t", a, None) != job_key("u", a, None)
        assert job_key("t", a, None) != job_key("t", _spec(seed=1), None)
        clock = ManualClock()
        replicas = _replicas(tmp_path, clock, ["r0"])
        client = ClusterClient(tmp_path, clock=clock)
        assert client.submit("t", a) == client.submit("t", _spec(seed=0))
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert replicas[0].counters["completed"] == 1
        assert len(list((tmp_path / "results").glob("*.json"))) == 1
        with pytest.raises(SpecValidationError):
            client.submit("t", _spec(checkpoint_every=0))

    def test_replica_error_arrives_as_the_original_typed_error(self, tmp_path):
        clock = ManualClock()
        replicas = _replicas(tmp_path, clock, ["r0"], fault_by_id={
            "r0": faults.get_fault("nan_poison")(seed=3, count=1)})
        client = ClusterClient(tmp_path, clock=clock)
        key = client.submit("t", _spec(seed=0))
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert replicas[0].counters["errored"] == 1
        with pytest.raises(CellDivergenceError):
            client.try_result(key)

    def test_health_reports_cluster_membership_and_leases(self, tmp_path):
        clock = ManualClock()
        replicas = _replicas(tmp_path, clock, ["r0", "r1"])
        client = ClusterClient(tmp_path, clock=clock)
        client.submit("t", _spec(seed=0))
        run_cluster(replicas, client)
        cluster = replicas[0].service.health()["cluster"]
        assert cluster["replica_id"] == "r0"
        assert set(cluster["membership"]) == {"r0", "r1"}
        assert cluster["leases"] == {} and cluster["transport"]["sent"] > 0


class TestKillAndTakeover:
    def test_killed_mid_segment_peer_resumes_bit_identically(self, tmp_path):
        cluster_dir = tmp_path / "cluster"
        spec = _spec(seed=0, num_outer=6, checkpoint_every=2)
        ref_events, ref_result = _reference_run(spec, tmp_path / "ref")
        clock = ManualClock()
        kill = faults.get_fault("replica_kill")(replica="r0", at_segment=2)
        replicas = _replicas(cluster_dir, clock, ["r0", "r1"], fault_by_id={"r0": kill},
                             lease_ttl_s=5.0)
        client = ClusterClient(cluster_dir, clock=clock)
        key = client.submit("t", spec)
        summary = run_cluster(replicas, client, clock=clock, advance_s=1.0)
        assert "checkpoint segment starting round 2" in summary["dead"]["r0"]
        assert summary["hung_jobs"] == 0
        assert replicas[0].counters["claims"] == 1 and replicas[1].counters["takeovers"] == 1
        events, result = client.try_result(key)
        assert events == ref_events
        np.testing.assert_array_equal(result.w, ref_result.w)
        np.testing.assert_array_equal(result.alpha, ref_result.alpha)
        record = json.loads((cluster_dir / "results" / f"{key}.json").read_text())
        assert record["owner"] == "r1" and record["epoch"] == 1

    def test_replica_killed_at_tick_leaves_peers_serving(self, tmp_path):
        clock = ManualClock()
        kill = faults.get_fault("replica_kill")(replica="r0", after_steps=1)
        replicas = _replicas(tmp_path, clock, ["r0", "r1"], fault_by_id={"r0": kill})
        client = ClusterClient(tmp_path, clock=clock)
        keys = [client.submit("t", _spec(seed=i)) for i in range(2)]
        summary = run_cluster(replicas, client, clock=clock, advance_s=1.0)
        assert summary["dead"] == {"r0": "replica r0 killed at scheduler tick 1"}
        assert summary["hung_jobs"] == 0 and replicas[1].counters["completed"] == 2
        assert all(client.try_result(k) is not None for k in keys)


class TestNetworkFaults:
    def test_exactly_once_under_duplication(self, tmp_path):
        clock = ManualClock()
        dup = faults.get_fault("net_duplicate")
        replicas = _replicas(tmp_path, clock, ["r0"],
                             fault_by_id={"r0": dup(seed=6, rate=1.0, kinds="result")})
        client = ClusterClient(tmp_path, clock=clock, fault=dup(seed=5, rate=1.0, kinds="job"))
        spec = _spec(seed=0)
        key = client.submit("t", spec)
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert replicas[0].transport.counters["deduped_results"] >= 1
        assert replicas[0].counters["completed"] == 1
        assert len(list((tmp_path / "results").glob("*.json"))) == 1
        events, _ = client.try_result(key)
        assert events == _solo_events(spec)[0]

    def test_at_least_once_converges_under_drops(self, tmp_path):
        clock = ManualClock()
        drop = faults.get_fault("net_drop")
        replicas = _replicas(tmp_path, clock, ["r0"],
                             fault_by_id={"r0": drop(seed=4, rate=0.6, kinds="result")})
        client = ClusterClient(tmp_path, clock=clock, fault=drop(seed=3, rate=0.6, kinds="job"))
        key = client.submit("t", _spec(seed=0))
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert (client.transport.counters["dropped"]
                + replicas[0].transport.counters["dropped"]) >= 1
        assert client.try_result(key) is not None

    def test_partitioned_cluster_never_hangs_the_client(self, tmp_path):
        clock = ManualClock()
        part = faults.get_fault("net_partition")(replica="r0", start_tick=0)
        replicas = _replicas(tmp_path, clock, ["r0"], fault_by_id={"r0": part})
        client = ClusterClient(tmp_path, clock=clock)
        key = client.submit("t", _spec(seed=0))
        summary = run_cluster(replicas, client, max_ticks=10)
        assert summary["hung_jobs"] == 1 and replicas[0].counters["partitioned_ticks"] == 10
        with pytest.raises(ClusterUnavailableError):
            client.result(key, timeout_s=5.0, poll_s=1.0)
        with pytest.raises(ClusterUnavailableError):
            client.events(key, timeout_s=5.0, poll_s=1.0)

    def test_partition_heals_and_a_live_peer_serves(self, tmp_path):
        clock = ManualClock()
        part = faults.get_fault("net_partition")(replica="r0", start_tick=1, duration=3)
        replicas = _replicas(tmp_path / "a", clock, ["r0"], fault_by_id={"r0": part})
        client = ClusterClient(tmp_path / "a", clock=clock)
        key = client.submit("t", _spec(seed=0))
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert replicas[0].counters["partitioned_ticks"] == 3
        assert client.try_result(key) is not None
        forever = faults.get_fault("net_partition")(replica="r0", start_tick=0)
        replicas = _replicas(tmp_path / "b", clock, ["r0", "r1"], fault_by_id={"r0": forever})
        client = ClusterClient(tmp_path / "b", clock=clock)
        key = client.submit("t", _spec(seed=0))
        assert run_cluster(replicas, client)["hung_jobs"] == 0
        assert replicas[1].counters["completed"] == 1 and replicas[0].counters["completed"] == 0


def _chaos_run(cluster_dir, pkg):
    """One cluster_chaos schedule through ``pkg`` (the port or the JAX package)."""
    if pkg == "torch":
        ns = dict(api=api, faults=faults, ClusterModel=ClusterModel,
                  baselines=baselines, serve=__import__("repro_torch.serve").serve)
        kw = {"device": "cpu"}
    else:
        import repro.api as japi
        import repro.core.baselines as jbase
        import repro.core.faults as jfaults
        import repro.core.simulate as jsim
        import repro.serve as jserve

        ns = dict(api=japi, faults=jfaults, ClusterModel=jsim.ClusterModel,
                  baselines=jbase, serve=jserve)
        kw = {}
    serve = ns["serve"]
    clock = serve.ManualClock()
    chaos = ns["faults"].get_fault("cluster_chaos")(seed=11, kill_replica="r0",
                                                   at_segment=2, drop_rate=0.15)
    replicas = [serve.ClusterReplica(
        cluster_dir, rid, clock=clock, fault=chaos if rid == "r0" else None,
        lease_ttl_s=2.5, service_kwargs=dict(
            policy=serve.CoalescePolicy(batch="map", shard="none", max_wait_s=0.0),
            recovery=serve.RecoveryPolicy(backoff_base_s=0.001), **kw))
        for rid in ("r0", "r1", "r2")]
    client = serve.ClusterClient(cluster_dir, clock=clock)
    specs = [ns["api"].ExperimentSpec.from_dict(_spec(seed=i, num_outer=6,
                                                      checkpoint_every=2).to_dict())
             for i in range(3)]
    keys = [client.submit("t", s) for s in specs]
    summary = serve.run_cluster(replicas, client, clock=clock, advance_s=1.0, max_ticks=100)
    return summary, [client.try_result(k) is not None for k in keys]


def test_chaos_schedule_replays_and_matches_the_jax_package(tmp_path):
    first, done_a = _chaos_run(tmp_path / "a", "torch")
    second, done_b = _chaos_run(tmp_path / "b", "torch")
    assert first["hung_jobs"] == 0 and all(done_a) and "r0" in first["dead"]
    assert sum(r["takeovers"] for r in first["replicas"].values()) == 1
    assert first == second and done_a == done_b
    theirs, done_j = _chaos_run(tmp_path / "j", "jax")
    assert first == theirs and done_a == done_j


class TestResultCache:
    def test_lru_and_ttl(self):
        cache = TTLCache(max_entries=2)
        cache.put("a", 1)
        cache.put("b", 2)
        assert cache.get("a") == (True, 1)
        cache.put("c", 3)
        assert cache.get("b") == (False, None) and cache.stats()["evicted_lru"] == 1
        clock = ManualClock()
        cache = TTLCache(max_entries=8, ttl_s=10.0, clock=clock)
        cache.put("a", 1)
        clock.advance(9.0)
        assert cache.get("a") == (True, 1)
        clock.advance(2.0)
        assert cache.get("a") == (False, None) and cache.stats()["evicted_ttl"] == 1
        off = TTLCache(max_entries=0)
        off.put("a", 1)
        assert len(off) == 0

    def test_service_result_cache_short_circuits_identical_work(self):
        svc = ExperimentService(_policy(), result_cache_entries=8, device="cpu")
        h1 = svc.submit("alice", _spec(seed=0))
        svc.drain()
        events1 = list(h1.events(timeout=30))
        batches = svc.counters["batches"]
        h2 = svc.submit("bob", _spec(seed=0))
        assert list(h2.events(timeout=30)) == events1
        np.testing.assert_array_equal(h2.result(timeout=30).w, h1.result(timeout=30).w)
        assert svc.counters["result_cache_hits"] == 1 and svc.counters["batches"] == batches

    def test_service_backoff_runs_on_the_injected_clock(self):
        clock = ManualClock()
        svc = ExperimentService(_policy(), device="cpu",
                                recovery=RecoveryPolicy(backoff_base_s=10.0, max_attempts=3),
                                fault=faults.get_fault("transient_executor")(failures=2),
                                clock=clock)
        h = svc.submit("a", _spec(seed=0))
        svc.drain()
        assert h.result(timeout=30) is not None
        assert svc.counters["retries"] == 2 and clock.monotonic() > 0.0


def _spawn(cluster_dir, replica_id, log, fault=None, params=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "repro_torch", "serve", "--replica-of", str(cluster_dir),
           "--replica-id", replica_id, "--device", "cpu", "--lease-ttl", "2.0",
           "--step-interval", "0.05"]
    if fault is not None:
        cmd += ["--fault-model", fault, "--fault-params", json.dumps(params or {})]
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)


def test_sigkilled_subprocess_replica_is_taken_over(tmp_path):
    cluster_dir = tmp_path / "cluster"
    cluster_dir.mkdir()
    spec = _spec(seed=0, num_outer=6, checkpoint_every=2)
    ref_events, ref_result = _reference_run(spec, tmp_path / "ref")
    client = ClusterClient(cluster_dir)
    key = client.submit("t", spec)
    r1 = None
    with open(tmp_path / "r0.log", "w") as log0, open(tmp_path / "r1.log", "w") as log1:
        r0 = _spawn(cluster_dir, "r0", log0, fault="replica_kill",
                    params={"replica": "r0", "at_segment": 2})
        try:
            r0.wait(timeout=300)
            assert r0.returncode == -signal.SIGKILL
            lease = LeaseManager(cluster_dir, "observer").read_lease(key)
            assert lease is not None and lease["owner"] == "r0"
            r1 = _spawn(cluster_dir, "r1", log1)
            events = client.events(key, timeout_s=300, poll_s=0.2)
            result = client.result(key, timeout_s=10)
        finally:
            for proc in (r0, r1):
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
    assert events == ref_events
    np.testing.assert_array_equal(result.w, ref_result.w)
    np.testing.assert_array_equal(result.alpha, ref_result.alpha)
    record = json.loads((cluster_dir / "results" / f"{key}.json").read_text())
    assert record["owner"] == "r1" and record["epoch"] == 1
