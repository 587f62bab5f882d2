"""The port's fault registry and recovery primitives against the JAX package's.

``repro_torch.core.faults`` is a copy of ``repro.core.faults``: every entry's
decisions (``on_dispatch``, ``poison_cells``, ``message_fate``,
``replica_fate``, ``segment_fate``) must equal the JAX package's bit for bit
over a grid of seeds, keys, attempts and ticks, the spec JSON must round-trip
to the same dicts, and ``key_digest`` must agree. ``backoff_delay`` and the
circuit breaker's lifecycle are held to ``repro.serve.recovery`` the same way.
"""

import json
import time

import pytest

from repro.core import faults as jfaults
from repro.serve import clock as jclock
from repro.serve import recovery as jrecovery
from repro_torch.core import faults
from repro_torch.serve import clock, recovery

# One instance per entry, with non-default parameters.
PARAMS = {
    "none": {"seed": 7},
    "transient_executor": {"seed": 1, "failures": 2},
    "worker_crash": {"seed": 2, "crashes": 1, "crash_round": 5},
    "compile_failure": {"seed": 3},
    "nan_poison": {"seed": 4, "count": 2},
    "slow_batch": {"seed": 5, "delay_s": 0.01, "slow_attempts": 2},
    "chaos": {"seed": 6, "delay_s": 0.02, "poison": 2},
    "net_drop": {"seed": 7, "rate": 0.3},
    "net_duplicate": {"seed": 8, "rate": 0.5, "kinds": "result"},
    "net_reorder": {"seed": 9, "rate": 0.2},
    "net_delay": {"seed": 10, "rate": 0.7, "ticks": 3},
    "net_partition": {"replica": "r1", "start_tick": 2, "duration": 4},
    "replica_kill": {"replica": "r0", "after_steps": 3, "at_segment": 2},
    "cluster_chaos": {"seed": 11, "kill_replica": "r0", "at_segment": 2,
                      "drop_rate": 0.25},
}
KEYS = [("batch", 0), ("a", ("k", 1.5), None), "job-7", ("t", "job-3"), 12345]


def test_registry_equals_the_jax_package():
    assert faults.available_faults() == jfaults.available_faults()
    assert set(PARAMS) == set(faults.available_faults())
    with pytest.raises(ValueError, match="unknown fault model"):
        faults.get_fault("nope")
    with pytest.raises(ValueError, match="unknown fault model"):
        faults.fault_from_spec({"fault_model": "nope"})
    for name in faults.available_faults():
        assert faults.get_fault(name).stateful == jfaults.get_fault(name).stateful
    assert faults.MESSAGE_KINDS == jfaults.MESSAGE_KINDS


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_spec_round_trips_to_the_jax_spec(name):
    model = faults.get_fault(name)(**PARAMS[name])
    spec = model.spec()
    assert spec == jfaults.get_fault(name)(**PARAMS[name]).spec()
    text = json.dumps(spec)
    assert faults.fault_from_spec(json.loads(text)).spec() == spec
    assert jfaults.fault_from_spec(json.loads(text)).spec() == spec


def _outcome(fn):
    """What one hook call did: its return value, or its error's type name and
    text, plus the seconds it asked ``time.sleep`` for."""
    slept = []
    real = time.sleep
    time.sleep = slept.append
    try:
        return ("ok", fn(), tuple(slept))
    except (jfaults.InjectedFault, faults.InjectedFault) as e:
        return ("raise", type(e).__name__, str(e), bool(e.transient), tuple(slept))
    finally:
        time.sleep = real


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_every_decision_equals_the_jax_package(name):
    ours, theirs = (mod.get_fault(name)(**PARAMS[name]) for mod in (faults, jfaults))
    calls = []
    for kind in ("batch", "solo", "segment"):
        for key in KEYS:
            for attempt in range(6):
                calls.append(("on_dispatch", kind, key, attempt))
    for n_cells in (1, 2, 3, 4, 8):
        for key in KEYS:
            calls.append(("poison_cells", n_cells, key))
    for kind in faults.MESSAGE_KINDS:
        for key in KEYS[:3]:
            for seq in range(12):
                calls.append(("message_fate", kind, key, seq))
    for replica in ("r0", "r1", "r2"):
        for tick in range(8):
            calls.append(("replica_fate", replica, tick))
            calls.append(("segment_fate", replica, tick))
    # In order on one instance each: the stateful entry (chaos) counts its
    # dispatches and remembers its poisoned batch.
    for method, *args in calls:
        got = _outcome(lambda: getattr(ours, method)(*args))
        want = _outcome(lambda: getattr(theirs, method)(*args))
        assert got == want, (method, args)


@pytest.mark.parametrize("key", KEYS + [("x",) * 40, ("gamma", float("nan"))])
def test_key_digest_equals_the_jax_package(key):
    assert faults.key_digest(key) == jfaults.key_digest(key)


def test_typed_faults_and_their_transient_flags():
    for name in ("InjectedFault", "WorkerCrashError", "TransientExecutorError",
                 "CompileFailureError"):
        ours, theirs = getattr(faults, name), getattr(jfaults, name)
        assert ours.transient == theirs.transient
        assert issubclass(ours, faults.InjectedFault) and issubclass(ours, RuntimeError)
        assert recovery.is_transient(ours("x")) == jrecovery.is_transient(theirs("x"))
    assert not recovery.is_transient(RuntimeError("CUDA error: an illegal memory access"))
    assert issubclass(faults.ReplicaKilled, BaseException)
    assert not issubclass(faults.ReplicaKilled, Exception)


def test_bad_params_raise_the_jax_package_errors():
    bad = [("transient_executor", {"failures": -1}), ("worker_crash", {"crashes": -2}),
           ("nan_poison", {"count": -1}), ("slow_batch", {"delay_s": -0.1}),
           ("chaos", {"poison": -1}), ("net_drop", {"rate": 1.5}),
           ("net_duplicate", {"kinds": "job,gossip"}), ("net_delay", {"ticks": 0}),
           ("net_partition", {}), ("replica_kill", {"replica": ""}),
           ("replica_kill", {"replica": "r0"}),
           ("replica_kill", {"replica": "r0", "at_segment": 0})]
    for name, kw in bad:
        with pytest.raises(ValueError) as ours:
            faults.get_fault(name)(**kw)
        with pytest.raises(ValueError) as theirs:
            jfaults.get_fault(name)(**kw)
        assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("jitter", [0.0, 0.25, 0.9])
def test_backoff_delay_equals_the_jax_package(jitter):
    kw = dict(backoff_base_s=0.1, backoff_factor=2.0, backoff_jitter=jitter, seed=9)
    ours, theirs = recovery.RecoveryPolicy(**kw), jrecovery.RecoveryPolicy(**kw)
    for key in KEYS:
        for attempt in range(1, 6):
            assert (recovery.backoff_delay(ours, attempt, key)
                    == jrecovery.backoff_delay(theirs, attempt, key))
    for bad in (dict(max_attempts=0), dict(backoff_jitter=1.5),
                dict(breaker_threshold=0), dict(max_bisect_depth=-1)):
        with pytest.raises(ValueError) as e1:
            recovery.RecoveryPolicy(**bad)
        with pytest.raises(ValueError) as e2:
            jrecovery.RecoveryPolicy(**bad)
        assert str(e1.value) == str(e2.value)


def test_circuit_breaker_lifecycle_equals_the_jax_package():
    script = ["allow", "fail", "allow", "fail", "allow", ("adv", 29.0), "allow",
              ("adv", 1.0), "allow", "allow", "fail", "allow", ("adv", 10.0), "allow",
              "ok", "allow", "fail", "fail", "fail", ("adv", 30.0), "allow", "ok"]
    trails = []
    for rec, clk in ((recovery, clock), (jrecovery, jclock)):
        c = clk.ManualClock()
        br = rec.CircuitBreaker(threshold=2, cooldown_s=30.0, clock=c)
        trail = []
        for step in script:
            for key in ("k", ("batch", 1)):
                if step == "allow":
                    trail.append(br.allow(key))
                elif step == "fail":
                    br.record_failure(key)
                elif step == "ok":
                    br.record_success(key)
            if isinstance(step, tuple):
                c.advance(step[1])
            trail.append((br.state("k"), br.snapshot(), br.states()))
        trails.append(trail)
    assert trails[0] == trails[1]


def test_run_with_deadline_relays_and_abandons():
    assert recovery.run_with_deadline(lambda: 42, None, label="x") == 42
    assert recovery.run_with_deadline(lambda: 42, 5.0, label="x") == 42
    with pytest.raises(recovery.JobTimeoutError, match="slow batch overran"):
        recovery.run_with_deadline(lambda: time.sleep(1.0), 0.05, label="slow batch")
    with pytest.raises(KeyError):
        recovery.run_with_deadline(lambda: {}["missing"], 5.0, label="x")
