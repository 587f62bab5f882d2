"""The port's copies of the straggler clock (``core/delays.py``,
``core/simulate.py``) give the same streams as the JAX package's for the
same seed, for every delay model and sampling interface."""

import numpy as np
import pytest

from repro.core import delays as jdelays
from repro.core import simulate as jsim
from repro_torch.core import delays as tdelays
from repro_torch.core import simulate as tsim

MODELS = {
    "constant": {},
    "shifted_exponential": {"tail_mean": 0.7},
    "pareto": {"shape": 2.2, "scale": 0.4},
    "markov": {"p_slow": 0.3, "p_recover": 0.4, "slow_factor": 6.0},
    "bandwidth_coupled": {"link_slowdown": 4.0},
}


def test_registry_matches():
    assert tdelays.available_delays() == jdelays.available_delays() == tuple(sorted(MODELS))


@pytest.mark.parametrize("jitter", [0.0, 0.3])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_delay_streams_identical(name, jitter):
    kw = dict(num_workers=5, straggler_sigma=4.0, straggler_workers=(0, 3),
              jitter=jitter, delay_model=name, delay_params=MODELS[name])
    jc, tc = jsim.ClusterModel(**kw), tsim.ClusterModel(**kw)
    jm, tm = jc.make_delay(), tc.make_delay()
    for attr in ("stateful", "worker_aware", "vector_sampled", "deterministic"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    jr, tr = np.random.default_rng(3), np.random.default_rng(3)
    for step in range(20):
        k = step % 5
        assert tm.compute_time(k, 100, tr) == jm.compute_time(k, 100, jr)
        assert tm.p2p_time(64 * step, k) == jm.p2p_time(64 * step, k)
    np.testing.assert_array_equal(tm.sample_round(50, tr), jm.sample_round(50, jr))
    for lockstep in (True, False):
        js = jm.sample_stream(6, 30, jr, lockstep=lockstep)
        ts = tm.sample_stream(6, 30, tr, lockstep=lockstep)
        assert (js is None) == (ts is None)
        if js is not None:
            np.testing.assert_array_equal(ts, js)
    jcs = jm.sample_chunk_stream(3, (10, 20, 30), jr)
    tcs = tm.sample_chunk_stream(3, (10, 20, 30), tr)
    assert (jcs is None) == (tcs is None)
    if jcs is not None:
        np.testing.assert_array_equal(tcs, jcs)
    np.testing.assert_array_equal(tm.link_factors(), jm.link_factors())
    assert tm.allreduce_time(1000) == jm.allreduce_time(1000)
    assert jr.random() == tr.random()  # both generators consumed alike


def test_cluster_model_matches():
    kw = dict(num_workers=4, straggler_sigma=10.0,
              membership=((2, 1.0, 3.0), (1, 0.5, None)))
    jc, tc = jsim.ClusterModel(**kw), tsim.ClusterModel(**kw)
    assert tc.membership == jc.membership and tc.delay_params == jc.delay_params
    np.testing.assert_array_equal(tc.sigmas(), jc.sigmas())
    for t in (0.0, 0.7, 1.5, 3.5):
        assert [tc.live_at(k, t) for k in range(4)] == [jc.live_at(k, t) for k in range(4)]
        assert tc.next_rejoin_after(t) == jc.next_rejoin_after(t)
    assert tc.next_drop_after(1, 0.0) == jc.next_drop_after(1, 0.0)
    assert tc.allreduce_time(47_236) == jc.allreduce_time(47_236)
    jclock, tclock = jsim.EventClock(3), tsim.EventClock(3)
    for k, start, dur in ((0, 0.0, 1.0), (0, 0.5, 2.0), (2, 4.0, 0.5)):
        assert tclock.start_compute(k, start, dur) == jclock.start_compute(k, start, dur)
    with pytest.raises(ValueError, match="stateful"):
        tsim.ClusterModel(2, delay_model="markov").compute_time(0, 1, np.random.default_rng())
