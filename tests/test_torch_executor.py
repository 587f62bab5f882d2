"""The port's whole-run executor on the CPU: against its event engine, JAX's.

``repro_torch.core.executor`` runs a run as one function (one captured CUDA
graph on the card, eager here). On the CPU every scan-capable
(protocol x delay) cell of the straggler-zoo grid equals the port's event
engine bit for bit: records, ``w``, ``alpha`` and ``alpha_applied``. Against
``repro.api.session.Session(executor="event")``, in the same cells, with
the port's draw source replaying JAX's key chain (as in
``tests/test_torch_engine.py``), the accounting is EQUAL and float32 within rtol 1e-4 / atol 1e-6 (each worker
step sums its dot products in another order than XLA). The JAX event and
scan executors disagree on this tree (``test_event_scan_parity``), so the
port is held to JAX's event executor.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import presets as jpresets
from repro.api.session import Session as JSession
from repro.core import baselines as jbase
from repro.core.simulate import ClusterModel as JCluster
from repro.data.synthetic import LinearDatasetSpec, make_linear_problem
from repro_torch import convert
from repro_torch.api.session import EvalEvent, Session, StopEvent
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.core import baselines as tbase
from repro_torch.core import executor
from repro_torch.core.simulate import ClusterModel as TCluster
from repro_torch.kernels import ref, sdca_inner

K, N_K, D, H, SEED = 4, 32, 256, 32, 5
RTOL, ATOL = 1e-4, 1e-6
EQUAL_FIELDS = ("iteration", "bytes_up", "bytes_down", "sim_time", "compute_time",
                "comm_time")
CLOSE_FIELDS = ("gap", "gap_server", "primal", "dual")


class JaxDraws:
    """A draw source that replays ``jax.random`` exactly (keys are JAX keys)."""

    def __init__(self, seed):
        self.seed = seed

    def root(self):
        return jax.random.key(self.seed)

    def split(self, key, num):
        return list(jax.random.split(key, num))

    def randint(self, keys, n, num):
        return np.stack([np.asarray(jax.random.randint(k, (num,), 0, n, dtype=jnp.int32))
                         for k in keys])

    def choice(self, keys, n, num, p):
        p = p.cpu().numpy()
        return np.stack([np.asarray(jax.random.choice(k, n, (num,), p=jnp.asarray(p[j])))
                         for j, k in enumerate(keys)]).astype(np.int32)


@pytest.fixture(scope="module")
def problems():
    jp = make_linear_problem(LinearDatasetSpec(num_workers=K, n_per_worker=N_K, d=D,
                                               nnz_per_row=12, seed=3), lam=1e-3)
    tp = convert.problem_from_arrays(np.asarray(jp.X), np.asarray(jp.y), jp.lam,
                                     device="cpu")
    return jp, tp


def _zoo_methods(pkg):
    """The straggler zoo's protocols at test size (``repro.api.presets``)."""
    b = pkg
    return {
        "cocoa_plus": (b.cocoa_plus(K, H=H), 5),
        "cocoa_v1": (b.cocoa_v1(K, H=H), 5),
        "cocoa_plus_accelerated": (b.cocoa_plus_solver(K, H=H, local_solver="accelerated"),
                                   5),
        "cocoa_importance": (b.cocoa_v1(K, H=H, local_solver="importance"), 5),
        "lag": (b.acpd_lag(K, D, B=2, T=5, rho_d=16, gamma=0.5, H=H, lag_window=3), 2),
        "partial_work": (b.acpd_partial_work(K, D, B=2, T=5, rho_d=16, gamma=0.5, H=H,
                                             n_chunks=4), 2),
        "group": (b.acpd(K, D, B=2, T=5, rho_d=16, gamma=0.5, H=H), 2),
        "async": (b.acpd_async(K, D, T=5, rho_d=16, gamma=0.5, H=H), 2),
    }


def _cluster(pkg_cluster, delay):
    sigma = 1.0 if delay == "bandwidth_coupled" else 5.0
    return pkg_cluster(num_workers=K, straggler_sigma=sigma, delay_model=delay,
                       delay_params=tuple(jpresets.ZOO_DELAYS[delay].items()))


ZOO_CELLS = [(name, delay) for name in _zoo_methods(tbase)
             for delay in sorted(jpresets.ZOO_DELAYS)]
SCAN_CELLS = [c for c in ZOO_CELLS if executor.scan_supported(
    _zoo_methods(tbase)[c[0]][0], _cluster(TCluster, c[1]))[0]]


def _assert_bitwise(a, b):
    assert len(a.records) == len(b.records) > 0
    for x, y in zip(a.records, b.records):
        assert dataclasses.asdict(x) == dataclasses.asdict(y)
    assert np.array_equal(a.w, b.w) and np.array_equal(a.alpha, b.alpha)
    assert (a.alpha_applied is None) == (b.alpha_applied is None)
    if a.alpha_applied is not None:
        assert np.array_equal(a.alpha_applied, b.alpha_applied)


def test_the_zoo_grid_splits_as_the_jax_package_does():
    # The same cells are scan-capable in both packages; the port adds no
    # refusal for the built-in solvers.
    j_methods = _zoo_methods(jbase)
    from repro.core import executor as jexecutor
    for name, delay in ZOO_CELLS:
        want = jexecutor.scan_supported(j_methods[name][0], _cluster(JCluster, delay))
        got = executor.scan_supported(_zoo_methods(tbase)[name][0],
                                      _cluster(TCluster, delay))
        assert got == want, (name, delay)
    assert len(SCAN_CELLS) >= 20


@pytest.mark.parametrize("name,delay", SCAN_CELLS)
def test_scan_equals_the_event_engine_bit_for_bit(problems, name, delay):
    _, tp = problems
    m, outer = _zoo_methods(tbase)[name]
    cl = _cluster(TCluster, delay)
    ev = Session(tp, m, cl, num_outer=outer, seed=SEED, eval_every=2, executor="event",
                 device="cpu").run()
    sc = Session(tp, m, cl, num_outer=outer, seed=SEED, eval_every=2, executor="scan",
                 device="cpu").run()
    _assert_bitwise(sc, ev)


@pytest.mark.parametrize("name,delay", SCAN_CELLS)
def test_scan_matches_the_jax_event_session(problems, name, delay):
    jp, tp = problems
    (jm, outer), (tm, _) = _zoo_methods(jbase)[name], _zoo_methods(tbase)[name]
    js = JSession(jp, jm, _cluster(JCluster, delay), num_outer=outer, seed=SEED,
                  executor="event")
    ts = Session(tp, tm, _cluster(TCluster, delay), num_outer=outer, seed=SEED,
                 executor="scan", device="cpu", draws=JaxDraws(SEED))
    assert ts.executor == "scan"
    j_res, t_res = js.run(), ts.run()
    assert len(j_res.records) == len(t_res.records) > 0
    for j, t in zip(j_res.records, t_res.records):
        for field in EQUAL_FIELDS:
            assert getattr(t, field) == getattr(j, field), (field, j.iteration)
        for field in CLOSE_FIELDS:
            np.testing.assert_allclose(getattr(t, field), getattr(j, field), rtol=RTOL,
                                       atol=ATOL, err_msg=f"{field} at {j.iteration}")
    np.testing.assert_allclose(t_res.w, np.asarray(j_res.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_res.alpha, np.asarray(j_res.alpha), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("rounds_to_stop", [3, None])
def test_gap_scan_stops_at_the_event_loops_round(problems, rounds_to_stop):
    _, tp = problems
    m, cl = tbase.cocoa_plus(K, H=H), TCluster(K, straggler_sigma=3.0)
    plain = Session(tp, m, cl, num_outer=8, seed=SEED, eval_mode="replay",
                    device="cpu").run()
    gaps = [r.gap for r in plain.records]
    target = (0.5 * (gaps[rounds_to_stop - 2] + gaps[rounds_to_stop - 1])
              if rounds_to_stop else 0.1 * gaps[-1])
    kw = dict(num_outer=8, seed=SEED, target_gap=target, device="cpu")
    ev = list(Session(tp, m, cl, executor="event", **kw).events())
    s = Session(tp, m, cl, executor="scan", **kw)
    sc = list(s.events())
    assert sc == ev
    stop = sc[-1]
    assert isinstance(stop, StopEvent)
    assert stop.reason == ("target_gap" if rounds_to_stop else "completed")
    assert stop.iteration == (rounds_to_stop or 8)
    assert [e.iteration for e in sc if isinstance(e, EvalEvent)] == list(
        range(1, stop.iteration + 1))
    assert np.array_equal(s.result().w, Session(tp, m, cl, executor="event", **kw).run().w)
    assert executor.gap_floor_f32(0.1) <= 0.1 and float(executor.gap_floor_f32(0.1)) <= 0.1


def test_auto_picks_the_executor_by_the_rule(problems):
    _, tp = problems
    cl = TCluster(K, straggler_sigma=3.0)
    cases = [(tbase.cocoa_plus(K, H=H), cl, {}, "scan"),
             (tbase.cocoa_plus(K, H=H), cl, {"target_gap": 1e-3}, "scan"),
             (tbase.cocoa_plus(K, H=H), cl, {"time_budget": 1.0}, "event"),
             (tbase.acpd_lag(K, D, H=H), cl, {}, "scan"),
             (tbase.acpd_lag(K, D, H=H), TCluster(K, delay_model="markov"), {}, "event"),
             (tbase.acpd(K, D, H=H), cl, {}, "event"),
             (tbase.acpd_partial_work(K, D, H=H, n_chunks=2), cl, {}, "scan"),
             (tbase.acpd_partial_work(K, D, H=H, n_chunks=2),
              TCluster(K, membership=((1, 0.1, None),)), {}, "event")]
    for m, c, kw, want in cases:
        assert Session(tp, m, c, num_outer=2, device="cpu", **kw).executor == want, (m, kw)
    big = executor.GAP_SCAN_AUTO_MAX_ROUNDS + 1
    m = tbase.cocoa_plus(K, H=H)
    assert Session(tp, m, cl, num_outer=big, target_gap=1e-3, device="cpu").executor == "event"
    assert Session(tp, m, cl, num_outer=big, target_gap=1e-3, executor="scan",
                   device="cpu").executor == "scan"
    with pytest.raises(ValueError, match="cannot run this spec: protocol 'group'"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, executor="scan", device="cpu")
    with pytest.raises(ValueError, match="time_budget"):
        Session(tp, m, cl, num_outer=1, time_budget=1.0, executor="scan", device="cpu")


def test_stats_count_runs_and_traces(problems):
    _, tp = problems
    cl = TCluster(K, straggler_sigma=3.0)
    executor.reset_stats()
    for gamma in (1.0, 1.0, 0.5):  # gamma is an input of the run, not its signature
        m = dataclasses.replace(tbase.cocoa_plus(K, H=H), gamma=gamma, sigma_prime=4.0)
        Session(tp, m, cl, num_outer=3, seed=1, executor="scan", device="cpu").run()
    assert executor.STATS["lockstep_calls"] == 3
    assert executor.STATS["lockstep_traces"] == 1
    Session(tp, tbase.cocoa_plus(K, H=H), cl, num_outer=4, seed=1, executor="scan",
            device="cpu").run()  # another length: another signature
    assert executor.STATS["lockstep_traces"] == 2
    lag = tbase.acpd_lag(K, D, B=2, T=3, rho_d=16, H=H)
    for seed in (1, 2):
        Session(tp, lag, cl, num_outer=1, seed=seed, executor="scan", device="cpu").run()
    assert (executor.STATS["lag_calls"], executor.STATS["lag_traces"]) == (2, 1)
    executor.reset_stats()
    assert set(executor.STATS.values()) == {0}


def test_an_eager_run_does_not_hold_the_cache_lock():
    """On the CPU a run is eager and has no shared buffers: while one runs
    (say an attempt abandoned at its deadline), another thread takes the
    lock at once; the run is still counted."""
    started, release = threading.Event(), threading.Event()

    def fn(inputs):
        started.set()
        release.wait(10.0)
        return inputs

    run = executor.Graphed(fn, torch.device("cpu"), "lockstep")
    calls = executor.STATS["lockstep_calls"]
    th = threading.Thread(target=run, args=({"x": torch.zeros(1)},))
    th.start()
    try:
        assert started.wait(10.0)
        assert executor._LOCK.acquire(timeout=1.0)
        executor._LOCK.release()
    finally:
        release.set()
        th.join()
    assert executor.STATS["lockstep_calls"] == calls + 1


def test_checkpointed_run_resumes_bit_for_bit(problems, tmp_path):
    _, tp = problems
    m, cl = tbase.cocoa_plus(K, H=H), TCluster(K, straggler_sigma=3.0)
    whole = Session(tp, m, cl, num_outer=7, seed=SEED, eval_every=2, executor="scan",
                    device="cpu").run()

    class Killed(Exception):
        pass

    def hook(start):
        if start >= 6:
            raise Killed(start)

    kw = dict(num_outer=7, seed=SEED, eval_every=2, device="cpu",
              checkpoint_dir=tmp_path, checkpoint_every=3)
    with pytest.raises(Killed):
        Session(tp, m, cl, _segment_hook=hook, **kw).run()
    run_id = executor.checkpoint_run_id(tp, m, cl, seed=SEED, num_outer=7, eval_every=2)
    manifest = executor.checkpoint_manifest(tmp_path, run_id)
    assert manifest["round"] == 6 and manifest["run"] == run_id
    state, extra = ckpt_lib.load_checkpoint(
        tmp_path / run_id, {"w": np.zeros(D, np.float32)}, 6)
    assert extra["num_outer"] == 7 and state["w"].shape == (D,)
    executor.reset_stats()
    resumed = Session(tp, m, cl, **kw).run()
    assert executor.STATS["lockstep_segment_calls"] == 1  # only the last segment ran
    _assert_bitwise(resumed, whole)
    again = Session(tp, m, cl, **kw).run()  # everything done: nothing runs
    _assert_bitwise(again, whole)
    with pytest.raises(ValueError, match="come together"):
        Session(tp, m, cl, num_outer=2, checkpoint_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="cannot checkpoint"):
        Session(tp, m, cl, num_outer=2, checkpoint_dir=tmp_path, checkpoint_every=1,
                target_gap=1e-3, device="cpu")


def test_checkpoint_files_match_the_jax_layout(tmp_path):
    # The payload keys are the JAX package's dict-path keys, so the files of
    # one package read in the other.
    from repro.checkpoint import checkpoint as jckpt

    state = {"w": np.arange(3, dtype=np.float32), "key": np.arange(2, dtype=np.uint32)}
    ckpt_lib.save_checkpoint(tmp_path / "t", 4, state, extra={"round": 4})
    tree, extra = jckpt.load_checkpoint(tmp_path / "t", state)
    assert extra == {"round": 4} and np.array_equal(tree["w"], state["w"])
    jckpt.save_checkpoint(tmp_path / "j", 2, state)
    back, _ = ckpt_lib.load_checkpoint(tmp_path / "j", state)
    assert np.array_equal(back["key"].numpy(), state["key"])
    assert ckpt_lib.latest_step(tmp_path / "j") == 2
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt_lib.load_checkpoint(tmp_path / "j", {"w": np.zeros(4, np.float32)})


def test_plain_kernel_takes_the_executors_map_modes():
    rng = np.random.default_rng(0)
    Kp, n_k, d, Hs = 3, 16, 40, 12
    X = torch.from_numpy(rng.standard_normal((Kp, n_k, d)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((Kp, n_k)).astype(np.float32))
    norms = (X * X).sum(-1)
    alpha = torch.from_numpy(rng.standard_normal((Kp, n_k)).astype(np.float32) * 0.1)
    w = torch.from_numpy(rng.standard_normal((4, d)).astype(np.float32) * 0.1)
    idx = torch.from_numpy(rng.integers(0, n_k, (4, Hs)).astype(np.int32))
    args = (X, y, norms, 1e-2, Kp * n_k)
    host = [2, 0, 2, 1]
    # (a) A map tensor equals the host map; a bad entry raises naming it.
    a = ref.sdca_inner_ref(w, alpha, *args, 0.7, idx, workers=host)
    b = ref.sdca_inner_ref(w, alpha, *args, 0.7, idx,
                           workers=torch.tensor(host, dtype=torch.int32),
                           map_error=sdca_inner.map_error_word("cpu"))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="entry 3 of batch row 1"):
        ref.sdca_inner_ref(w, alpha, *args, 0.7, idx,
                           workers=torch.tensor([0, 3, 1, 1], dtype=torch.int32))
    # (b) alpha and sigma' per row: V = 2 variants of 2 rows each equal two
    # separate calls bit for bit.
    alpha_rows = torch.cat([alpha[[2, 0]], 0.5 * alpha[[2, 1]]])
    sig = torch.tensor([0.7, 0.7, 1.3, 1.3])
    both = ref.sdca_inner_ref(w, alpha_rows, *args, 0.0, idx, workers=host,
                              alpha_rows=True, sigma_rows=sig)
    one = ref.sdca_inner_ref(w[:2], alpha, *args, 0.7, idx[:2], workers=host[:2])
    half = alpha.clone()
    half[[2, 1]] = 0.5 * alpha[[2, 1]]
    two = ref.sdca_inner_ref(w[2:], half, *args, 1.3, idx[2:], workers=host[2:])
    assert torch.equal(both[0], torch.cat([one[0], two[0]]))
    assert torch.equal(both[1], torch.cat([one[1], two[1]]))
    # The error word's reading.
    sdca_inner.raise_map_error([0, 0], 3)
    with pytest.raises(ValueError, match="entry 9 of batch row 2"):
        sdca_inner.raise_map_error(torch.tensor([3, 9], dtype=torch.int32), 3)


def test_coalesce_rules_follow_the_jax_package(problems):
    from repro.core import executor as jexecutor

    j_methods, t_methods = _zoo_methods(jbase), _zoo_methods(tbase)
    for name in t_methods:
        for delay in ("constant", "markov"):
            for kw in ({}, {"target_gap": 1e-3}, {"time_budget": 1.0}):
                want = jexecutor.coalesce_supported(j_methods[name][0],
                                                    _cluster(JCluster, delay), **kw)
                got = executor.coalesce_supported(t_methods[name][0],
                                                  _cluster(TCluster, delay), **kw)
                assert got[0] == want[0], (name, delay, kw)
