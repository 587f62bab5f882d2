"""Port vs JAX package: the protocol engine and the streaming Session.

Every registry protocol runs through the port's ``Session`` and through
``repro.api.session.Session(..., executor="event")`` on the same problem,
with the port's draw source replaying JAX's key chain (one ``split`` per
worker round in launch order, ``split(sub, K)`` per lockstep round, the
solvers' ``choice`` and inner ``split``/``randint``) and the same numpy host
RNG. The accounting (``iteration``, ``sim_time``, bytes, ``compute_time``,
``comm_time``) must be EQUAL; ``w``, ``alpha`` and the certificates are held
to rtol 1e-4 / atol 1e-6 (each worker step sums its dot products in another
order than XLA, and that compounds over dependent rounds).

Against the port's own reference loops (``group``, ``sync``) on one visit
order stream, with ``eval_mode="replay"``, the engine is equal bit for bit
on the CPU. ``batched`` evaluation (two products over ``X`` for every
snapshot) is held to ``replay`` at rtol 1e-5 / atol 1e-7 on the gap fields,
with the accounting equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.session import Session as JSession
from repro.core import baselines as jbase
from repro.core.simulate import ClusterModel as JCluster
from repro.data.synthetic import LinearDatasetSpec, make_linear_problem
from repro_torch import convert
from repro_torch.api.session import (EvalEvent, RoundEvent, Session, StopEvent,
                                     SyncEvent)
from repro_torch.core import acpd as tacpd
from repro_torch.core import baselines as tbase
from repro_torch.core import engine
from repro_torch.core.sdca import StreamDraws, TorchDraws
from repro_torch.core.simulate import ClusterModel as TCluster
from repro_torch.kernels import ops

K, N_K, D, H, SEED = 4, 32, 256, 40, 5
RTOL, ATOL = 1e-4, 1e-6
EQUAL_FIELDS = ("iteration", "bytes_up", "bytes_down", "sim_time",
                "compute_time", "comm_time")
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


def _methods(name):
    """The same preset from both packages."""
    both = (jbase, tbase)
    if name == "group":
        return [m.acpd(K, D, B=2, T=5, rho_d=16, H=H) for m in both]
    if name == "group_dense":
        return [m.acpd_dense(K, B=3, T=5, H=H) for m in both]
    if name == "group_threshold_q8":
        return [dataclasses.replace(m.acpd(K, D, B=2, T=5, rho_d=16, H=H),
                                    compressor="topk_q8") for m in both]
    if name == "sync":
        return [m.cocoa_plus(K, H=H) for m in both]
    if name == "async":
        return [m.acpd_async(K, D, T=5, rho_d=16, H=H) for m in both]
    if name == "lag":
        return [m.acpd_lag(K, D, B=2, T=5, rho_d=16, H=H, lag_window=3) for m in both]
    if name.startswith("cocoa_plus["):
        solver = name[len("cocoa_plus["):-1]
        return [m.cocoa_plus_solver(K, H=H, local_solver=solver) for m in both]
    if name.startswith("cocoa["):
        solver = name[len("cocoa["):-1]
        return [m.cocoa_v1(K, H=H, local_solver=solver) for m in both]
    if name == "adaptive_b":
        return [m.acpd_adaptive(K, D, T=5, rho_d=16, H=H) for m in both]
    if name == "hierarchical_b":
        return [m.acpd_hierarchical(K, D, T=5, rho_d=16, H=H) for m in both]
    if name.startswith("partial_work"):
        return [m.acpd_partial_work(K, D, B=2, T=5, rho_d=16, H=H, n_chunks=4)
                for m in both]
    raise ValueError(name)


def _cluster(name):
    kw = dict(num_workers=K, straggler_sigma=3.0, jitter=0.2)
    if name == "partial_work_elastic":
        kw["membership"] = ((1, 0.004, 0.012), (2, 0.006, None))
    if name == "lag":
        kw = dict(num_workers=K, straggler_sigma=3.0, delay_model="shifted_exponential")
    return JCluster(**kw), TCluster(**kw)


PROTOCOL_CASES = ["group", "group_dense", "group_threshold_q8", "sync", "async", "lag",
                  "cocoa[sdca]", "cocoa[importance]", "cocoa[accelerated]",
                  "cocoa_plus[importance]", "cocoa_plus[accelerated]", "adaptive_b",
                  "hierarchical_b", "partial_work", "partial_work_elastic"]


def _assert_records(t_recs, j_recs):
    assert len(t_recs) == len(j_recs) > 0
    for j, t in zip(j_recs, t_recs):
        for field in EQUAL_FIELDS:
            assert getattr(t, field) == getattr(j, field), (field, j.iteration)
        for field in CLOSE_FIELDS:
            np.testing.assert_allclose(getattr(t, field), getattr(j, field),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{field} at round {j.iteration}")


@pytest.mark.parametrize("name", PROTOCOL_CASES)
def test_session_matches_jax_event_session(problems, name):
    jp, tp = problems
    jm, tm = _methods(name)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    jc, tc = _cluster(name)
    num_outer = 6 if jm.protocol in ("sync", "cocoa", "cocoa_plus") else 2
    js = JSession(jp, jm, jc, num_outer=num_outer, seed=SEED, executor="event")
    ts = Session(tp, tm, tc, num_outer=num_outer, seed=SEED, executor="event",
                 draws=JaxDraws(SEED), device="cpu")
    j_events, t_events = list(js.events()), list(ts.events())
    # The same event sequence, round for round.
    assert [type(e).__name__ for e in t_events] == [type(e).__name__ for e in j_events]
    for je, te in zip(j_events, t_events):
        if type(je).__name__ != "EvalEvent":  # rounds, syncs, the stop: host values
            assert dataclasses.asdict(te) == dataclasses.asdict(je)
    jr, tr = js.result(), ts.result()
    _assert_records(tr.records, jr.records)
    np.testing.assert_allclose(tr.w, np.asarray(jr.w), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tr.alpha, np.asarray(jr.alpha), rtol=RTOL, atol=ATOL)
    if jr.alpha_applied is not None:
        np.testing.assert_allclose(tr.alpha_applied, np.asarray(jr.alpha_applied),
                                   rtol=RTOL, atol=ATOL)
    assert tr.records[-1].gap < tr.records[0].gap


def _stream(seed, n_k, h):
    """A seeded uniform visit-order stream on the host."""
    return tacpd.torch_visit_orders(n_k, h, seed, torch.device("cpu"))


@pytest.mark.parametrize("name", ["group", "group_dense", "sync"])
def test_engine_equals_the_reference_loops_bit_for_bit(problems, name):
    _, tp = problems
    _, tm = _methods(name)
    tc = TCluster(num_workers=K, straggler_sigma=3.0, jitter=0.2)
    num_outer = 6 if tm.protocol == "sync" else 2
    ref = tacpd.run_method_reference(tp, tm, tc, num_outer=num_outer, seed=SEED,
                                     visit_orders=_stream(11, N_K, H), device="cpu")
    eng = tacpd.run_method(tp, tm, tc, num_outer=num_outer, seed=SEED, eval_mode="replay",
                           draws=StreamDraws(_stream(11, N_K, H)), device="cpu")
    assert [dataclasses.asdict(r) for r in eng.records] == [
        dataclasses.asdict(r) for r in ref.records]
    assert np.array_equal(eng.w, ref.w) and np.array_equal(eng.alpha, ref.alpha)
    if ref.alpha_applied is not None:
        assert np.array_equal(eng.alpha_applied, ref.alpha_applied)


def test_partial_work_with_one_chunk_is_group(problems):
    _, tp = problems
    tc = TCluster(num_workers=K, straggler_sigma=3.0, jitter=0.2)
    group = tbase.acpd(K, D, B=2, T=5, rho_d=16, H=H)
    one_chunk = dataclasses.replace(group, protocol="partial_work", n_chunks=1)
    runs = [tacpd.run_method(tp, m, tc, num_outer=2, seed=SEED, device="cpu")
            for m in (group, one_chunk)]
    assert [dataclasses.asdict(r) for r in runs[0].records] == [
        dataclasses.asdict(r) for r in runs[1].records]
    assert np.array_equal(runs[0].w, runs[1].w)
    assert np.array_equal(runs[0].alpha_applied, runs[1].alpha_applied)


@pytest.mark.parametrize("name", ["group", "lag", "cocoa[importance]", "partial_work"])
def test_batched_evaluation_matches_replay(problems, name):
    _, tp = problems
    _, tm = _methods(name)
    _, tc = _cluster(name)
    runs = {mode: tacpd.run_method(tp, tm, tc, num_outer=3, seed=SEED, eval_mode=mode,
                                   device="cpu") for mode in ("batched", "replay")}
    b, r = runs["batched"], runs["replay"]
    assert len(b.records) == len(r.records) > 0
    for rb, rr in zip(b.records, r.records):
        for field in EQUAL_FIELDS:
            assert getattr(rb, field) == getattr(rr, field)
        for field in CLOSE_FIELDS:
            np.testing.assert_allclose(getattr(rb, field), getattr(rr, field),
                                       rtol=1e-5, atol=1e-7)
    assert np.array_equal(b.w, r.w)


def _kinds(events):
    return [type(e).__name__ for e in events]


@pytest.mark.parametrize("stop", ["target_gap", "time_budget", "eval_every"])
def test_event_stream_and_early_stops_match_jax(problems, stop):
    jp, tp = problems
    jm, tm = _methods("group")
    jc, tc = _cluster("group")
    kw = dict(num_outer=4, seed=SEED)
    if stop == "target_gap":
        kw["target_gap"] = 0.2
    elif stop == "time_budget":
        kw["time_budget"] = 0.012
    else:
        kw["eval_every"] = 3
    j_events = list(JSession(jp, jm, jc, executor="event", **kw).events())
    t_events = list(Session(tp, tm, tc, draws=JaxDraws(SEED), device="cpu",
                            **kw).events())
    assert _kinds(t_events) == _kinds(j_events)
    j_stop, t_stop = j_events[-1], t_events[-1]
    assert isinstance(t_stop, StopEvent)
    assert dataclasses.asdict(t_stop) == dataclasses.asdict(j_stop)
    if stop != "eval_every":
        assert t_stop.reason == stop and t_stop.iteration < 4 * jm.T
    assert sum(isinstance(e, SyncEvent) for e in t_events) == t_stop.iteration // jm.T
    evals = [e for e in t_events if isinstance(e, EvalEvent)]
    if stop == "target_gap":  # streamed: each certificate right after its round
        assert evals[-1].gap <= 0.2 < evals[-2].gap
        assert _kinds(t_events)[-2:] == ["EvalEvent", "StopEvent"]
        assert len(evals) == t_stop.iteration
    else:  # deferred: every certificate after the last round
        n_rounds = sum(isinstance(e, RoundEvent) for e in t_events)
        assert _kinds(t_events)[-len(evals) - 1:-1] == ["EvalEvent"] * len(evals)
        assert len(evals) == (n_rounds // 3 if stop == "eval_every"
                              else n_rounds)


def test_session_result_and_single_use_stream(problems):
    _, tp = problems
    _, tm = _methods("group")
    s = Session(tp, tm, TCluster(K), num_outer=1, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="not finished"):
        s.result()
    assert s.executor == "event"
    first = next(iter(s))
    assert isinstance(first, RoundEvent) and first.iteration == 1
    rest = list(s.events())  # the same, single-use stream
    assert isinstance(rest[-1], StopEvent) and rest[-1].reason == "completed"
    assert len(s.result().records) == tm.T
    auto = Session(tp, tm, TCluster(K), num_outer=1, seed=1, executor="auto",
                   device="cpu")
    assert auto.executor == "event"  # group has host-adaptive control flow
    _, lockstep = _methods("sync")
    auto = Session(tp, lockstep, TCluster(K), num_outer=1, seed=1, executor="auto",
                   device="cpu")
    assert auto.executor == "scan"  # the whole-run executor takes cocoa_plus


def test_registries_and_errors(problems):
    _, tp = problems
    assert engine.available_protocols() == (
        "adaptive_b", "async", "cocoa", "cocoa_plus", "group", "hierarchical_b", "lag",
        "partial_work", "sync")
    from repro.core import engine as jengine
    assert engine.available_protocols() == jengine.available_protocols()
    for name in engine.available_protocols():
        m = dataclasses.replace(tbase.acpd(8, 1000), protocol=name)
        jm = dataclasses.replace(jbase.acpd(8, 1000), protocol=name)
        assert m.resolved_sigma_prime(8) == jm.resolved_sigma_prime(8), name
    with pytest.raises(ValueError, match="unknown protocol 'nope'"):
        engine.get_protocol("nope")
    cl = TCluster(K)
    bad = {"protocol": "nope", "compressor": "nope", "local_solver": "nope"}
    for field, value in bad.items():
        m = dataclasses.replace(tbase.acpd(K, D, H=H), **{field: value})
        with pytest.raises(ValueError, match="unknown"):
            Session(tp, m, cl, num_outer=1, device="cpu")
    with pytest.raises(ValueError, match="B=1"):
        Session(tp, dataclasses.replace(tbase.acpd(K, D, H=H), protocol="async"), cl,
                num_outer=1, device="cpu")
    with pytest.raises(ValueError, match="gamma <= 1/K"):
        Session(tp, dataclasses.replace(tbase.cocoa_v1(K, H=H), gamma=1.0), cl,
                num_outer=1, device="cpu")
    with pytest.raises(ValueError, match="lag_window"):
        Session(tp, tbase.acpd_lag(K, D, H=H, lag_window=0), cl, num_outer=1,
                device="cpu")
    with pytest.raises(ValueError, match="n_chunks"):
        Session(tp, tbase.acpd_partial_work(K, D, H=4, n_chunks=5), cl, num_outer=1,
                device="cpu")
    with pytest.raises(ValueError, match="rack_b"):
        Session(tp, tbase.acpd_hierarchical(K, D, H=H, rack_b=3), cl, num_outer=1,
                device="cpu")
    with pytest.raises(ValueError, match="adaptive_quantile"):
        Session(tp, tbase.acpd_adaptive(K, D, H=H, quantile=0.0), cl, num_outer=1,
                device="cpu")
    with pytest.raises(ValueError, match="eval_mode"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, eval_mode="x", device="cpu")
    with pytest.raises(ValueError, match="executor"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, executor="x", device="cpu")
    with pytest.raises(ValueError, match="cannot run this spec"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, executor="scan", device="cpu")
    with pytest.raises(ValueError, match="cannot checkpoint"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, checkpoint_dir="x",
                checkpoint_every=1, device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1, device="meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Session(tp, tbase.acpd(K, D, H=H), cl, num_outer=1)


def test_membership_is_refused_outside_partial_work(problems):
    _, tp = problems
    elastic = TCluster(K, membership=((1, 0.004, 0.012),))
    for name in ("group", "sync", "lag", "hierarchical_b"):
        _, tm = _methods(name)
        with pytest.raises(ValueError, match="elastic membership"):
            Session(tp, tm, elastic, num_outer=1, device="cpu")
    _, tm = _methods("partial_work")
    assert Session(tp, tm, elastic, num_outer=1, device="cpu").run().records


def test_run_method_routes_and_launches_nothing_on_the_host(problems):
    _, tp = problems
    tc = TCluster(K, straggler_sigma=3.0)
    before = dict(ops.LAUNCHES)
    m = tbase.acpd(K, D, B=2, T=3, rho_d=16, H=H)
    eng = tacpd.run_method(tp, m, tc, num_outer=1, seed=2, device="cpu")
    assert eng.records and ops.LAUNCHES == before
    # exact_dual_feedback stays on the reference loops (host lstsq a round).
    exact = dataclasses.replace(m, exact_dual_feedback=True)
    via = tacpd.run_method(tp, exact, tc, num_outer=1, seed=2, device="cpu")
    ref = tacpd.run_method_reference(tp, exact, tc, num_outer=1, seed=2, device="cpu")
    assert [dataclasses.asdict(r) for r in via.records] == [
        dataclasses.asdict(r) for r in ref.records]
    # The default draws are seeded.
    again = tacpd.run_method(tp, m, tc, num_outer=1, seed=2, device="cpu")
    other = tacpd.run_method(tp, m, tc, num_outer=1, seed=3, device="cpu")
    assert np.array_equal(eng.w, again.w) and not np.array_equal(eng.w, other.w)
    with pytest.raises(ValueError, match="unknown protocol"):
        tacpd.run_method(tp, dataclasses.replace(m, protocol="nope"), tc, num_outer=1,
                         device="cpu")
    with pytest.raises(ValueError, match="uniform orders only"):
        tacpd.run_method(tp, tbase.cocoa_v1(K, H=H, local_solver="importance"), tc,
                         num_outer=1, draws=StreamDraws(_stream(1, N_K, H)), device="cpu")
    assert isinstance(TorchDraws(0).randint([None] * 3, N_K, 5), torch.Tensor)
