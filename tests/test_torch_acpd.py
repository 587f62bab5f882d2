"""Whole-run parity: the port's reference loops vs
``repro.core.acpd.run_method_reference`` on the same problem, with the port
replaying JAX's visit orders (the key chain of ``core/acpd.py`` and the
``randint`` draw of ``core/sdca.py``).

The host-side accounting (rounds, bytes, the simulated clock and its
compute/comm split) must be EQUAL. The float32 math is held to rtol 1e-4 /
atol 1e-6: each worker step sums its dot products in another order than XLA,
and those last-bit differences compound over the run's dependent rounds.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from repro.core import acpd as jacpd
from repro.core import baselines as jbase
from repro.core.simulate import ClusterModel as JCluster
from repro.data.synthetic import LinearDatasetSpec, make_linear_problem
from repro_torch import convert
from repro_torch.core import acpd as tacpd
from repro_torch.core import baselines as tbase
from repro_torch.core.simulate import ClusterModel as TCluster

K, N_K, D, H, SEED = 4, 32, 256, 40, 5
RTOL, ATOL = 1e-4, 1e-6
EQUAL_FIELDS = ("iteration", "bytes_up", "bytes_down", "sim_time",
                "compute_time", "comm_time")
CLOSE_FIELDS = ("gap", "gap_server", "primal", "dual")


def jax_group_orders(seed, n_k, h):
    """Visit orders as ``_run_group`` draws them: one split per worker round."""
    key = jax.random.key(seed)
    while True:
        key, sub = jax.random.split(key)
        yield np.asarray(jax.random.randint(sub, (h,), 0, n_k, dtype=jnp.int32))


def jax_sync_orders(seed, k_workers, n_k, h):
    """Visit orders as ``_run_sync`` draws them: K keys per round, worker 0 first."""
    key = jax.random.key(seed)
    while True:
        key, sub = jax.random.split(key)
        for k_key in jax.random.split(sub, k_workers):
            yield np.asarray(jax.random.randint(k_key, (h,), 0, n_k, dtype=jnp.int32))


@pytest.fixture(scope="module")
def problems():
    jp = make_linear_problem(LinearDatasetSpec(num_workers=K, n_per_worker=N_K, d=D,
                                               nnz_per_row=12, seed=3), lam=1e-3)
    tp = convert.problem_from_arrays(np.asarray(jp.X), np.asarray(jp.y), jp.lam,
                                     device="cpu")
    return jp, tp


def _methods(name):
    """The same preset from both packages."""
    if name == "acpd_exact":
        return [m.acpd(K, D, B=2, T=5, rho_d=16, H=H) for m in (jbase, tbase)]
    if name == "acpd_threshold":
        return [dataclasses.replace(m.acpd(K, D, B=2, T=5, rho_d=16, H=H),
                                    use_exact_k=False) for m in (jbase, tbase)]
    if name == "acpd_full_barrier":
        return [m.acpd_full_barrier(K, D, T=4, rho_d=16, H=H) for m in (jbase, tbase)]
    if name == "acpd_dense":
        return [m.acpd_dense(K, B=3, T=5, H=H) for m in (jbase, tbase)]
    if name == "exact_dual_feedback":
        return [dataclasses.replace(m.acpd(K, D, B=2, T=4, rho_d=32, H=H),
                                    exact_dual_feedback=True) for m in (jbase, tbase)]
    if name == "cocoa_plus":
        return [m.cocoa_plus(K, H=H) for m in (jbase, tbase)]
    raise ValueError(name)


@pytest.mark.parametrize("name", ["acpd_exact", "acpd_threshold", "acpd_full_barrier",
                                  "acpd_dense", "exact_dual_feedback", "cocoa_plus"])
def test_run_matches_jax_reference(problems, name):
    jp, tp = problems
    jm, tm = _methods(name)
    assert dataclasses.asdict(jm) == dataclasses.asdict(tm)
    sync = jm.protocol == "sync"
    num_outer = 8 if sync else 2
    cluster = dict(num_workers=K, straggler_sigma=3.0, jitter=0.2)
    jr = jacpd.run_method_reference(jp, jm, JCluster(**cluster), num_outer=num_outer,
                                    seed=SEED)
    orders = (jax_sync_orders(SEED, K, N_K, H) if sync
              else jax_group_orders(SEED, N_K, H))
    tr = tacpd.run_method_reference(tp, tm, TCluster(**cluster), num_outer=num_outer,
                                    seed=SEED, visit_orders=orders, device="cpu")
    assert len(tr.records) == len(jr.records) > 0
    for j, t in zip(jr.records, tr.records):
        for field in EQUAL_FIELDS:
            assert getattr(t, field) == getattr(j, field), (field, j.iteration)
        for field in CLOSE_FIELDS:
            np.testing.assert_allclose(getattr(t, field), getattr(j, field),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{field} at round {j.iteration}")
    np.testing.assert_allclose(tr.w, jr.w, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tr.alpha, jr.alpha, rtol=RTOL, atol=ATOL)
    if not sync:
        np.testing.assert_allclose(tr.alpha_applied, jr.alpha_applied,
                                   rtol=RTOL, atol=ATOL)
    assert tr.records[-1].gap < tr.records[0].gap
    assert tr.time_to_gap(1e9) == jr.time_to_gap(1e9)
    assert tr.rounds_to_gap(1e9) == jr.rounds_to_gap(1e9)
    assert tr.as_dict()["method"] == jr.as_dict()["method"]


def test_default_visit_orders_are_seeded(problems):
    _, tp = problems
    m = tbase.acpd(K, D, B=2, T=3, rho_d=16, H=H)
    runs = [tacpd.run_method_reference(tp, m, TCluster(K), num_outer=1, seed=s,
                                       device="cpu") for s in (1, 1, 2)]
    assert np.array_equal(runs[0].w, runs[1].w)
    assert not np.array_equal(runs[0].w, runs[2].w)


def test_sigma_prime_defaults_and_unported_protocols(problems):
    _, tp = problems
    assert tbase.acpd(8, 1000, B=4, gamma=0.5).resolved_sigma_prime(8) == 2.0
    assert tbase.cocoa_plus(8).resolved_sigma_prime(8) == 8.0
    assert tacpd.MethodConfig("s", protocol="sync", gamma=0.5).resolved_sigma_prime(8) == 4.0
    assert sorted(tbase.ALL_PRESETS) == sorted(jbase.ALL_PRESETS)
    for name in ("acpd_lag", "acpd_async", "acpd_partial_work", "acpd_hierarchical"):
        assert (dataclasses.asdict(tbase.ALL_PRESETS[name](K, D))
                == dataclasses.asdict(jbase.ALL_PRESETS[name](K, D)))
    # Every registry protocol now has its default, the JAX package's; the
    # reference loops still cover group and sync only and name the engine.
    for name in ("acpd_lag", "acpd_async", "acpd_partial_work", "acpd_hierarchical",
                 "acpd_adaptive", "cocoa_v1", "cocoa_plus_solver"):
        assert (tbase.ALL_PRESETS[name](K, D).resolved_sigma_prime(K)
                == jbase.ALL_PRESETS[name](K, D).resolved_sigma_prime(K)), name
    with pytest.raises(ValueError, match="run_method"):
        tacpd.run_method_reference(tp, tbase.acpd_async(K, D), TCluster(K),
                                   num_outer=1, device="cpu")
    cfg = tacpd.acpd_config(8, rho_d=1000, d=47236)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jacpd.acpd_config(8, rho_d=1000, d=47236))
