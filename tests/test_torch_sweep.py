"""The port's sweeps on the CPU: ``map`` cells equal solo runs, ``vmap`` close.

``repro_torch.api.sweep`` runs a whole grid as one run function (one
captured CUDA graph on the card). Under ``batch="map"`` every cell equals
its solo ``Session(executor="scan")`` run bit for bit (the JAX package's
contract); ``batch="vmap"`` (all cells' workers as the rows of one kernel
launch a round) is held to ``map`` at rtol 1e-5 / atol 1e-7. The shard
rules are the JAX package's table.
"""

import dataclasses

import numpy as np
import pytest

from repro.api import sweep as jsweep
from repro_torch.api import problems as tproblems
from repro_torch.api import sweep
from repro_torch.api.session import Session
from repro_torch.api.spec import ExperimentSpec, MethodEntry
from repro_torch.core import baselines as tbase
from repro_torch.core import executor
from repro_torch.core.simulate import ClusterModel

K, D, H = 4, 192, 24


@pytest.fixture(scope="module")
def problem():
    return tproblems.rcv1_like(K=K, d=D, n_per_worker=24, device="cpu")


def _assert_cell_equals_solo(problem, variant, num_outer, eval_every, cl):
    solo = Session(problem, variant.result.method, cl, num_outer=num_outer,
                   seed=variant.seed, eval_every=eval_every, executor="scan",
                   device="cpu").run()
    got = variant.result
    assert [dataclasses.asdict(r) for r in got.records] == [
        dataclasses.asdict(r) for r in solo.records]
    assert np.array_equal(got.w, solo.w) and np.array_equal(got.alpha, solo.alpha)
    if solo.alpha_applied is not None:
        assert np.array_equal(got.alpha_applied, solo.alpha_applied)
    assert [variant.rounds[r.iteration - 1].sim_time for r in solo.records] == [
        r.sim_time for r in solo.records]


SWEEPS = {
    "cocoa_plus": (tbase.cocoa_plus(K, H=H), 4, None),
    "cocoa_accelerated": (tbase.cocoa_plus_solver(K, H=H, local_solver="accelerated"), 3,
                          None),
    "cocoa_importance": (tbase.cocoa_v1(K, H=H, local_solver="importance"), 3, None),
    "lag": (tbase.acpd_lag(K, D, B=2, T=4, rho_d=16, H=H, lag_window=2), 2,
            ("constant", ("pareto", {"shape": 1.8, "scale": 0.5}))),
}


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_map_cells_equal_solo_runs_and_vmap_is_close(problem, name):
    m, outer, delays = SWEEPS[name]
    cl = ClusterModel(K, straggler_sigma=3.0)
    gammas = (0.5, 1.0) if m.protocol != "cocoa" else (0.1, 0.25)
    grid = dict(num_outer=outer, seeds=(1, 2), gammas=gammas, delays=delays, eval_every=2)
    clusters = dict(sweep._delay_variants(cl, delays))  # each cell's own cluster
    executor.reset_stats()
    mapped = sweep.run_sweep(problem, m, cl, batch="map", **grid)
    vmapped = sweep.run_sweep(problem, m, cl, batch="vmap", **grid)
    n_delays = 1 if delays is None else len(delays)
    assert len(mapped) == len(vmapped) == 4 * n_delays
    stat = "sweep_lag" if m.protocol == "lag" else "sweep"
    assert executor.STATS[f"{stat}_calls"] == 2 and executor.STATS[f"{stat}_traces"] == 2
    # delay-major, then seed, then gamma
    names = [d if isinstance(d, str) else d[0] for d in (delays or ("constant",))]
    assert [(v.delay, v.seed, v.gamma) for v in mapped] == [
        (dl, s, g) for dl in names for s in (1, 2) for g in gammas]
    for a, b in zip(mapped, vmapped):
        assert (a.seed, a.gamma, a.delay) == (b.seed, b.gamma, b.delay)
        _assert_cell_equals_solo(problem, a, outer, 2, clusters[a.delay])
        np.testing.assert_allclose(b.result.w, a.result.w, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(b.result.alpha, a.result.alpha, rtol=1e-5, atol=1e-7)
        for x, y in zip(b.result.records, a.result.records):
            assert (x.iteration, x.sim_time, x.bytes_up, x.bytes_down) == (
                y.iteration, y.sim_time, y.bytes_up, y.bytes_down)
            np.testing.assert_allclose(x.gap, y.gap, rtol=1e-5, atol=1e-7)
        assert [dataclasses.astuple(r) for r in a.rounds] == [
            dataclasses.astuple(r) for r in b.rounds]
    # The same grid again captures nothing new.
    sweep.run_sweep(problem, m, cl, batch="map", **grid)
    assert executor.STATS[f"{stat}_traces"] == 2


def test_run_sweep_cells_takes_explicit_cells(problem):
    m = tbase.cocoa_plus(K, H=H)
    cells = [(ClusterModel(K, straggler_sigma=2.0), 3, 0.5),
             sweep.SweepCellSpec(ClusterModel(K, delay_model="pareto"), 4)]
    out = sweep.run_sweep_cells(problem, m, cells, num_outer=2, batch="map")
    assert [v.gamma for v in out] == [0.5, m.gamma]
    assert out[1].delay == "pareto"
    # A cell's sigma_prime=None is the protocol default for its gamma.
    assert out[0].result.method == dataclasses.replace(m, gamma=0.5, sigma_prime=None)
    solo = Session(problem, out[0].result.method, cells[0][0], num_outer=2,
                   seed=3, executor="scan", device="cpu").run()
    assert np.array_equal(out[0].result.w, solo.w)
    assert executor.finite_certificates(out).tolist() == [True, True]


def test_sweep_errors_match_the_jax_package(problem):
    cl = ClusterModel(K)
    m = tbase.cocoa_plus(K, H=H)
    with pytest.raises(ValueError, match="sweep-batchable"):
        sweep.run_sweep(problem, tbase.acpd(K, D, H=H), cl, num_outer=1)
    with pytest.raises(ValueError, match="sweep-batchable"):
        sweep.run_sweep(problem, tbase.acpd_partial_work(K, D, H=H, n_chunks=2), cl,
                        num_outer=1)
    with pytest.raises(ValueError, match="batch mode"):
        sweep.run_sweep(problem, m, cl, num_outer=1, batch="pmap")
    with pytest.raises(ValueError, match="empty"):
        sweep.run_sweep(problem, m, cl, num_outer=1, seeds=())
    with pytest.raises(ValueError, match="empty delay axis"):
        sweep.run_sweep(problem, m, cl, num_outer=1, delays=())
    with pytest.raises(ValueError, match="num_outer"):
        sweep.run_sweep(problem, m, cl, num_outer=0)
    with pytest.raises(ValueError, match="num_workers"):
        sweep.run_sweep_cells(problem, m, [(ClusterModel(K + 1), 0)], num_outer=1)
    with pytest.raises(ValueError, match="cells is empty"):
        sweep.run_sweep_cells(problem, m, [], num_outer=1)
    with pytest.raises(ValueError, match="cannot batch into a lag sweep"):
        sweep.run_sweep(problem, tbase.acpd_lag(K, D, H=H), cl, num_outer=1,
                        delays=("markov",))
    with pytest.raises(ValueError, match="lockstep protocol"):
        sweep.run_lockstep_sweep(problem, tbase.acpd_lag(K, D, H=H), cl, num_outer=1)
    assert sweep.sweep_supported(m, cl) == (True, "")
    assert not sweep.sweep_supported(tbase.acpd(K, D, H=H), cl)[0]
    spec = ExperimentSpec("s", tproblems.ProblemSpec("rcv1_like", {"K": K, "d": D}), cl,
                          (MethodEntry(m, 2),), target_gap=1e-3)
    with pytest.raises(ValueError, match="cannot early-stop"):
        sweep.sweep_spec(spec, m.name, device="cpu")
    out = sweep.sweep_spec(dataclasses.replace(spec, target_gap=None), m.name,
                           gammas=(0.5, 1.0), batch="map", device="cpu")
    assert len(out) == 2 and all(v.result.records for v in out)


@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("protocol", ["cocoa_plus", "lag"])
@pytest.mark.parametrize("num_workers", [4, 6, 3])
def test_resolve_shard_follows_the_jax_table(n_devices, protocol, num_workers):
    for shard in sweep.SHARD_MODES:
        try:
            want = jsweep.resolve_shard(shard, protocol=protocol, num_workers=num_workers,
                                        n_devices=n_devices)
        except ValueError as e:
            with pytest.raises(ValueError, match="shard='workers'"):
                sweep.resolve_shard(shard, protocol=protocol, num_workers=num_workers,
                                    n_devices=n_devices)
            assert "shard='workers'" in str(e)
            continue
        got = sweep.resolve_shard(shard, protocol=protocol, num_workers=num_workers,
                                  n_devices=n_devices)
        assert (got.mode, got.n_shards) == (want.mode, want.n_shards)
    with pytest.raises(ValueError, match="unknown shard mode"):
        sweep.resolve_shard("rows", protocol=protocol, num_workers=num_workers)
    # Without a card (this machine) a sweep resolves against one device.
    assert sweep.resolve_shard("auto", protocol=protocol, num_workers=num_workers) == \
        sweep.ShardPlan("none", 1)
