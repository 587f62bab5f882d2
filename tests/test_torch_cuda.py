"""The port's kernels on the card, against their plain versions.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The SDCA kernel's map modes (a worker map on the card with its error word,
``alpha`` and sigma' per row) are held to the host map and to separate
launches bit for bit, and the whole-run executor's captured graph to the
card's event engine bit for bit.
The file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the SDCA kernel sums its dot products in another order than the
plain version (per CTA of the cluster, then over the cluster), and the H
dependent steps compound that, so rtol 1e-4 / atol 1e-5 for every loss; the top-k kernel computes the plain version's ladders with the
same float32 roundings and makes its integer decisions, so its outputs are
equal exactly; the flash kernel sums its float32 products in tiles where the
plain version sums whole rows, so rtol 1e-5 / atol 2e-5 in float32 (the
CUDA-core kernel), and in bfloat16 (the tensor-core kernel, which rounds P
to bfloat16 before P V) atol 3e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import problems
from repro_torch.core import acpd, baselines, sdca
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import flash_attn, sdca_inner, topk_filter

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sdca_inputs(K, n_k, d, H, device, loss="ridge", idx_kind="uniform"):
    rng = np.random.default_rng(K * 1000 + n_k)
    X = rng.standard_normal((K, n_k, d)).astype(np.float32) / np.float32(np.sqrt(d))
    y = np.sign(rng.standard_normal((K, n_k))).astype(np.float32)
    w = (rng.standard_normal((K, d)) * 0.1).astype(np.float32)
    if loss == "ridge":
        alpha = (rng.standard_normal((K, n_k)) * 0.05).astype(np.float32)
    else:  # dual-feasible: y * alpha in (0, 1)
        alpha = (y * rng.uniform(0.05, 0.6, (K, n_k))).astype(np.float32)
    idx = rng.integers(0, n_k, (K, H)).astype(np.int32)
    if idx_kind == "repeats_and_outside":
        idx[:, 1::7] = idx[:, 0::7][:, : idx[:, 1::7].shape[1]]  # the same row twice in a row
        idx[:, 3::11] = -1
        idx[:, 5::13] = n_k
        idx[:, -1] = n_k + 5
    elif idx_kind == "one_inside":  # every step skipped but one: the epoch runs one step
        keep = idx[:, H // 2].copy()
        idx[:] = n_k + 3
        idx[:, H // 2] = keep
    elif idx_kind == "none_inside":  # every step skipped
        idx[:] = -2
    t = [torch.from_numpy(a).to(device) for a in (w, alpha, X, y)]
    norms = (t[2] * t[2]).sum(-1)
    return [*t, norms], torch.from_numpy(idx).to(device)


# (K, n_k, d, H, idx_kind); "max" is d = max_d(n_k), the kernel's limit.
SDCA_SHAPES = [(1, 32, 128, 64, "uniform"), (4, 64, 256, 200, "uniform"),
               (3, 128, 512, 150, "uniform"), (8, 16, 1024, 50, "uniform"),
               (2, 64, 47_236, 100, "uniform"),
               (2, 64, 1001, 120, "uniform"),  # odd d: no row is 16-byte aligned
               (2, 32, 47_237, 60, "uniform"),
               (3, 32, 300, 80, "uniform"),  # d below 16 x 32: a smaller cluster
               (2, 16, 20, 40, "uniform"),  # d below one warp: C = 1
               (1, 16, "max", 20, "uniform"),
               (16, 64, 4096, 100, "uniform"),  # K = 16 clusters
               (4, 64, 2048, 300, "repeats_and_outside"),
               (2, 16, 256, 1, "uniform"),  # one step
               (1, 32, 47_236, 1, "uniform"),
               (2, 32, 47_236, 2, "uniform"),
               (3, 32, 1001, 40, "one_inside"),
               (2, 16, 512, 30, "none_inside")]


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H,idx_kind", SDCA_SHAPES)
def test_sdca_kernel_matches_plain_and_repeats_bitwise(cuda, K, n_k, d, H, idx_kind, loss):
    if d == "max":
        d = sdca_inner.max_d(n_k)
    args, idx = _sdca_inputs(K, n_k, d, H, cuda, loss, idx_kind)
    lam, n, sp = 1e-3, K * n_k, 2.0
    before = ops.LAUNCHES["sdca_inner"]
    da_k, v_k = ops.sdca_epoch(*args, lam, n, sp, idx, loss=loss)
    assert ops.LAUNCHES["sdca_inner"] == before + 1
    # Both skip the steps outside [0, n_k), each for its own worker: the
    # plain loop gets the very same order.
    da_r, v_r = sdca.sdca_epoch_plain(loss, *args, lam, n, sp, idx)
    torch.testing.assert_close(da_k, da_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_k, v_r, rtol=1e-4, atol=1e-5)
    da_2, v_2 = ops.sdca_epoch(*args, lam, n, sp, idx, loss=loss)
    assert torch.equal(da_k, da_2) and torch.equal(v_k, v_2)  # no atomics


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H,workers", [
    (8, 64, 2048, 120, [5]), (8, 64, 2048, 120, [5, 2, 7]),
    (8, 64, 2048, 120, [0, 1, 2, 3, 4, 5, 6, 7]), (8, 64, 2048, 120, [7, 3, 0, 6, 1, 2, 5, 4]),
    (4, 32, 47_236, 60, [2, 2, 0]), (8, 32, 47_236, 40, [5, 2, 7, 0])])
def test_sdca_kernel_worker_map(cuda, K, n_k, d, H, workers, loss):
    # Cluster b reads worker workers[b]'s rows: equal to the plain version on
    # the same map, bit for bit the unmapped launch on the gathered copy
    # (the same plan, B clusters), and bit for bit itself on repeat. The
    # identity map is bit for bit the unmapped launch.
    args, idx_all = _sdca_inputs(K, n_k, d, H, cuda, loss, "repeats_and_outside")
    w, alpha, X, y, norms = args
    B = len(workers)
    w_b, idx = w[:B].contiguous(), idx_all[:B].contiguous()
    lam, n, sp = 1e-3, K * n_k, 2.0
    before = ops.LAUNCHES["sdca_inner"]
    da_m, v_m = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                               workers=workers)
    assert ops.LAUNCHES["sdca_inner"] == before + 1
    assert da_m.shape == (B, n_k) and v_m.shape == (B, d)
    da_r, v_r = sdca.sdca_epoch_plain(loss, w_b, alpha, X, y, norms, lam, n, sp, idx,
                                      workers)
    torch.testing.assert_close(da_m, da_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_m, v_r, rtol=1e-4, atol=1e-5)
    g = torch.tensor(workers, device=cuda)
    da_g, v_g = ops.sdca_epoch(w_b, alpha[g].contiguous(), X[g].contiguous(),
                               y[g].contiguous(), norms[g].contiguous(), lam, n, sp, idx,
                               loss=loss)
    assert torch.equal(da_m, da_g) and torch.equal(v_m, v_g)
    da_2, v_2 = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                               workers=workers)
    assert torch.equal(da_m, da_2) and torch.equal(v_m, v_2)
    if workers == list(range(K)):
        assert torch.equal(da_m, ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx,
                                                loss=loss)[0])
    with pytest.raises(ValueError, match="int32 tensor|map_error"):
        ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss, workers=g)
    with pytest.raises(ValueError, match=r"\[0, 8\)|\[0, 4\)"):
        ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                       workers=[K] + workers[1:])


@pytest.mark.parametrize("loss", ["ridge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H,workers", [
    (8, 64, 2048, 120, [5, 2, 7]), (8, 32, 47_236, 40, [5, 2, 7, 0]),
    (4, 32, 4096, 60, [3, 3, 0])])
def test_sdca_kernel_device_map(cuda, K, n_k, d, H, workers, loss):
    # A map already on the card is taken as it is (no host sync): bit for bit
    # the host map's launch; a bad entry writes nothing and lands in the
    # error word, which raises once read.
    args, idx_all = _sdca_inputs(K, n_k, d, H, cuda, loss, "repeats_and_outside")
    w, alpha, X, y, norms = args
    B = len(workers)
    w_b, idx = w[:B].contiguous(), idx_all[:B].contiguous()
    lam, n, sp = 1e-3, K * n_k, 2.0
    da_h, v_h = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                               workers=workers)
    dmap = torch.tensor(workers, dtype=torch.int32, device=cuda)
    err = sdca_inner.map_error_word(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da_d, v_d = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                                   workers=dmap, map_error=err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(da_d, da_h) and torch.equal(v_d, v_h)
    sdca_inner.raise_map_error(err, K)
    bad = dmap.clone()
    bad[1] = K
    err = sdca_inner.map_error_word(cuda)
    ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss, workers=bad,
                   map_error=err)
    with pytest.raises(ValueError, match=f"entry {K} of batch row 1"):
        sdca_inner.raise_map_error(err, K)
    with pytest.raises(ValueError, match="map_error"):
        ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss, workers=dmap)


@pytest.mark.parametrize("V", [2, 3])
def test_sdca_kernel_rows_of_variants(cuda, V):
    # V variants x K workers over one X: alpha and sigma' read per row equal V
    # launches of the same cluster size bit for bit, and the plain version.
    K, n_k, d, H = 4, 64, 4096, 80
    args, idx = _sdca_inputs(K, n_k, d, H, cuda)
    w, alpha, X, y, norms = args
    lam, n = 1e-3, K * n_k
    sigmas = [1.0 + v for v in range(V)]
    alpha_v = torch.cat([(0.5 ** v) * alpha for v in range(V)]).contiguous()
    w_v = torch.cat([w * (v + 1) for v in range(V)]).contiguous()
    idx_v = torch.cat([idx.roll(v, dims=1) for v in range(V)]).contiguous()
    sig = torch.tensor([s for s in sigmas for _ in range(K)], device=cuda)
    wm = torch.arange(K, dtype=torch.int32, device=cuda).repeat(V)
    err = sdca_inner.map_error_word(cuda)
    da, v = ops.sdca_epoch(w_v, alpha_v, X, y, norms, lam, n, 0.0, idx_v, workers=wm,
                           map_error=err, alpha_rows=True, sigma_rows=sig)
    plan = sdca_inner._plan_dict(K, n_k, d, sdca_inner.plan(V * K, n_k, d)["cluster"])
    for i, s_ in enumerate(sigmas):
        rows = slice(i * K, (i + 1) * K)
        da_i, v_i = sdca_inner._launch(w_v[rows].contiguous(), alpha_v[rows].contiguous(),
                                       X, y, norms, lam, n, s_, idx_v[rows].contiguous(),
                                       "ridge", plan)
        assert torch.equal(da[rows], da_i) and torch.equal(v[rows], v_i)
    da_r, v_r = sdca.sdca_epoch_plain("ridge", w_v, alpha_v, X, y, norms, lam, n, 0.0,
                                      idx_v, wm, alpha_rows=True, sigma_rows=sig)
    torch.testing.assert_close(da, da_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v, v_r, rtol=1e-4, atol=1e-5)


SCAN_CASES = {
    "sync": lambda K, d, H: baselines.cocoa_plus(K, H=H),
    "cocoa_importance": lambda K, d, H: baselines.cocoa_v1(K, H=H, local_solver="importance"),
    "cocoa_plus_accelerated": lambda K, d, H: baselines.cocoa_plus_solver(
        K, H=H, local_solver="accelerated"),
    "lag": lambda K, d, H: baselines.acpd_lag(K, d, B=2, T=5, rho_d=32, H=H, lag_window=3),
    "partial_work": lambda K, d, H: baselines.acpd_partial_work(K, d, B=2, T=5, rho_d=32,
                                                                H=H, n_chunks=4),
}


@pytest.mark.parametrize("delay", ["constant", "pareto"])
@pytest.mark.parametrize("name", sorted(SCAN_CASES))
def test_scan_on_the_card_equals_its_event_run(cuda, name, delay):
    # The whole-run executor as one captured graph: equal to the card's event
    # engine bit for bit, one capture for two runs, launches by the event
    # engine's rule, the replay free of host syncs.
    from repro_torch.api.session import Session
    from repro_torch.core import executor

    K, d, H = 4, 512, 64
    m = SCAN_CASES[name](K, d, H)
    cl = ClusterModel(K, straggler_sigma=4.0, delay_model=delay)
    problem = problems.rcv1_like(K=K, d=d, n_per_worker=64, device=cuda)
    outer = 2 if m.protocol in ("lag", "partial_work") else 4
    before = ops.LAUNCHES["sdca_inner"]
    event = Session(problem, m, cl, num_outer=outer, seed=3, executor="event",
                    device=cuda).run()
    want = ops.LAUNCHES["sdca_inner"] - before
    executor.clear_cache()
    executor.reset_stats()
    runs = []
    executor.REPLAY_SYNC_DEBUG = "error"
    try:
        for _ in range(2):
            before = ops.LAUNCHES["sdca_inner"]
            runs.append(Session(problem, m, cl, num_outer=outer, seed=3, executor="scan",
                                device=cuda).run())
            assert ops.LAUNCHES["sdca_inner"] - before == want
    finally:
        executor.REPLAY_SYNC_DEBUG = 0
    assert sum(v for k, v in executor.STATS.items() if k.endswith("_traces")) == 1
    for run in runs:
        assert [r.__dict__ for r in run.records] == [r.__dict__ for r in event.records]
        assert np.array_equal(run.w, event.w) and np.array_equal(run.alpha, event.alpha)


@pytest.mark.parametrize("C", [8, 16])
def test_sdca_kernel_at_every_cluster_size(cuda, C):
    # K = 16 workers at RCV1 width, at both cluster sizes whose slices fit a
    # CTA (below C = 8 they do not), whether or not all 16 clusters are
    # resident at once.
    K, n_k, d, H = 16, 64, 47_236, 50
    args, idx = _sdca_inputs(K, n_k, d, H, cuda, "logistic")
    lam, n, sp = 1e-3, K * n_k, 2.0
    plan = sdca_inner._plan_dict(K, n_k, d, C)
    assert plan["cluster"] == C and plan["ctas"] == K * C and plan["stages"] >= 4
    da_k, v_k = sdca_inner._launch(*args, lam, n, sp, idx, "logistic", plan)
    da_r, v_r = sdca.sdca_epoch_plain("logistic", *args, lam, n, sp, idx)
    torch.testing.assert_close(da_k, da_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_k, v_r, rtol=1e-4, atol=1e-5)


def test_sdca_kernel_plan_follows_its_rule(cuda):
    main = sdca_inner.plan(8, 4096, 47_236)
    assert main["cluster"] > 1 and 4 <= main["stages"] <= 8
    assert main["per_thread"] * 256 * main["cluster"] >= 47_236
    assert main["active_clusters"] >= 8 or main["cluster"] == 16
    assert sdca_inner.plan(2, 16, 20)["cluster"] == 1  # a slice holds >= 32 floats
    assert sdca_inner.plan(1, 16, 32 * 16)["cluster"] == 16
    assert sdca_inner.plan(8, 4096, 47_236) == main  # a function of (device, K, n_k, d)
    # Where no C keeps all K clusters resident, the fewest waves, the larger C
    # on a tie (at K = 16 and RCV1's shape an H100 holds 7 clusters of 16 and
    # 15 of 8).
    for K, n_k, d in ((16, 4096, 47_236), (64, 64, 4096), (40, 16, 600)):
        chosen = sdca_inner.plan(K, n_k, d)
        waves = -(-K // chosen["active_clusters"])
        for C in (16, 8, 4, 2, 1):
            other = sdca_inner._plan_dict(K, n_k, d, C)
            if other["cluster"]:
                other_waves = -(-K // other["active_clusters"])
                assert waves < other_waves or (waves == other_waves
                                               and chosen["cluster"] >= C)


def test_sdca_kernel_refuses_what_it_does_not_take(cuda):
    args, idx = _sdca_inputs(1, 8, 64, 4, cuda)
    big = sdca_inner.max_d(2) + 1
    wide, _ = _sdca_inputs(1, 2, big, 4, cuda)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        ops.sdca_epoch(*wide, 1e-3, 2, 1.0, idx[:, :4].clamp(max=1))
    with pytest.raises(ValueError, match="int32"):
        ops.sdca_epoch(*args, 1e-3, 8, 1.0, idx.long())
    # Every loss launches the kernel, once each, through the solver's entry.
    x, y = args[2][0], args[3][0]
    for loss in ("ridge", "smoothed_hinge", "logistic"):
        before = ops.LAUNCHES["sdca_inner"]
        res = sdca.solve_subproblem_indices(args[0][0], args[1][0], x, y, args[4][0],
                                            1e-3, 8, 1.0, idx[0], loss=loss)
        assert ops.LAUNCHES["sdca_inner"] == before + 1
        assert res.v.is_cuda and bool(torch.isfinite(res.v).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,k", [(257, 1), (1024, 20), (4096, 1024), (47_236, 1000),
                                 (50_000, 12_500), (300_001, 3000)])
def test_topk_kernel_equals_plain_and_meets_contract(cuda, dtype, d, k):
    gen = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(d, generator=gen, device=cuda).to(dtype)
    before = ops.LAUNCHES["topk_filter"]
    sent, resid, mask = ops.topk_filter(x, k)
    assert ops.LAUNCHES["topk_filter"] == before + 1
    s_p, r_p, m_p = topk_filter.topk_filter_plain(x, k)
    assert torch.equal(mask, m_p) and torch.equal(sent, s_p) and torch.equal(resid, r_p)
    mag = x.float().abs()
    assert int(mask.sum()) == min(k, int((mag >= mag.max() * topk_filter.FLOOR).sum()))
    assert torch.equal(sent + resid, x)
    kept_min = torch.where(mask, mag, torch.full_like(mag, torch.inf)).min()
    drop_max = torch.where(mask, torch.zeros_like(mag), mag).max()
    assert float(kept_min) >= float(drop_max) * (1 - 6e-3) - 1e-6


def _topk_input(kind, d, dtype, device):
    gen = torch.Generator(device=device).manual_seed(d + 1)
    x = torch.randn(d, generator=gen, device=device)
    if kind == "zeros":
        x = torch.zeros(d, device=device)
    elif kind == "one_nonzero":
        x = torch.zeros(d, device=device)
        x[d // 2] = -3.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["randn", "zeros", "one_nonzero"])
@pytest.mark.parametrize("d", [1, 1000, 1024, 1025, 47_236, 4_000_000])
def test_topk_kernel_over_sizes_and_inputs(cuda, d, kind, dtype):
    """One design for every d: equal to the plain version, and its contract."""
    x = _topk_input(kind, d, dtype, cuda)
    mag = x.float().abs()
    above = (mag >= mag.max() * topk_filter.FLOOR) & (mag > 0)  # the ladder never admits 0
    for k in sorted({1, min(1000, d), d}):
        before = ops.LAUNCHES["topk_filter"]
        sent, resid, mask = ops.topk_filter(x, k)
        assert ops.LAUNCHES["topk_filter"] == before + 1
        s_p, r_p, m_p = topk_filter.topk_filter_plain(x, k)
        assert torch.equal(mask, m_p) and torch.equal(sent, s_p) and torch.equal(resid, r_p)
        assert int(mask.sum()) == min(k, int(above.sum()))
        assert torch.equal(sent + resid, x)
        kept_min = torch.where(mask, mag, torch.full_like(mag, torch.inf)).min()
        drop_max = torch.where(mask, torch.zeros_like(mag), mag).max()
        assert float(kept_min) >= float(drop_max) * (1 - 6e-3) - 1e-6


def test_topk_kernel_never_syncs_with_the_host(cuda):
    x = _topk_input("randn", 47_236, torch.float32, cuda)
    ops.topk_filter(x, 1000)  # build and load first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.topk_filter(x, 1000)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_topk_kernel_with_few_nonzeros(cuda):
    x = torch.zeros(2048, device=cuda)
    x[[3, 500, 1999]] = torch.tensor([1.0, -2.0, 0.5], device=cuda)
    sent, resid, mask = ops.topk_filter(x, 100)
    assert set(torch.nonzero(sent).flatten().tolist()) == {3, 500, 1999}
    assert torch.equal(mask, topk_filter.topk_filter_plain(x, 100)[2])


@pytest.mark.parametrize("preset", ["acpd", "cocoa_plus"])
def test_small_run_on_the_card_matches_the_host(cuda, preset):
    K, d, H = 4, 512, 64
    method = (baselines.acpd(K, d, B=2, T=5, rho_d=32, H=H) if preset == "acpd"
              else baselines.cocoa_plus(K, H=H))
    results = {}
    for dev in ("cpu", cuda):
        problem = problems.rcv1_like(K=K, d=d, n_per_worker=64, device=dev)
        orders = acpd.torch_visit_orders(64, H, 3, torch.device("cpu"))
        before = ops.LAUNCHES["sdca_inner"]
        results[str(dev)] = acpd.run_method_reference(
            problem, method, ClusterModel(K, straggler_sigma=4.0), num_outer=2,
            seed=3, visit_orders=orders, device=dev)
        launched = ops.LAUNCHES["sdca_inner"] - before
    assert launched == (K + 2 * (4 * 2 + K) if preset == "acpd" else 2)
    host, card = results["cpu"], results["cuda"]
    for h, c in zip(host.records, card.records):
        assert (h.bytes_up, h.bytes_down, h.sim_time) == (c.bytes_up, c.bytes_down, c.sim_time)
        np.testing.assert_allclose(c.gap, h.gap, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(card.w, host.w, rtol=1e-4, atol=1e-6)


ENGINE_CASES = {
    "group": lambda K, d, H: baselines.acpd(K, d, B=2, T=5, rho_d=32, H=H),
    "sync": lambda K, d, H: baselines.cocoa_plus(K, H=H),
    "async": lambda K, d, H: baselines.acpd_async(K, d, T=5, rho_d=32, H=H),
    "lag": lambda K, d, H: baselines.acpd_lag(K, d, B=2, T=5, rho_d=32, H=H, lag_window=3),
    "cocoa_importance": lambda K, d, H: baselines.cocoa_v1(K, H=H, local_solver="importance"),
    "cocoa_plus_accelerated": lambda K, d, H: baselines.cocoa_plus_solver(
        K, H=H, local_solver="accelerated"),
    "adaptive_b": lambda K, d, H: baselines.acpd_adaptive(K, d, T=5, rho_d=32, H=H),
    "hierarchical_b": lambda K, d, H: baselines.acpd_hierarchical(K, d, T=5, rho_d=32, H=H),
    "partial_work": lambda K, d, H: baselines.acpd_partial_work(K, d, B=2, T=5, rho_d=32,
                                                                H=H, n_chunks=4),
}


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_engine_run_on_the_card_matches_the_host(cuda, name):
    # Every protocol through run_method on the card and on the host, with the
    # same draws (a host generator): accounting equal, w and the gaps within
    # rtol 1e-4 (the kernel's sums run in another order than the plain loop's).
    K, d, H = 4, 512, 64
    method = ENGINE_CASES[name](K, d, H)
    results, launched = {}, 0
    for dev in ("cpu", cuda):
        problem = problems.rcv1_like(K=K, d=d, n_per_worker=64, device=dev)
        before = ops.LAUNCHES["sdca_inner"]
        results[str(dev)] = acpd.run_method(
            problem, method, ClusterModel(K, straggler_sigma=4.0), num_outer=2, seed=3,
            draws=sdca.TorchDraws(3, "cpu"), device=dev)
        launched = ops.LAUNCHES["sdca_inner"] - before
    rounds = 2 if method.protocol in ("sync", "cocoa", "cocoa_plus") else 2 * method.T
    per_wave = {"partial_work": 4, "cocoa_plus": 4}.get(method.protocol, 1)
    waves = rounds if method.protocol in ("sync", "cocoa", "cocoa_plus") else 1 + rounds
    assert launched == per_wave * waves
    host, card = results["cpu"], results["cuda"]
    assert len(host.records) == len(card.records) == rounds
    for h, c in zip(host.records, card.records):
        assert (h.bytes_up, h.bytes_down, h.sim_time, h.compute_time, h.comm_time) == (
            c.bytes_up, c.bytes_down, c.sim_time, c.compute_time, c.comm_time)
        np.testing.assert_allclose(c.gap, h.gap, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(card.w, host.w, rtol=1e-4, atol=1e-6)


FLASH_SHAPES = [(2, 64, 2, 2, 16, True), (1, 100, 1, 3, 32, True), (2, 48, 2, 1, 16, False),
                (1, 128, 4, 2, 64, True), (1, 96, 2, 2, 16, True),
                (1, 1000, 2, 5, 128, True), (2, 257, 8, 5, 128, False)]


def _flash_inputs(B, S, KV, G, hd, device, dtype=torch.float32):
    rng = np.random.default_rng(S * 7 + hd)
    q = rng.standard_normal((B, S, KV, G, hd)).astype(np.float32) * 0.4
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32) * 0.4
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in (q, k, v)]


@pytest.mark.parametrize("B,S,KV,G,hd,causal", FLASH_SHAPES)
def test_flash_kernel_matches_plain_and_repeats_bitwise(cuda, B, S, KV, G, hd, causal):
    q, k, v = _flash_inputs(B, S, KV, G, hd, cuda)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out = ops.flash_attention_fwd(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    want = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=2e-5)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, causal=causal))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_bf16(cuda, causal):
    q, k, v = _flash_inputs(2, 300, 8, 5, 128, cuda, torch.bfloat16)
    out = ops.flash_attention_fwd(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    want = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=3e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 129, 1000, 2049])
@pytest.mark.parametrize("G", [1, 5, 8])
@pytest.mark.parametrize("hd", [16, 32, 64, 128])
def test_flash_kernel_bf16_tensor_core_shapes(cuda, hd, G, S, causal):
    """Every hd's swizzle and descriptors, ragged S, and a bitwise repeat."""
    q, k, v = _flash_inputs(1, S, 2, G, hd, cuda, torch.bfloat16)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out = ops.flash_attention_fwd(q, k, v, causal=causal)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    want = ref.flash_attention_fwd_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=3e-2)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, causal=causal))


def test_flash_kernel_bf16_agrees_with_sdpa_at_the_serve_shape(cuda):
    """qwen3-14b's prefill shape against SDPA (timed in chip_smoke.py, never used)."""
    B, S, KV, G, hd = 4, 2048, 8, 5, 128
    q, k, v = _flash_inputs(B, S, KV, G, hd, cuda, torch.bfloat16)
    out = ops.flash_attention_fwd(q, k, v, causal=True)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q.reshape(B, S, KV * G, hd).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, enable_gqa=True)
    torch.testing.assert_close(out.float(), sdpa.transpose(1, 2).reshape(q.shape).float(),
                               rtol=0, atol=3e-2)


def test_flash_kernel_takes_prescaled_q(cuda):
    q, k, v = _flash_inputs(1, 130, 2, 5, 64, cuda)
    torch.testing.assert_close(ops.flash_attention_fwd(q * 0.125, k, v, sm_scale=1.0),
                               ops.flash_attention_fwd(q, k, v), rtol=1e-6, atol=1e-6)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _flash_inputs(1, 16, 2, 2, 16, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_fwd(*_flash_inputs(1, 16, 2, 2, 48, cuda))
    with pytest.raises(ValueError, match="dtype"):
        ops.flash_attention_fwd(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention_fwd(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attn.flash_attention_fwd_cuda(q, k.cpu(), v)
    qb, kb, vb = (t.bfloat16() for t in _flash_inputs(1, 17, 2, 2, 16, cuda))
    k_off = kb.flatten()[4:4 + 16 * 2 * 16].view(1, 16, 2, 16)  # starts 8 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        ops.flash_attention_fwd(qb[:, :16], k_off, vb[:, :16])


# ---------------------------------------------------------------------------
# The graph cache under the experiment service's threads, and its keys.
# ---------------------------------------------------------------------------


def _service_problem(device):
    return problems.rcv1_like(K=4, d=512, n_per_worker=64, device=device)


def _solo_scan(problem, method, cell, num_outer):
    from repro_torch.api.session import Session

    m = dataclasses_replace(method, gamma=cell.gamma, sigma_prime=cell.sigma_prime)
    return Session(problem, m, cell.cluster, num_outer=num_outer, seed=cell.seed,
                   eval_every=1, executor="scan", device=problem.X.device).run()


def dataclasses_replace(obj, **kw):
    import dataclasses

    return dataclasses.replace(obj, **kw)


def _cells(seeds, gammas, sigma=4.0):
    from repro_torch.api.sweep import SweepCellSpec

    return [SweepCellSpec(ClusterModel(4, straggler_sigma=sigma), s, g)
            for s, g in zip(seeds, gammas)]


def _same(a, b):
    return ([r.__dict__ for r in a.records] == [r.__dict__ for r in b.records]
            and np.array_equal(a.w, b.w) and np.array_equal(a.alpha, b.alpha))


def test_two_threads_replay_one_sweep_graph(cuda):
    import threading

    from repro_torch.api.sweep import run_sweep_cells
    from repro_torch.core import executor

    problem = _service_problem(cuda)
    m = baselines.cocoa_plus_solver(4, H=64)
    executor.clear_cache()
    run_sweep_cells(problem, m, _cells((0, 1), (0.5, 1.0)), num_outer=3, batch="map")
    traces = executor.STATS["sweep_traces"]
    work = {t: _cells((10 * t, 10 * t + 1), (0.25 + 0.25 * t, 1.0)) for t in range(2)}
    want = {t: [_solo_scan(problem, m, c, 3) for c in cells] for t, cells in work.items()}
    got, errors = {0: [], 1: []}, []
    barrier = threading.Barrier(2)

    def replay(t):
        try:
            barrier.wait()
            for _ in range(6):
                got[t].append(run_sweep_cells(problem, m, work[t], num_outer=3,
                                              batch="map"))
        except Exception as e:  # analysis: fail-fast-ok (re-raised on the test's thread)
            errors.append(e)

    threads = [threading.Thread(target=replay, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    assert executor.STATS["sweep_traces"] == traces
    for t in range(2):
        for variants in got[t]:
            assert all(_same(v.result, w) for v, w in zip(variants, want[t]))


def test_capture_on_one_thread_beside_an_event_run_on_another(cuda):
    import threading

    from repro_torch.api.session import Session
    from repro_torch.api.sweep import run_sweep_cells
    from repro_torch.core import executor

    problem = _service_problem(cuda)
    acpd_m = baselines.acpd(4, 512, B=2, T=5, rho_d=32, H=64)
    cl = ClusterModel(4, straggler_sigma=4.0)
    want_event = Session(problem, acpd_m, cl, num_outer=2, seed=3, executor="event",
                         device=cuda).run()
    lengths = (2, 3, 4, 5)
    m = baselines.cocoa_plus(4, H=64)
    cells = _cells((0, 1), (0.5, 1.0))
    want_sweep = {R: [_solo_scan(problem, m, c, R) for c in cells] for R in lengths}
    executor.clear_cache()
    traces = executor.STATS["sweep_traces"]
    done, errors, event_runs, sweeps = threading.Event(), [], [], {}

    def events():
        try:
            while not done.is_set() or len(event_runs) < 2:
                event_runs.append(Session(problem, acpd_m, cl, num_outer=2, seed=3,
                                          executor="event", device=cuda).run())
        except Exception as e:  # analysis: fail-fast-ok (re-raised on the test's thread)
            errors.append(e)

    th = threading.Thread(target=events)
    th.start()
    try:
        for R in lengths:  # each a new signature: a capture beside the event runs
            sweeps[R] = run_sweep_cells(problem, m, cells, num_outer=R, batch="map")
    finally:
        done.set()
        th.join()
    assert not errors, errors
    assert executor.STATS["sweep_traces"] == traces + len(lengths)
    assert all(_same(r, want_event) for r in event_runs)
    for R in lengths:
        assert all(_same(v.result, w) for v, w in zip(sweeps[R], want_sweep[R]))


@pytest.mark.parametrize("batch", ["map", "vmap"])
def test_waves_of_three_and_four_cells_share_one_capture(cuda, batch):
    from repro_torch.api.sweep import run_sweep_cells
    from repro_torch.core import executor

    problem = _service_problem(cuda)
    m = baselines.cocoa_plus_solver(4, H=64)
    executor.clear_cache()
    traces = executor.STATS["sweep_traces"]
    three = _cells((0, 1, 2), (0.5, 1.0, 0.5))
    four = _cells((5, 6, 7, 8), (0.25, 0.75, 1.0, 0.5))
    out = [run_sweep_cells(problem, m, cells, num_outer=3, eval_every=1, batch=batch)
           for cells in (three, four)]
    assert executor.STATS["sweep_traces"] == traces + 1
    for variants, cells in zip(out, (three, four)):
        for v, c in zip(variants, cells):
            solo = _solo_scan(problem, m, c, 3)
            if batch == "map":
                assert _same(v.result, solo)
            else:
                np.testing.assert_allclose(v.result.w, solo.w, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("protocol", ["cocoa_plus_solver", "lag"])
def test_nan_gamma_batch_adds_no_capture(cuda, protocol):
    import math

    from repro_torch.api.sweep import run_sweep_cells
    from repro_torch.core import executor

    problem = _service_problem(cuda)
    m = (baselines.cocoa_plus_solver(4, H=64) if protocol == "cocoa_plus_solver"
         else baselines.acpd_lag(4, 512, B=2, T=3, rho_d=32, H=64))
    assert m.sigma_prime is None
    stat = "sweep_lag" if protocol == "lag" else "sweep"
    outer = 1 if protocol == "lag" else 3
    executor.clear_cache()
    run_sweep_cells(problem, m, _cells((0, 1), (0.5, 1.0)), num_outer=outer, batch="map")
    traces = executor.STATS[f"{stat}_traces"]
    cells = _cells((2, 3), (math.nan, 0.5))
    out = run_sweep_cells(problem, m, cells, num_outer=outer, batch="map")
    assert executor.STATS[f"{stat}_traces"] == traces
    assert executor.finite_certificates(out).tolist() == [False, True]
    assert _same(out[1].result, _solo_scan(problem, m, cells[1], outer))
