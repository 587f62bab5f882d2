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
equal exactly, and so does the exchange's threshold kernel, whose threshold
equals the plain rounds' bit for bit; the flash kernel sums its float32 products in tiles where the
plain version sums whole rows, so rtol 1e-5 / atol 2e-5 in float32 (the
CUDA-core kernel), and in bfloat16 (the tensor-core kernel, which rounds P
to bfloat16 before P V) atol 3e-2; its log-sum-exp rtol 1e-5 with atol
2e-5 in float32 and 1e-4 in bfloat16, with and without a window or a
softcap. The full-range launch (``exploit_window=False``) equals the
windowed launch bit for bit. The held-experts MoE layer's grouped GEMMs
and cuBLAS's per-expert products both round each product to bfloat16 and
sum in float32 in other tiles: within 2 % of each tensor's largest
magnitude.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.api import problems
from repro_torch.core import acpd, baselines, sdca
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import exchange_threshold, flash_attn, sdca_inner, topk_filter

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


THRESHOLD_KINDS = ("randn", "ties", "zeros99", "zeros", "huge", "edges")


def _threshold_input(kind, n, device):
    gen = torch.Generator(device=device).manual_seed(n + THRESHOLD_KINDS.index(kind))
    x = torch.randn(n, generator=gen, device=device)
    if kind == "ties":
        x = torch.randint(-3, 4, (n,), generator=gen, device=device).float() * 0.25
    elif kind == "zeros99":
        x = torch.where(torch.rand(n, generator=gen, device=device) < 0.01, x, 0.0)
    elif kind == "zeros":
        x = torch.zeros(n, device=device)
    elif kind == "huge":
        x[n // 3] = 3e37
    elif kind == "edges":  # every edge of round 1's ladder under max 1, and its neighbours
        ratio = torch.log(torch.tensor(2.0**-22, device=device)) / 63
        e = torch.exp(ratio * torch.arange(65, device=device, dtype=torch.float32))
        e = torch.cat([e, torch.nextafter(e, torch.zeros_like(e)),
                       torch.nextafter(e, torch.ones_like(e))])
        x = e[torch.randint(0, e.numel(), (n,), generator=gen, device=device)]
        x = torch.where(torch.rand(n, generator=gen, device=device) < 0.5, x, -x)
    return x


def _bits(t):
    return t.view(torch.int32).item()


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("kind", THRESHOLD_KINDS)
@pytest.mark.parametrize("n", [1024, 5120, 6_553_600, 91_750_400])
def test_exchange_threshold_kernel_equals_plain_bitwise(cuda, n, kind, refine):
    """The threshold, and with it the mask and the kept count, equal the plain
    rounds' on the card bit for bit; a call is one counted launch, repeats
    bit for bit and never syncs with the host."""
    x = _threshold_input(kind, n, cuda)
    mag = x.abs()
    for k in sorted({1, max(1, int(n / 64)), n}):
        want = exchange_threshold.exchange_threshold_plain(x, k, refine)
        before = ops.LAUNCHES["exchange_threshold"]
        got = ops.exchange_threshold(x, k, refine)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = ops.exchange_threshold(x, k, refine)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert ops.LAUNCHES["exchange_threshold"] == before + 2
        assert got.shape == () and got.dtype == torch.float32 and got.is_cuda
        assert _bits(got) == _bits(want), (k, float(got), float(want))
        assert _bits(again) == _bits(got)
        assert torch.equal(mag >= got, mag >= want)


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 9, 1023, 4099, 300_001])
def test_exchange_threshold_kernel_unaligned_and_shaped(cuda, n, offset):
    """A scalar head before the float4 body and a tail after it; a leaf's
    group slice and a 2-D view; a tensor that needs a copy first."""
    base = _threshold_input("randn", n + offset, cuda)
    x = base[offset:]
    k = max(1, n // 64)
    want = exchange_threshold.exchange_threshold_plain(x, k)
    assert _bits(ops.exchange_threshold(x, k)) == _bits(want)
    if n % 3 == 0:
        assert _bits(ops.exchange_threshold(x.reshape(3, -1), k)) == _bits(want)
    assert _bits(ops.exchange_threshold(x.to(torch.bfloat16), k)) == _bits(
        exchange_threshold.exchange_threshold_plain(x.to(torch.bfloat16), k))
    grouped = torch.stack([x, 2 * x]).reshape(2, n)
    assert _bits(ops.exchange_threshold(grouped[1], k)) == _bits(
        exchange_threshold.exchange_threshold_plain(grouped[1], k))
    if n > 1:
        strided = base[: 2 * (n // 2): 2]
        assert _bits(ops.exchange_threshold(strided, 1)) == _bits(
            exchange_threshold.exchange_threshold_plain(strided, 1))


def test_torch_divides_by_the_scalar_63_as_a_multiply_by_its_reciprocal(cuda):
    """The kernel's ``kInv63``: torch computes ``x / 63`` for a float32 CUDA
    tensor as ``x * (1.0f / 63)``, which differs from a true division on
    some inputs."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = -torch.rand(1 << 20, generator=gen, device=cuda) * 16
    recip = a * torch.tensor(1.0 / 63.0, dtype=torch.float32, device=cuda)
    true = a / torch.tensor(63.0, dtype=torch.float32, device=cuda)
    assert torch.equal(a / 63, recip)
    assert not torch.equal(recip, true)


def test_exchange_threshold_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="entries"):
        ops.exchange_threshold(torch.empty(0, device=cuda), 1)


def test_sparsify_leaf_on_the_card_equals_the_plain_threshold(cuda, monkeypatch):
    """The exchange's filter with the kernel and with the plain rounds
    swapped into ``ops``: the same mask, sent values and kept count."""
    from repro_torch.core import compress

    dw = torch.stack([_threshold_input("randn", 6_553_600, cuda) * s for s in (1.0, 1e-3)])
    dw = dw.reshape(2, 5120, 1280)
    before = ops.LAUNCHES["exchange_threshold"]
    sent, mask = compress.sparsify_leaf(dw, 1 / 64)
    assert ops.LAUNCHES["exchange_threshold"] == before + 2
    monkeypatch.setattr(ops, "exchange_threshold", exchange_threshold.exchange_threshold_plain)
    sent_p, mask_p = compress.sparsify_leaf(dw, 1 / 64)
    assert torch.equal(mask, mask_p) and torch.equal(sent, sent_p)
    assert int(mask.sum()) == int(mask_p.sum())


# The exchange's split (csrc/exchange_apply.cu): (residual shape (G, *leaf),
# group, offset of grad and acc in their buffers) -- an odd length whose
# slice at g = 1 starts 4 bytes past 16-byte alignment, with grad and acc
# offset alike (a scalar head, the float4 body, a scalar tail) and not (every
# coordinate scalar), a leaf sent densely, a stacked (48, ...) leaf's slice.
APPLY_LEAVES = {"unaligned": ((3, 300_001), 1, 1), "misaligned": ((3, 300_001), 1, 0),
                "small": ((2, 600), 1, 0), "stacked": ((3, 48, 64, 80), 2, 0)}
APPLY_MODES = {"sparse_p0": (0.0, False), "sparse_p1": (1.0, False), "dense_p1": (1.0, True)}
APPLY_BYTES = dict(dense_bytes=(4, 0), sparse_bytes=(8, 0))


def _apply_plant(flat, device):
    """+inf, -inf and NaN at the head, inside and at the tail of a flat view."""
    n = flat.numel()
    at = torch.tensor([0, 2, n // 3, n // 2 + 1, n - 2, n - 1], device=device)
    flat[at] = torch.tensor([math.inf, math.nan, -math.inf, math.nan, math.inf, -math.inf],
                            device=device)


def _apply_case(leaf, grad_dtype, nonfinite, device):
    shape, g, off = APPLY_LEAVES[leaf]
    gen = torch.Generator(device=device).manual_seed(sum(shape) + g)
    res = torch.randn(shape, generator=gen, device=device) * 0.1
    n = math.prod(shape[1:])
    grad = torch.randn(n + off, generator=gen, device=device).to(grad_dtype)[off:]
    acc = torch.randn(n + off, generator=gen, device=device)[off:]
    grad, acc = grad.view(shape[1:]), acc.view(shape[1:])
    if nonfinite:
        _apply_plant(res[g].view(-1), device)
    return res, g, grad, acc


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("mode", list(APPLY_MODES))
@pytest.mark.parametrize("leaf", list(APPLY_LEAVES))
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16, torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_exchange_apply_kernels_equal_plain_bitwise(cuda, grad_dtype, leaf, mode, nonfinite):
    """Both passes equal their plain versions on the card bit for bit (int32
    views, so NaNs too), the accounting included; two counted launches, no
    host sync."""
    from repro_torch.kernels import exchange_apply as apply_mod

    res, g, grad, acc = _apply_case(leaf, grad_dtype, nonfinite, cuda)
    pg_v, dense_v = APPLY_MODES[mode]
    pg = torch.tensor(pg_v, device=cuda)
    dense = torch.tensor(dense_v, device=cuda)
    r_k, r_p = res.clone(), res.clone()
    before = ops.LAUNCHES["exchange_apply"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.exchange_apply_add(r_k[g], grad)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    apply_mod.exchange_apply_add_plain(r_p[g], grad)
    assert torch.equal(r_k.view(torch.int32), r_p.view(torch.int32))
    thresh = None
    if leaf != "small":  # one threshold for both sides, from the kernel
        thresh = ops.exchange_threshold(r_k[g], max(1, r_k[g].numel() // 64))
    counts_k = [torch.tensor(3.0, device=cuda), torch.tensor(40.0, device=cuda)]
    counts_p = [c.clone() for c in counts_k]
    a_k, a_p = acc, acc.clone()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.exchange_apply_split(r_k[g], a_k, pg, dense, thresh, *counts_k, **APPLY_BYTES)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    apply_mod.exchange_apply_split_plain(r_p[g], a_p, pg, dense, thresh, *counts_p,
                                         **APPLY_BYTES)
    assert ops.LAUNCHES["exchange_apply"] == before + 2
    for got, want in ((r_k, r_p), (a_k, a_p), *zip(counts_k, counts_p)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if mode != "sparse_p0":  # the split changed the residual
        assert not torch.equal(r_k[g].view(torch.int32), res[g].view(torch.int32))


def test_exchange_sequential_on_the_card_equals_the_plain_split(cuda, monkeypatch):
    """11 steps through two dense syncs, the kernels against the plain passes
    swapped into ``ops``: updates, residuals, sent fraction and bytes equal;
    two launches a leaf and group."""
    from repro_torch.core import exchange as exch_lib
    from repro_torch.kernels import exchange_apply as apply_mod
    from repro_torch.models.param import tree_flatten

    shapes = {"a": (40, 64), "b": (4099,), "c": (16,), "stacked": (48, 32, 80),
              "w": (512, 1280)}
    cfg = exch_lib.ExchangeConfig(num_groups=4, group_size=2, sync_period=5, rho=1 / 64)
    gen = torch.Generator(device=cuda).manual_seed(5)
    steps = [{k: torch.randn((4, *s), generator=gen, device=cuda).to(
        torch.float32 if k == "c" else torch.bfloat16) for k, s in shapes.items()}
        for _ in range(11)]
    params = {k: torch.zeros(s, device=cuda) for k, s in shapes.items()}

    def run():
        state = exch_lib.init_state(cfg, params)
        out = []
        for t, grads in enumerate(steps):
            update, state, m = exch_lib.exchange_sequential(
                cfg, lambda _, b, gr=grads: {k: v[b["i"]] for k, v in gr.items()}, params,
                {"i": torch.arange(4, device=cuda)}, state, torch.tensor(t, device=cuda))
            out.append((tree_flatten(update)[0],
                        [r.clone() for r in tree_flatten(state.residual)[0]],
                        m["exchange/sent_fraction"], m["exchange/bytes_step"]))
        return out

    before = ops.LAUNCHES["exchange_apply"]
    kernel = run()
    assert ops.LAUNCHES["exchange_apply"] - before == 2 * len(shapes) * 4 * len(steps)
    monkeypatch.setattr(ops, "exchange_apply_add", apply_mod.exchange_apply_add_plain)
    monkeypatch.setattr(ops, "exchange_apply_split", apply_mod.exchange_apply_split_plain)
    plain = run()
    for (u_k, r_k, f_k, b_k), (u_p, r_p, f_p, b_p) in zip(kernel, plain):
        assert all(torch.equal(a, b) for a, b in zip(u_k, u_p))
        assert all(torch.equal(a, b) for a, b in zip(r_k, r_p))
        assert torch.equal(f_k, f_p) and torch.equal(b_k, b_p)
    assert [float(f) for _, _, f, _ in kernel][4] == 1.0  # the dense sync sends everything


def test_exchange_apply_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    res, acc = torch.zeros(2, 1024, device=cuda), torch.zeros(1024, device=cuda)
    one, no = torch.tensor(1.0, device=cuda), torch.tensor(False, device=cuda)
    counts = (torch.zeros((), device=cuda), torch.zeros((), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.exchange_apply_add(res[:, 0], torch.zeros(2, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.exchange_apply_add(res[0], torch.zeros(2048, device=cuda)[::2])
    with pytest.raises(ValueError, match="grad must be"):
        ops.exchange_apply_add(res[0], torch.zeros(1024, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="res must be float32"):
        ops.exchange_apply_add(res[0].to(torch.bfloat16), torch.zeros(1024, device=cuda))
    with pytest.raises(ValueError, match="is on cpu"):
        ops.exchange_apply_add(res[0], torch.zeros(1024))
    with pytest.raises(ValueError, match="entries"):
        ops.exchange_apply_add(res[0], torch.zeros(1000, device=cuda))
    with pytest.raises(ValueError, match="is on cpu"):
        ops.exchange_apply_split(res[0], acc, torch.tensor(1.0), no, None, *counts,
                                 **APPLY_BYTES)
    with pytest.raises(ValueError, match="dense_step must be"):
        ops.exchange_apply_split(res[0], acc, one, one, None, *counts, **APPLY_BYTES)
    with pytest.raises(ValueError, match="acc must be float32"):
        ops.exchange_apply_split(res[0], acc.double(), one, no, None, *counts, **APPLY_BYTES)
    with pytest.raises(ValueError, match="overlaps"):
        ops.exchange_apply_split(res[0], res[0], one, no, None, *counts, **APPLY_BYTES)
    with pytest.raises(ValueError, match="thresh must be"):
        ops.exchange_apply_split(res[0], acc, one, no, one.reshape(1), *counts, **APPLY_BYTES)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,hd", [(63, 64), (1000, 128)])
@pytest.mark.parametrize("G", [1, 4, 5, 8])
def test_flash_kernel_lse_matches_plain(cuda, G, S, hd, causal, dtype):
    """The log-sum-exp of both kernels (G = 4 is phi3's) against the plain
    version's ``logsumexp``; asking for it leaves the output bit for bit as
    it was and is still one launch. Tolerance: the kernels sum the scores'
    exponentials per tile (the bf16 kernel in exp2 units), so rtol 1e-5 /
    atol 2e-5 in float32 and atol 1e-4 in bfloat16 (the scores are exact
    products of bf16 values in both)."""
    q, k, v = _flash_inputs(2, S, 2, G, hd, cuda, dtype)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    assert lse.shape == (2, 2, G, S) and lse.dtype == torch.float32
    _, want = ref.flash_attention_fwd_ref(q, k, v, causal=causal, return_lse=True)
    atol = 2e-5 if dtype == torch.float32 else 1e-4
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=atol)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, causal=causal))


def test_training_step_on_the_kernel_matches_the_plain_forward(cuda, monkeypatch):
    """codeqwen1.5-7b reduced in float32 on the card: the loss and gradients
    of the kernel path against the same step with the plain forward
    (``ref.flash_attention_fwd_ref`` put in the wrapper's place), then one
    ACPD train step of each. Loss rtol 1e-5; each gradient leaf within 2e-3
    of its largest entry (the saturated attention at this init, see
    ``tests/test_torch_train.py``); the exchange's participation and dense
    step equal."""
    from repro_torch.configs import get_config
    from repro_torch.core import exchange as tex
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.models.param import tree_flatten, tree_map, tree_materialize
    from repro_torch.optim import optimizers

    cfg = get_config("codeqwen1.5-7b").reduced()
    base = tree_materialize(model.model_spec(cfg), torch.Generator(cuda).manual_seed(0), cuda)
    batch = TokenPipeline(cfg, 8, 64, seed=1, device=cuda).next_batch()
    setup = steps.TrainSetup(cfg=cfg, optimizer=optimizers.OptimizerConfig(warmup_steps=1),
                             exchange=tex.ExchangeConfig(num_groups=4, group_size=2, rho=1 / 64))
    results = []
    for path in ("kernel", "plain"):
        if path == "plain":
            monkeypatch.setattr(ops, "flash_attention_fwd",
                                lambda q, k, v, **kw: ref.flash_attention_fwd_ref(q, k, v, **kw))
        params = tree_map(torch.clone, base)
        before = ops.LAUNCHES["flash_attention_fwd"]
        loss, grads = steps.value_and_grad(
            lambda p, b: model.train_loss(p, b, cfg), params, batch)
        step = steps.build_train_step(setup, cuda)
        state = (optimizers.init_state(setup.optimizer, params),
                 tex.init_state(setup.exchange, params))
        _, _, _, m = step(params, *state, batch)
        launched = ops.LAUNCHES["flash_attention_fwd"] - before
        results.append((loss, tree_flatten(grads)[0], m, launched))
    (l_k, g_k, m_k, n_k), (l_p, g_p, m_p, n_p) = results
    assert n_k == 2 * 2 + (1 + 2 * 4) * 2 and n_p == 0  # the kernel ran on every layer
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=0)
    for a, b in zip(g_k, g_p):
        assert float((a - b).abs().max()) <= 2e-3 * float(b.abs().max())
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0)
    for key in ("exchange/participating", "exchange/dense_step"):
        assert float(m_k[key]) == float(m_p[key])


# (B, S, KV, G, hd, window): gemma3's local shape cut to B 1 (W 1,024 at S
# 2,048, G 2), W = S, W 37 at a ragged S (not a multiple of either kernel's
# tile), W 1 (only the diagonal), hd 80 and 16 with a window.
WINDOW_SHAPES = [(1, 2048, 2, 2, 128, 1024), (1, 1000, 2, 2, 128, 1000),
                 (1, 333, 2, 5, 64, 37), (1, 300, 2, 1, 80, 37), (2, 129, 1, 3, 16, 1),
                 (1, 700, 1, 2, 128, 200)]


def _close(got, want, dtype, lse=False):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=2e-5)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=1e-5 if lse else 0,
                                   atol=1e-4 if lse else 3e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,KV,G,hd,W", WINDOW_SHAPES)
def test_flash_kernel_window_matches_plain(cuda, B, S, KV, G, hd, W, causal, dtype):
    """The window in both kernels: tiles below it skipped (the stage ring
    counted by iteration from k_lo), tiles across its edge masked per 64-row
    consumer, rows whose first tiles are wholly masked wiped by the first
    real key; the output and the lse against the plain version, one launch,
    and the output with lse bit for bit the launch without."""
    q, k, v = _flash_inputs(B, S, KV, G, hd, cuda, dtype)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, window=W, return_lse=True)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=W,
                                                 return_lse=True)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype, lse=True)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, causal=causal, window=W))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 63, 129, 1000, 1024])
@pytest.mark.parametrize("G", [1, 2])
def test_flash_kernel_head_dim_80(cuda, G, S, causal, dtype):
    """hubert-xlarge's hd 80 (five 16-column boxes at the 32-byte swizzle,
    m64n80k16, five k16 steps of Q K^T in bf16; Tile<80> in float32), its
    encoder's non-causal path and a ragged S; output and lse."""
    q, k, v = _flash_inputs(2, S, 2, G, 80, cuda, dtype)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, causal=causal, return_lse=True)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype, lse=True)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, causal=causal))


# (B, S, KV, G, hd, window, causal): the softcap with and without a window,
# causal and not, every kernel's head dims 64, 128, 80 and 16, ragged S.
SOFTCAP_CASES = [(1, 333, 2, 5, 64, None, True), (2, 257, 2, 2, 128, None, False),
                 (1, 1000, 2, 2, 128, 200, True), (1, 300, 2, 1, 80, None, False),
                 (2, 129, 1, 3, 16, 37, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("cap", [50.0, 5.0])
@pytest.mark.parametrize("B,S,KV,G,hd,W,causal", SOFTCAP_CASES)
def test_flash_kernel_softcap_matches_plain(cuda, B, S, KV, G, hd, W, causal, cap, dtype):
    """The capped instantiation of both kernels (tanhf on each scaled score
    before the mask) against the plain version: output and lse, one launch,
    a bitwise repeat. ``sm_scale`` 3 spreads the scores to about +-20, so a
    cap of 5 saturates and one of 50 (gemma-2's) bends the largest."""
    q, k, v = _flash_inputs(B, S, KV, G, hd, cuda, dtype)
    kw = dict(causal=causal, window=W, sm_scale=3.0, softcap=cap)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out, lse = ops.flash_attention_fwd(q, k, v, return_lse=True, **kw)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, return_lse=True, **kw)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype, lse=True)
    assert torch.equal(out, ops.flash_attention_fwd(q, k, v, **kw))
    if cap == 5.0:  # saturated: far from the capless result
        capless = ref.flash_attention_fwd_ref(q, k, v, causal=causal, window=W, sm_scale=3.0)
        assert not torch.allclose(out.float(), capless.float(), atol=3e-2)


@pytest.mark.parametrize("cap", [None, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,KV,G,hd,W", WINDOW_SHAPES)
def test_flash_kernel_full_range_equals_the_windowed_launch(cuda, B, S, KV, G, hd, W,
                                                            causal, dtype, cap):
    """``exploit_window=False``: one launch that loads every tile up to the
    diagonal (the tiles below a row's window add ones that the first real
    key's zero correction wipes), output and lse bit for bit the windowed
    launch's, and within tolerance of the plain version."""
    q, k, v = _flash_inputs(B, S, KV, G, hd, cuda, dtype)
    kw = dict(causal=causal, window=W, softcap=cap, return_lse=True)
    before = ops.LAUNCHES["flash_attention_fwd"]
    out, lse = ops.flash_attention_fwd(q, k, v, exploit_window=False, **kw)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 1
    win, win_lse = ops.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(out, win) and torch.equal(lse, win_lse)
    want, want_lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
    _close(out, want, dtype)
    _close(lse, want_lse, dtype, lse=True)


@pytest.mark.parametrize("cap", [None, 50.0])
def test_gemma3_prefill_and_loss_without_the_window_on_the_card(cuda, cap):
    """gemma3 ``reduced()`` in float32 (window 64, an 80-token prompt):
    ``exploit_window=False`` gives the windowed prefill's logits and caches
    and its training loss bit for bit, on the flash kernel (one launch per
    layer a prefill); with a softcap the card's prefill and decode step are
    within 1e-4 of the host's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model
    from repro_torch.models.param import tree_map, tree_materialize

    cfg = dataclasses.replace(get_config("gemma3-27b").reduced(), attn_logit_softcap=cap)
    host = tree_materialize(model.model_spec(cfg), torch.Generator().manual_seed(2), "cpu")
    params = tree_map(lambda t: t.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 81))).to(cuda)
    batch = {"tokens": toks[:, :80]}
    before = ops.LAUNCHES["flash_attention_fwd"]
    lw, cw, _ = model.prefill(params, batch, cfg, max_seq=84)
    lf, cf, _ = model.prefill(params, batch, cfg, max_seq=84, exploit_window=False)
    assert ops.LAUNCHES["flash_attention_fwd"] == before + 2 * cfg.num_layers
    assert torch.equal(lw, lf)
    for stage_w, stage_f in zip(cw, cf):
        for key in stage_w:
            assert all(torch.equal(a, b) for a, b in zip(stage_w[key], stage_f[key]))
    lbatch = {"tokens": toks[:, :80], "labels": toks[:, 1:]}
    assert torch.equal(model.train_loss(params, lbatch, cfg, remat=False),
                       model.train_loss(params, lbatch, cfg, remat=False,
                                        exploit_window=False))
    lh, ch, plen = model.prefill(host, {"tokens": toks[:, :80].cpu()}, cfg, max_seq=84)
    torch.testing.assert_close(lw.cpu(), lh, rtol=1e-4, atol=1e-4)
    dw, _ = model.decode_step(params, toks[:, 80], cw, plen + 1, cfg)
    dh, _ = model.decode_step(host, toks[:, 80].cpu(), ch, plen + 1, cfg)
    torch.testing.assert_close(dw.cpu(), dh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["gemma3-27b", "pixtral-12b"])
def test_generate_on_the_card_matches_the_host(cuda, arch):
    """``reduced()`` in float32: gemma3's windowed layers (window 64, a
    90-token prompt, so decode runs on wrapped rings) and pixtral's patch
    prefix; greedy tokens equal, one flash launch per attention layer a
    prefill on the card, none on the host."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.launch import serve
    from repro_torch.models import model
    from repro_torch.models.param import tree_map, tree_materialize

    cfg = get_config(arch).reduced()
    host = tree_materialize(model.model_spec(cfg), torch.Generator().manual_seed(1), "cpu")
    prompts = make_token_dataset(2 * 90, cfg.vocab_size, 3).reshape(2, 90)
    patches = None
    if cfg.frontend == "vision_stub":
        patches = np.random.default_rng(3).standard_normal(
            (2, cfg.num_patch_tokens, cfg.d_model)).astype(np.float32)
    want = serve.generate(host, prompts, cfg, 6, patch_embeds=patches, device="cpu")
    got = serve.generate(tree_map(lambda t: t.to(cuda), host), prompts, cfg, 6,
                         patch_embeds=patches, device=cuda)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.prefill_flash_launches == cfg.num_layers and got.decode_flash_launches == 0
    assert want.prefill_flash_launches == 0 and got.logits_finite


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


def test_graphed_gradients_match_the_eager_step(cuda, monkeypatch):
    """``GradGraphs``: a tiny HuBERT encoder takes three exchange steps with
    each group's loss and gradient replayed from one captured CUDA graph (the
    step's choice for that frontend on the card), and three eager ones. The replays run the same kernels, so losses and
    parameters agree to bf16 rounding (rtol 1e-4 on the loss; atol 5e-3 on
    parameters of order 0.1 after three AdamW steps of 1e-3, where a
    coordinate picked by one exchange and not the other moves by a step);
    after capture a step launches only the monitored forward's flash kernels
    from Python, 1 a layer, where the eager step launches 1 + 2 x 4 a layer."""
    from repro_torch.core import exchange as tex
    from repro_torch.launch import steps
    from repro_torch.models import model
    from repro_torch.models.config import ConvAudioConfig
    from repro_torch.models.param import tree_flatten, tree_map, tree_materialize
    from repro_torch.optim import optimizers

    cfg = ConvAudioConfig(arch_id="hubert-tiny", family="audio", num_layers=4, d_model=64,
                          num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=32,
                          conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4, final_dim=48,
                          param_dtype="bfloat16", compute_dtype="bfloat16")
    base = tree_materialize(model.model_spec(cfg), torch.Generator(cuda).manual_seed(0), cuda)
    g = torch.Generator(cuda).manual_seed(1)
    S, n = 40, 400 + 320 * 39
    batches = [{"waveform": torch.randn(8, n, generator=g, device=cuda),
                "mask": torch.rand(8, S, generator=g, device=cuda) < 0.5,
                "labels": torch.randint(0, 32, (8, S), generator=g, device=cuda)}
               for _ in range(3)]
    exch = tex.ExchangeConfig(num_groups=4, group_size=2, rho=1 / 64, min_leaf_size=64)
    runs = []
    setup = steps.TrainSetup(cfg=cfg, optimizer=optimizers.OptimizerConfig(warmup_steps=1),
                             exchange=exch)

    class Eager:  # in GradGraphs' place the step keeps its plain loss function
        def __new__(cls, loss_fn):
            return loss_fn

    for graphed in (False, True):
        if graphed:
            monkeypatch.undo()
        else:
            monkeypatch.setattr(steps, "GradGraphs", Eager)
        params = tree_map(torch.clone, base)
        opt, ex = optimizers.init_state(setup.optimizer, params), tex.init_state(exch, params)
        step = steps.build_train_step(setup, cuda)
        losses = []
        for b in batches:
            before = ops.LAUNCHES["flash_attention_fwd"]
            params, opt, ex, m = step(params, opt, ex, b)
            losses.append(float(m["loss"]))
        runs.append((losses, tree_flatten(params)[0], ops.LAUNCHES["flash_attention_fwd"] - before))
    (l_e, p_e, n_e), (l_g, p_g, n_g) = runs
    assert n_e == (1 + 2 * 4) * 4 and n_g == 4
    np.testing.assert_allclose(l_g, l_e, rtol=1e-4)
    for a, b in zip(p_g, p_e):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=5e-3)


def test_unbound_stacks_take_no_more_backward_memory_than_indexed_periods(cuda, monkeypatch):
    """``models/blocks.py`` ``split_periods``: a narrow 48-period HuBERT-shaped
    encoder (hd 80, bf16, remat) takes its gradient with every stacked leaf
    unbound once, and again with each period indexed from the stacks; the
    first holds a leaf's period gradients until one stack, the second a
    whole-stack sum from the first period's backward on, so its peak is at
    or above the first's. The gradients are equal."""
    from repro_torch.launch import steps
    from repro_torch.models import blocks, model
    from repro_torch.models.config import ConvAudioConfig
    from repro_torch.models.param import tree_leaves_with_path, tree_map, tree_materialize

    cfg = ConvAudioConfig(arch_id="hubert-narrow", family="audio", num_layers=48, d_model=320,
                          num_heads=4, num_kv_heads=4, head_dim=80, d_ff=1280, vocab_size=32,
                          conv_dim=(64,) * 7, num_conv_pos_embeddings=16,
                          num_conv_pos_embedding_groups=4, final_dim=64,
                          param_dtype="bfloat16", compute_dtype="bfloat16")
    params = tree_materialize(model.model_spec(cfg), torch.Generator(cuda).manual_seed(0), cuda)
    g = torch.Generator(cuda).manual_seed(1)
    S = 100
    batch = {"waveform": torch.randn(2, 400 + 320 * (S - 1), generator=g, device=cuda),
             "mask": torch.rand(2, S, generator=g, device=cuda) < 0.5,
             "labels": torch.randint(0, 32, (2, S), generator=g, device=cuda)}

    def loss_fn(p, b):
        return model.train_loss(p, b, cfg, remat=True)

    def select_periods(stage):
        _, leaf = next(tree_leaves_with_path(stage))
        return [tree_map(lambda a: a[p], stage) for p in range(leaf.shape[0])]

    peaks, grads = {}, {}
    for split in ("unbind", "select", "unbind"):
        if split == "select":
            monkeypatch.setattr(blocks, "split_periods", select_periods)
        else:
            monkeypatch.undo()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(cuda)
        _, tree = steps.value_and_grad(loss_fn, params, batch)
        torch.cuda.synchronize()
        peaks[split] = torch.cuda.max_memory_allocated(cuda)
        grads[split] = {path: t.cpu() for path, t in tree_leaves_with_path(tree)}
        del tree
    assert peaks["unbind"] <= peaks["select"], peaks
    for path, want in grads["select"].items():
        assert torch.equal(grads["unbind"][path], want), path


# -- the held-experts MoE layer (Qwen3-30B-A3B's share: 32 of 128, top-8) -----------

def _held_layer(cuda, tokens=8192, seed=0):
    from repro_torch.models import moe
    from repro_torch.models.config import HeldExpertsConfig
    from repro_torch.models.param import tree_materialize

    cfg = HeldExpertsConfig(num_layers=1, num_experts=32, first_expert=32)
    g = torch.Generator(device=cuda).manual_seed(seed)
    params = tree_materialize(moe.moe_spec(cfg), g, cuda)
    params = {k: v * (2048**-0.5 / v.float().std()) if k == "router" else v
              for k, v in params.items()}
    x = torch.randn(1, tokens, 2048, generator=g, device=cuda).to(torch.bfloat16)
    return cfg, params, x


def test_held_experts_layer_makes_no_host_sync(cuda):
    """Forward and backward at the cell's widths under sync debug "error"."""
    from repro_torch.models import moe

    cfg, params, x = _held_layer(cuda)
    live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xl = x.detach().requires_grad_(True)
    moe.moe_held(live, xl, cfg)  # the kernels' first launches outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, stats = moe.moe_held(live, xl, cfg)
        loss = out.float().square().mean() + stats[1].sum()
        grads = torch.autograd.grad(loss, [xl, *live.values()])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


def test_held_experts_q_scale_equals_the_decoders_copy(cuda):
    """The held config's scale, a Python float rounded to bfloat16 on the
    host, scales q on the card bit for bit as the 0-dim bfloat16 copy does."""
    q = torch.randn(2, 4096, 4, 8, 128, device=cuda).to(torch.bfloat16)
    scale = 128**-0.5
    want = q * torch.tensor(scale, dtype=torch.bfloat16, device=cuda)
    assert torch.equal(q * float(torch.tensor(scale, dtype=torch.bfloat16)), want)


def test_held_experts_grouped_products_match_a_per_expert_loop(cuda):
    """The grouped GEMMs against cuBLAS products expert by expert (sizes read
    to the host), forward and the weights' and input's gradients, at the
    cell's widths. Both round each product to bfloat16 and sum in float32 in
    other orders and tiles: within 2 % of each tensor's largest magnitude."""
    import torch.nn.functional as F

    from repro_torch.models import moe

    cfg, params, x = _held_layer(cuda, seed=1)
    xf = x[0]
    K, E = cfg.experts_per_token, cfg.num_experts
    top_e = torch.topk(moe.router_logits(params, xf), K, dim=-1).indices
    local = top_e - cfg.first_expert
    key = torch.where((local >= 0) & (local < E), local, E).reshape(-1)
    counts = torch.zeros(E + 1, dtype=torch.int64, device=cuda).scatter_add_(
        0, key, torch.ones_like(key))
    leaves = [xf, params["gate"], params["up"], params["down"]]
    live = [t.detach().requires_grad_(True) for t in leaves]
    order, ends, valid, rows = moe.sort_pairs(live[0], key, counts, K)
    got = moe.unsort(moe.grouped_swiglu({"gate": live[1], "up": live[2], "down": live[3]},
                                        rows, ends, valid), order)
    ref_live = [t.detach().requires_grad_(True) for t in leaves]
    want = torch.zeros_like(got)
    for e in range(E):
        pairs = torch.nonzero(key == e)[:, 0]
        h = ref_live[0][pairs // K]
        y = (F.silu(h @ ref_live[1][e]) * (h @ ref_live[2][e])) @ ref_live[3][e]
        want = want.index_copy(0, pairs, y)
    assert int(counts[:E].sum()) > 10_000  # the cell's load: ~2 of 8 choices held
    assert float((got.float() - want.float()).abs().max()) <= 2e-2 * float(want.abs().max())
    seed = torch.randn_like(got.float())
    g_got = torch.autograd.grad((got.float() * seed).sum(), live)
    g_want = torch.autograd.grad((want.float() * seed).sum(), ref_live)
    for a, b in zip(g_got, g_want):
        assert float((a.float() - b.float()).abs().max()) <= 2e-2 * float(b.abs().max())


def test_one_train_step_of_the_cut_qwen3_moe(cuda):
    """``build_train_step`` on the benchmark's cut (8 layers, 32 of 128
    experts, the vocabulary's quarter) with the ACPD exchange, at a batch of
    4 x 1,024: finite losses, and after the second step (the warm-up's first
    rate above 0) every leaf moved."""
    import json
    import pathlib
    import sys

    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from perfbench.drivers.moe_steps import train_setup
    from perfbench.drivers.train_steps import flat
    from perfbench.inputs import moe_weights
    from perfbench.inputs.tokens import TokenStream
    from repro_torch.core import exchange as exch_lib
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import optimizers

    config = json.loads((root / "perfbench/configs/qwen3-moe-30b-a3b.json").read_text())
    traffic = json.loads((root / "perfbench/traffic/qwen3-moe-acpd-exchange.json").read_text())
    setup = train_setup(config, traffic)
    step = build_train_step(setup, cuda)
    params = moe_weights.make(config, 5, cuda)
    before = {p: t.clone() for p, t in flat(params).items()}
    opt = optimizers.init_state(setup.optimizer, params)
    exch = exch_lib.init_state(setup.exchange, params)
    stream = TokenStream(moe_weights.held(config)[2], 4, 1024, 1.1, 6, cuda)
    for _ in range(2):
        params, opt, exch, metrics = step(params, opt, exch, stream.next_batch())
        assert math.isfinite(float(metrics["loss"]))
    still = [p for p, t in flat(params).items() if torch.equal(t, before[p])]
    assert not still, still
