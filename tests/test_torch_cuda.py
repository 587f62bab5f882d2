"""The port's kernels on the card, against their plain versions.

Every test here needs a CUDA device (marker ``cuda``) and skips without one.
The file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: the SDCA kernel sums its dot products in another order than the
plain version, and the H dependent steps compound that, so rtol 1e-4 /
atol 1e-5; the top-k kernel makes the plain version's integer decisions on
the same edges, so its outputs are equal exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch.api import problems
from repro_torch.core import acpd, baselines, sdca
from repro_torch.core.simulate import ClusterModel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sdca_inner, topk_filter

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sdca_inputs(K, n_k, d, H, device):
    rng = np.random.default_rng(K * 1000 + n_k)
    X = rng.standard_normal((K, n_k, d)).astype(np.float32) / np.float32(np.sqrt(d))
    y = np.sign(rng.standard_normal((K, n_k))).astype(np.float32)
    w = (rng.standard_normal((K, d)) * 0.1).astype(np.float32)
    alpha = (rng.standard_normal((K, n_k)) * 0.05).astype(np.float32)
    idx = rng.integers(0, n_k, (K, H)).astype(np.int32)
    t = [torch.from_numpy(a).to(device) for a in (w, alpha, X, y)]
    norms = (t[2] * t[2]).sum(-1)
    return [*t, norms], torch.from_numpy(idx).to(device)


@pytest.mark.parametrize("K,n_k,d,H", [(1, 32, 128, 64), (4, 64, 256, 200),
                                       (3, 128, 512, 150), (8, 16, 1024, 50),
                                       (2, 64, 47_236, 100)])
def test_sdca_kernel_matches_plain_and_repeats_bitwise(cuda, K, n_k, d, H):
    args, idx = _sdca_inputs(K, n_k, d, H, cuda)
    lam, n, sp = 1e-3, K * n_k, 2.0
    before = ops.LAUNCHES["sdca_inner"]
    da_k, v_k = ops.sdca_epoch(*args, lam, n, sp, idx)
    assert ops.LAUNCHES["sdca_inner"] == before + 1
    da_r, v_r = ref.sdca_inner_ref(*args, lam, n, sp, idx)
    torch.testing.assert_close(da_k, da_r, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(v_k, v_r, rtol=1e-4, atol=1e-5)
    da_2, v_2 = ops.sdca_epoch(*args, lam, n, sp, idx)
    assert torch.equal(da_k, da_2) and torch.equal(v_k, v_2)  # no atomics


def test_sdca_kernel_refuses_what_it_does_not_take(cuda):
    args, idx = _sdca_inputs(1, 8, 64, 4, cuda)
    big = sdca_inner.max_d() + 1
    wide, _ = _sdca_inputs(1, 2, big, 4, cuda)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        ops.sdca_epoch(*wide, 1e-3, 2, 1.0, idx[:, :4].clamp(max=1))
    with pytest.raises(ValueError, match="int32"):
        ops.sdca_epoch(*args, 1e-3, 8, 1.0, idx.long())
    x, y = args[2][0], args[3][0]
    for loss in ("smoothed_hinge", "logistic"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            sdca.solve_subproblem_indices(args[0][0], args[1][0], x, y, args[4][0],
                                          1e-3, 8, 1.0, idx[0], loss=loss)


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
