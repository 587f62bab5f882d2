"""Port vs JAX package: the local SDCA solver and its kernel's plain version.

Inputs are made with numpy from a seed and handed to both packages, visit
orders included. Held against ``repro.kernels.ref.sdca_inner_ref`` and
``repro.core.sdca`` for all three losses, not the Pallas kernel (whose interpret mode misses its
own tolerance at one of these shapes). Tolerance rtol 1e-5 / atol 1e-6: the
same float32 steps, with the dot products summed in another order.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import sdca as jsdca
from repro.kernels import ref as jref
from repro_torch.core import sdca as tsdca
from repro_torch.kernels import ops, ref as tref
from repro_torch.kernels.sdca_inner import sdca_inner_cuda

RTOL, ATOL = 1e-5, 1e-6
SHAPES = [(1, 32, 128, 64), (4, 64, 256, 200), (3, 128, 512, 150), (8, 16, 1024, 50)]


def _inputs(K, n_k, d, H, loss="ridge"):
    rng = np.random.default_rng(K * 1000 + n_k)
    X = (rng.standard_normal((K, n_k, d)).astype(np.float32) / np.float32(np.sqrt(d)))
    y = np.sign(rng.standard_normal((K, n_k))).astype(np.float32)
    w = (rng.standard_normal((K, d)) * 0.1).astype(np.float32)
    if loss == "ridge":
        alpha = (rng.standard_normal((K, n_k)) * 0.05).astype(np.float32)
    else:  # dual-feasible: y * alpha in (0, 1)
        alpha = (y * rng.uniform(0.05, 0.6, (K, n_k))).astype(np.float32)
    norms = np.sum(X * X, axis=-1)
    idx = rng.integers(0, n_k, (K, H)).astype(np.int32)
    return dict(w=w, alpha=alpha, X=X, y=y, norms=norms, idx=idx)


def _args(a, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return [conv(a[k]) for k in ("w", "alpha", "X", "y", "norms")]


@pytest.mark.parametrize("K,n_k,d,H", SHAPES)
def test_sdca_inner_ref_matches_jax(K, n_k, d, H):
    a = _inputs(K, n_k, d, H)
    lam, n, sp = 1e-3, K * n_k, 2.0
    da_j, v_j = jref.sdca_inner_ref(*_args(a, "jax"), lam, n, sp, jnp.asarray(a["idx"]))
    da_t, v_t = tref.sdca_inner_ref(*_args(a, "torch"), lam, n, sp,
                                    torch.from_numpy(a["idx"]))
    np.testing.assert_allclose(da_t.numpy(), np.asarray(da_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=RTOL, atol=ATOL)
    # On the CPU the dispatch layer is the plain version, launching nothing.
    before = dict(ops.LAUNCHES)
    da_o, v_o = ops.sdca_epoch(*_args(a, "torch"), lam, n, sp, torch.from_numpy(a["idx"]))
    assert torch.equal(da_o, da_t) and torch.equal(v_o, v_t)
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H", SHAPES[:3])
def test_solve_subproblem_indices_matches_jax(loss, K, n_k, d, H):
    a = _inputs(K, n_k, d, H, loss)
    lam, n, sp = 1e-3, K * n_k, 1.5
    jargs, targs = _args(a, "jax"), _args(a, "torch")
    for k in range(K):
        j = jsdca.solve_subproblem_indices(*(x[k] for x in jargs), lam, n, sp,
                                           jnp.asarray(a["idx"][k]), loss=loss)
        t = tsdca.solve_subproblem_indices(*(x[k] for x in targs), lam, n, sp,
                                           torch.from_numpy(a["idx"][k]), loss=loss)
        np.testing.assert_allclose(t.delta_alpha.numpy(), np.asarray(j.delta_alpha),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), rtol=RTOL, atol=ATOL)
    # The batched form is the same K solves.
    tb = tsdca.solve_subproblem_all_indices(*targs, lam, n, sp,
                                            torch.from_numpy(a["idx"]), loss=loss)
    np.testing.assert_allclose(tb.v[K - 1].numpy(), t.v.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
@pytest.mark.parametrize("K,n_k,d,H", SHAPES)
def test_ops_sdca_epoch_matches_jax_per_worker(loss, K, n_k, d, H):
    # The dispatch layer on the CPU, every loss, against the JAX package's
    # solver run worker by worker along the same visit orders.
    a = _inputs(K, n_k, d, H, loss)
    lam, n, sp = 1e-3, K * n_k, 2.0
    before = dict(ops.LAUNCHES)
    da_t, v_t = ops.sdca_epoch(*_args(a, "torch"), lam, n, sp, torch.from_numpy(a["idx"]),
                               loss=loss)
    assert ops.LAUNCHES == before
    jargs = _args(a, "jax")
    for k in range(K):
        j = jsdca.solve_subproblem_indices(*(x[k] for x in jargs), lam, n, sp,
                                           jnp.asarray(a["idx"][k]), loss=loss)
        np.testing.assert_allclose(da_t[k].numpy(), np.asarray(j.delta_alpha),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(v_t[k].numpy(), np.asarray(j.v), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
def test_solver_sends_every_loss_through_the_dispatch_layer(loss, monkeypatch):
    a = _inputs(2, 32, 128, 40, loss)
    calls = []
    real = ops.sdca_epoch

    def recording(*args, **kwargs):
        calls.append(kwargs.get("loss"))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "sdca_epoch", recording)
    res = tsdca.solve_subproblem_all_indices(*_args(a, "torch"), 1e-3, 64, 1.5,
                                             torch.from_numpy(a["idx"]), loss=loss)
    assert calls == [loss]
    da, v = tsdca.sdca_epoch_plain(loss, *_args(a, "torch"), 1e-3, 64, 1.5,
                                   torch.from_numpy(a["idx"]))
    assert torch.equal(res.delta_alpha, da) and torch.equal(res.v, v)


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
def test_coordinate_delta_matches_jax(loss):
    rng = np.random.default_rng(5)
    y = np.sign(rng.standard_normal(64)).astype(np.float32)
    a = (y * rng.uniform(0.01, 0.99, 64)).astype(np.float32)
    z = rng.standard_normal(64).astype(np.float32)
    q = rng.uniform(0.0, 5.0, 64).astype(np.float32)
    j = jsdca._coordinate_delta(loss, *map(jnp.asarray, (a, z, y, q)))
    t = tsdca._coordinate_delta(loss, *map(torch.from_numpy, (a, z, y, q)))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=ATOL)


def test_sdca_reference_matches_jax_on_jax_draws():
    rng = np.random.default_rng(2)
    n, d, lam = 48, 64, 1e-2
    X = (rng.standard_normal((n, d)) / 8).astype(np.float32)
    y = np.sign(rng.standard_normal(n)).astype(np.float32)
    key = jax.random.key(3)
    alpha_j, w_j = jsdca.sdca_reference(jnp.asarray(X), jnp.asarray(y), lam, key,
                                        loss="ridge", num_epochs=2)
    idx = np.array(jax.random.randint(key, (2 * n,), 0, n, dtype=jnp.int32))
    alpha_t, w_t = tsdca.sdca_reference_indices(torch.from_numpy(X), torch.from_numpy(y),
                                                lam, torch.from_numpy(idx), loss="ridge")
    np.testing.assert_allclose(alpha_t.numpy(), np.asarray(alpha_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=RTOL, atol=ATOL)


def test_generator_draws_are_seeded_and_in_range():
    a = _inputs(2, 32, 64, 1)
    args = [x[0] for x in _args(a, "torch")]
    runs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(9)
        runs.append(tsdca.solve_subproblem(*args, 1e-3, 64, 1.0, g, loss="ridge",
                                           num_steps=40))
    assert torch.equal(runs[0].v, runs[1].v)
    g = torch.Generator().manual_seed(9)
    idx = tsdca.draw_visit_order(32, 500, g, batch=(3,))
    assert idx.dtype == torch.int32 and idx.shape == (3, 500)
    assert int(idx.min()) >= 0 and int(idx.max()) < 32
    g = torch.Generator().manual_seed(1)
    alpha, w = tsdca.sdca_reference(torch.from_numpy(a["X"][0]), torch.from_numpy(a["y"][0]),
                                    1e-2, g, loss="ridge", num_epochs=1)
    assert alpha.shape == (32,) and w.shape == (64,) and torch.isfinite(w).all()


def test_kernel_launcher_refuses_host_tensors():
    a = _inputs(1, 32, 128, 8)
    with pytest.raises(ValueError, match="must lie on"):
        sdca_inner_cuda(*_args(a, "torch"), 1e-3, 32, 1.0, torch.from_numpy(a["idx"]))


@pytest.mark.parametrize("loss", ["ridge", "smoothed_hinge", "logistic"])
def test_plain_loop_skips_steps_outside_the_rows(loss):
    # Indices -1 and n_k (and beyond) in each worker's order, at different
    # positions per worker: the plain loop skips them for that worker, as
    # the CUDA kernel does, and equals each worker's loop along its order
    # with those steps removed; the JAX solver along the same filtered order
    # agrees to the file's tolerance.
    K, n_k, d, H = 3, 32, 128, 60
    a = _inputs(K, n_k, d, H, loss)
    idx = a["idx"].copy()
    idx[0, 3::7] = -1
    idx[1, 5::11] = n_k
    idx[2, ::2] = n_k + 4
    idx[2, 1] = -n_k  # would wrap to row 0 if indexed directly
    lam, n, sp = 1e-3, K * n_k, 2.0
    args = _args(a, "torch")
    da, v = tsdca.sdca_epoch_plain(loss, *args, lam, n, sp, torch.from_numpy(idx))
    jargs = _args(a, "jax")
    for k in range(K):
        inside = idx[k][(idx[k] >= 0) & (idx[k] < n_k)]
        assert 0 < inside.size < H
        one = tsdca.sdca_epoch_plain(loss, *(x[k:k + 1] for x in args), lam, n, sp,
                                     torch.from_numpy(inside[None]))
        assert torch.equal(da[k], one.delta_alpha[0]) and torch.equal(v[k], one.v[0])
        j = jsdca.solve_subproblem_indices(*(x[k] for x in jargs), lam, n, sp,
                                           jnp.asarray(inside), loss=loss)
        np.testing.assert_allclose(v[k].numpy(), np.asarray(j.v), rtol=RTOL, atol=ATOL)
    # An order with no step inside changes nothing.
    none = torch.full((K, 5), -1, dtype=torch.int32)
    da0, v0 = tsdca.sdca_epoch_plain(loss, *args, lam, n, sp, none)
    assert not da0.any() and not v0.any()


@pytest.mark.parametrize("loss", ["ridge", "logistic"])
@pytest.mark.parametrize("workers", [[2], [3, 0, 1], [0, 1, 2, 3], [1, 3, 0, 2]])
def test_worker_map_equals_the_gathered_copy(loss, workers):
    # Batch row b is worker workers[b]: the plain version gathers on the
    # CPU, bit for bit the unmapped loop on X[workers], alpha[workers], ...
    K, n_k, d, H = 4, 32, 128, 50
    a = _inputs(K, n_k, d, H, loss)
    w, alpha, X, y, norms = _args(a, "torch")
    B = len(workers)
    idx = torch.from_numpy(a["idx"][:B])
    w_b = w[:B].clone()
    lam, n, sp = 1e-3, K * n_k, 1.5
    before = dict(ops.LAUNCHES)
    da_m, v_m = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss,
                               workers=workers)
    assert ops.LAUNCHES == before
    g = torch.tensor(workers)
    da_g, v_g = tref.sdca_inner_ref(w_b, alpha[g].contiguous(), X[g].contiguous(),
                                    y[g].contiguous(), norms[g].contiguous(), lam, n, sp,
                                    idx, loss=loss)
    assert da_m.shape == (B, n_k) and v_m.shape == (B, d)
    assert torch.equal(da_m, da_g) and torch.equal(v_m, v_g)
    if workers == list(range(K)):  # the identity map is no map
        da_u, v_u = ops.sdca_epoch(w_b, alpha, X, y, norms, lam, n, sp, idx, loss=loss)
        assert torch.equal(da_m, da_u) and torch.equal(v_m, v_u)


def test_kernel_launcher_checks_the_worker_map_on_the_host():
    a = _inputs(2, 32, 128, 8)
    for bad in ([0, 2], [-1], []):
        with pytest.raises(ValueError, match="workers"):
            sdca_inner_cuda(*_args(a, "torch"), 1e-3, 64, 1.0, torch.from_numpy(a["idx"]),
                            workers=bad)
