"""Port vs JAX package: the grouped delta exchange (``core/exchange.py``).

The JAX package's own properties (``tests/test_exchange.py``) on the port,
and both packages' ``exchange`` and ``exchange_sequential`` on the same
seeded numpy gradients over several steps (sparse steps, a dense sync, a
leaf below ``min_leaf_size``). The kept sets come from the histogram
threshold, whose value may differ in its last bit between the libraries
(``tests/test_torch_compress.py``), so the filter's masks are compared
EQUAL and the float32 updates and residuals within rtol 1e-6 (sums over
groups in another order) and atol 1e-6: a residual ``dw - sent`` of
``topk_q8`` cancels two values of magnitude up to ~4 whose last bits may
differ (XLA fuses the dequantization inside the scan), so its absolute error
is a few float32 ulps of 4 (4.8e-7 each); the exchange's counters (sent fraction, bytes,
participation, dense step) are integers in float32 and compared equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcp
from repro.core import exchange as jex
from repro_torch.core import compress as tcp
from repro_torch.core import exchange as tex

SHAPES = {"a": (40, 64), "b": {"c": (3000,), "d": (16,)}}
COUNTERS = ("exchange/sent_fraction", "exchange/bytes_step", "exchange/participating",
            "exchange/dense_step")


def _tree(fn, shapes=SHAPES):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in shapes.items()}


def _leaves(tree):
    return [tree[k] for k in sorted(tree) if not isinstance(tree[k], dict)] + [
        x for k in sorted(tree) if isinstance(tree[k], dict) for x in _leaves(tree[k])]


def _grads(seed, G, steps):
    rng = np.random.default_rng(seed)
    return [_tree(lambda s: rng.standard_normal((G, *s)).astype(np.float32))
            for _ in range(steps)]


def _np(tree):
    return _tree_map(lambda x: np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                                          else x), tree)


def _tree_map(fn, tree):
    return {k: _tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _assert_close(got, want, rtol=1e-6, atol=1e-6):
    for g, w in zip(_leaves(_np(got)), _leaves(_np(want))):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def _cfg(**kw):
    base = dict(num_groups=4, group_size=2, sync_period=3, rho=0.02, gamma=0.9)
    base.update(kw)
    return base


# ---------------------------------------------------------------------------
# The JAX package's properties, on the port.
# ---------------------------------------------------------------------------


def test_dense_config_equals_mean_gradient():
    G = 4
    cfg = tex.dense_config(G)
    grads = _tree_map(torch.from_numpy, _grads(0, G, 1)[0])
    params = _tree_map(lambda g: torch.zeros(g.shape[1:]), grads)
    update, new_state, metrics = tex.exchange(cfg, grads, tex.init_state(cfg, params),
                                              torch.tensor(0))
    for u, g in zip(_leaves(update), _leaves(grads)):
        torch.testing.assert_close(u, g.mean(0), rtol=1e-6, atol=1e-7)
    assert all(float(r.abs().max()) == 0.0 for r in _leaves(new_state.residual))
    assert float(metrics["exchange/sent_fraction"]) == 1.0


def test_error_feedback_conservation():
    G, B = 8, 3
    cfg = tex.ExchangeConfig(num_groups=G, group_size=B, sync_period=1000, rho=0.1,
                             gamma=0.7, min_leaf_size=8)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((G, 4096))
                         .astype(np.float32))
    state = tex.ExchangeState(residual={"p0": torch.full((G, 4096), 0.1)})
    step = torch.tensor(3)
    update, new_state, _ = tex.exchange(cfg, {"p0": g}, state, step)
    p = tex.participation(cfg, step).numpy()
    dw = 0.1 + g.numpy()
    res_new = new_state.residual["p0"].numpy()
    recon = update["p0"].numpy() * p.sum() / cfg.gamma + (res_new * p[:, None]).sum(0)
    np.testing.assert_allclose(recon, (dw * p[:, None]).sum(0), rtol=1e-4, atol=1e-5)
    for k in range(G):
        if p[k] == 0:
            np.testing.assert_array_equal(res_new[k], dw[k])


def test_participation_covers_all_groups_and_matches_jax():
    cfg = dict(num_groups=8, group_size=3, sync_period=100)
    seen = np.zeros(8, bool)
    for t in range(8):
        got = tex.participation(tex.ExchangeConfig(**cfg), torch.tensor(t)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jex.participation(jex.ExchangeConfig(**cfg), jnp.int32(t))))
        assert got.sum() == 3
        seen |= got > 0
    assert seen.all()


def test_dense_sync_every_T():
    cfg = tex.ExchangeConfig(num_groups=4, group_size=1, sync_period=5, rho=0.01)
    g = {"p0": torch.randn(4, 512, generator=torch.Generator().manual_seed(2))}
    state = tex.init_state(cfg, {"p0": torch.zeros(512)})
    _, state, m0 = tex.exchange(cfg, g, state, torch.tensor(0))
    assert float(m0["exchange/dense_step"]) == 0.0
    _, state, m4 = tex.exchange(cfg, g, state, torch.tensor(4))
    assert float(m4["exchange/dense_step"]) == 1.0
    assert float(m4["exchange/participating"]) == 4.0
    assert float(state.residual["p0"].abs().max()) == 0.0


def test_config_checks_like_jax():
    with pytest.raises(ValueError, match="group_size"):
        tex.ExchangeConfig(num_groups=2, group_size=3)
    with pytest.raises(ValueError, match="topk_q8"):
        tex.ExchangeConfig(compressor="zstd")
    assert tex.ExchangeConfig() == tex.ExchangeConfig(
        **{f: getattr(jex.ExchangeConfig(), f) for f in
           ("num_groups", "group_size", "sync_period", "rho", "gamma", "refine",
            "min_leaf_size", "compressor")})


# ---------------------------------------------------------------------------
# Both packages on the same gradients over several steps.
# ---------------------------------------------------------------------------


def _jax_run(cfg, grads, sequential):
    params = _tree(lambda s: jnp.zeros(s))
    state = jex.init_state(cfg, params)

    @jax.jit  # as the train step runs it, and one compile instead of one per op
    def step(gj, state, t):
        if sequential:
            return jex.exchange_sequential(
                cfg, lambda _, b: jax.tree.map(lambda x: x[b["i"]], gj), params,
                {"i": jnp.arange(cfg.num_groups)}, state, t)
        return jex.exchange(cfg, gj, state, t)

    out = []
    for t, g in enumerate(grads):
        update, state, m = step(_tree_map(jnp.asarray, g), state, jnp.int32(t))
        out.append((update, state.residual, {k: float(v) for k, v in m.items()}))
    return out


def _torch_run(cfg, grads, sequential):
    params = _tree(lambda s: torch.zeros(s))
    state = tex.init_state(cfg, params)
    out = []
    for t, g in enumerate(grads):
        gt = _tree_map(torch.from_numpy, g)
        if sequential:
            batch = {"i": torch.arange(cfg.num_groups)}
            update, state, m = tex.exchange_sequential(
                cfg, lambda _, b, gt=gt: _tree_map(lambda x: x[b["i"]], gt), params,
                batch, state, torch.tensor(t))
        else:
            update, state, m = tex.exchange(cfg, gt, state, torch.tensor(t))
        out.append((update, _tree_map(torch.clone, state.residual),
                    {k: float(v) for k, v in m.items()}))
    return out


@pytest.mark.parametrize("sequential", [False, True], ids=["stacked", "sequential"])
@pytest.mark.parametrize("fields", [
    _cfg(), _cfg(group_size=4, sync_period=2, rho=0.1, compressor="topk_q8"),
    dict(num_groups=4, group_size=4, sync_period=1, rho=1.0, gamma=1.0)],
    ids=["acpd", "q8", "dense"])
def test_exchange_matches_jax_over_steps(fields, sequential):
    grads = _grads(3, fields["num_groups"], 5)
    ours = _torch_run(tex.ExchangeConfig(**fields), grads, sequential)
    theirs = _jax_run(jex.ExchangeConfig(**fields), grads, sequential)
    for (u_t, r_t, m_t), (u_j, r_j, m_j) in zip(ours, theirs):
        _assert_close(u_t, u_j)
        _assert_close(r_t, r_j)
        assert set(m_t) == set(m_j)
        for k in COUNTERS:
            assert m_t[k] == m_j[k], k
        if "exchange/residual_norm" in m_j:
            np.testing.assert_allclose(m_t["exchange/residual_norm"],
                                       m_j["exchange/residual_norm"], rtol=1e-6)
    T = fields["sync_period"]
    assert [m["exchange/dense_step"] for _, _, m in ours] == [
        float(t % T == T - 1) for t in range(len(grads))]


def test_filter_masks_equal_jax_on_the_exchange_inputs():
    """The kept sets of one exchange round, leaf by leaf, in both packages."""
    cfg = _cfg()
    grads = _grads(5, 4, 1)[0]
    for g in _leaves(grads):
        if g[0].size < 1024:
            continue
        jm = jcp.for_exchange(jex.ExchangeConfig(**cfg)).compress_grouped(jnp.asarray(g))[1]
        tm = tcp.for_exchange(tex.ExchangeConfig(**cfg)).compress_grouped(
            torch.from_numpy(g))[1]
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("fields", [_cfg(), _cfg(rho=1.0, group_size=4, gamma=1.0)])
def test_sequential_equals_stacked_in_the_port(fields):
    cfg = tex.ExchangeConfig(**fields)
    grads = _grads(7, 4, 4)
    stacked = _torch_run(cfg, grads, sequential=False)
    sequential = _torch_run(cfg, grads, sequential=True)
    for (u_s, r_s, m_s), (u_q, r_q, m_q) in zip(stacked, sequential):
        _assert_close(u_q, u_s)
        _assert_close(r_q, r_s)
        for k in COUNTERS:
            assert m_q[k] == m_s[k], k
