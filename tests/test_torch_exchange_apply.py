"""The exchange's split around the threshold, on the CPU.

``ops.exchange_apply_add`` and ``ops.exchange_apply_split`` take their
plain versions (``kernels/exchange_apply.py``) on the CPU: here they are held
bit for bit to the PyTorch sequence that ``exchange_sequential`` ran inline
before the split had a kernel, copied below as the reference
(``_leaf_before``, ``_exchange_sequential_before``), over both gradient
types, an unaligned length, a leaf under ``min_leaf_size``, a stacked leaf's
slice of its residual, resting and participating groups, the dense step and
planted infinities and NaNs. Bits are compared through int32 views, so NaNs
compare too. The card's kernels against the plain versions are in
``tests/test_torch_cuda.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import compress, exchange
from repro_torch.kernels import ops
from repro_torch.kernels.exchange_apply import (exchange_apply_add_cuda,
                                                exchange_apply_split_cuda)

_DENSE = compress.Dense()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().contiguous().view(torch.int32)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


def _leaf_before(cfg, comp, res, g, grad, acc_i, pg, dense_step, sent_count, byte_count):
    """One leaf of one group as ``exchange_sequential`` computed it inline."""
    dw = res[g] + grad.to(torch.float32)
    if cfg.rho >= 1.0 or dw.numel() < cfg.min_leaf_size:
        sent, mask, always_dense = dw, None, True
    else:
        sent, mask = comp.compress_grouped(dw[None])
        sent = torch.where(dense_step, dw, sent[0])
        mask = torch.where(dense_step, True, mask[0])
        always_dense = False
    acc_i += pg * sent
    res[g] = torch.where(pg > 0, dw - sent, dw)
    if always_dense:
        kept, nbytes = dw.numel(), float(_DENSE.payload_bytes(dw.numel()))
    else:
        kept = torch.sum(mask)
        nbytes = torch.where(dense_step, _DENSE.payload_bytes(kept),
                             comp.payload_bytes(kept)).to(torch.float32)
    return sent_count + pg * kept, byte_count + pg * nbytes


def _leaf_after(cfg, comp, res, g, grad, acc_i, pg, dense_step, sent_count, byte_count):
    """The same leaf through the two ``ops`` calls, as ``exchange_sequential`` makes them."""
    dw = res[g]
    ops.exchange_apply_add(dw, grad)
    thresh = None
    if dw.numel() >= cfg.min_leaf_size:
        thresh = compress.threshold_for_topk(dw, compress.kept_target(comp.rho, dw.numel()),
                                             comp.refine)
    ops.exchange_apply_split(dw, acc_i, pg, dense_step, thresh, sent_count, byte_count,
                             dense_bytes=(4, 0), sparse_bytes=(8, 0))
    return sent_count, byte_count


# (residual shape (G, *leaf), group): an odd length whose slice at g = 1 is
# not 16-byte aligned, a leaf sent densely, a stacked (48, ...) leaf.
LEAVES = {"unaligned": ((3, 4099), 1), "small": ((2, 600), 1), "stacked": ((3, 48, 8, 16), 2)}
MODES = {"sparse_p0": (0.0, False), "sparse_p1": (1.0, False), "dense_p1": (1.0, True),
         "dense_p0": (0.0, True)}


def _plant(x: torch.Tensor, seed: int) -> torch.Tensor:
    """+inf, -inf and NaN at a few places, some of them large enough to be kept."""
    flat = x.reshape(-1)
    rng = np.random.default_rng(seed)
    at = rng.choice(flat.numel(), 6, replace=False)
    for j, v in zip(at, (math.inf, -math.inf, math.nan, math.inf, math.nan, -math.inf)):
        flat[int(j)] = v
    return x


def _leaf_inputs(leaf, grad_dtype, nonfinite, seed=0):
    shape, g = LEAVES[leaf]
    gen = torch.Generator().manual_seed(seed)
    res = torch.randn(shape, generator=gen) * 0.1
    grad = torch.randn(shape[1:], generator=gen).to(grad_dtype)
    acc = torch.randn(shape[1:], generator=gen)
    if nonfinite:
        _plant(res[g], seed + 1)
        grad = _plant(grad.clone(), seed + 2)
    counts = (torch.tensor(3.0), torch.tensor(40.0))
    return res, g, grad, acc, counts


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("leaf", list(LEAVES))
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_split_equals_the_former_inline_sequence(grad_dtype, leaf, mode, nonfinite):
    cfg = exchange.ExchangeConfig(num_groups=3, group_size=1, sync_period=5, rho=1 / 64)
    comp = compress.for_exchange(cfg)
    pg_v, dense_v = MODES[mode]
    pg, dense_step = torch.tensor(pg_v), torch.tensor(dense_v)
    res, g, grad, acc, (sc, bc) = _leaf_inputs(leaf, grad_dtype, nonfinite)
    res_b, acc_b = res.clone(), acc.clone()
    sc_b, bc_b = _leaf_before(cfg, comp, res_b, g, grad, acc_b, pg, dense_step, sc, bc)
    res_a, acc_a, sc_a, bc_a = res.clone(), acc.clone(), sc.clone(), bc.clone()
    with ops.recording_launches() as counts:
        _leaf_after(cfg, comp, res_a, g, grad, acc_a, pg, dense_step, sc_a, bc_a)
    assert counts["exchange_apply"] == 2
    assert counts["exchange_threshold"] == int(leaf != "small")
    for got, want in ((res_a, res_b), (acc_a, acc_b), (sc_a, sc_b), (bc_a, bc_b)):
        assert _same(got, want)
    if nonfinite:
        assert not torch.isfinite(res_b).all()  # the planted values took part


def _exchange_sequential_before(cfg, grad_fn, params, grouped_batch, state, step):
    """``exchange_sequential`` as it was before the fused split, for reference."""
    from repro_torch.models.param import tree_flatten

    G = cfg.num_groups
    comp = compress.for_exchange(cfg)
    dense_step, p, denom = exchange._round_masks(cfg, step)
    res_leaves, unflatten = tree_flatten(state.residual)
    acc = [torch.zeros(r.shape[1:], dtype=torch.float32) for r in res_leaves]
    sent_total = torch.zeros((), dtype=torch.float32)
    bytes_total = torch.zeros((), dtype=torch.float32)
    for g in range(G):
        batch_g = {k: v[g] for k, v in grouped_batch.items()}
        grads, _ = tree_flatten(grad_fn(params, batch_g))
        sent_count = torch.zeros((), dtype=torch.float32)
        byte_count = torch.zeros((), dtype=torch.float32)
        for i, res in enumerate(res_leaves):
            sent_count, byte_count = _leaf_before(cfg, comp, res, g, grads[i], acc[i], p[g],
                                                  dense_step, sent_count, byte_count)
        sent_total = sent_total + sent_count
        bytes_total = bytes_total + byte_count
    update = unflatten([cfg.gamma * a / denom for a in acc])
    total = float(sum(r.numel() for r in res_leaves))
    metrics = {
        "exchange/sent_fraction": sent_total / max(total, 1.0),
        "exchange/bytes_step": bytes_total,
        "exchange/participating": torch.sum(p),
        "exchange/dense_step": dense_step.to(torch.float32),
    }
    return update, state, metrics


SHAPES = {"a": (40, 64), "b": (4099,), "c": (16,), "d": (6, 8, 32)}


def _run(fn, cfg, grads_by_step, dtypes):
    from repro_torch.models.param import tree_flatten

    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    state = exchange.init_state(cfg, params)
    out = []
    for t, grads in enumerate(grads_by_step):
        grads = {k: v.to(dtypes[k]) for k, v in grads.items()}
        update, state, m = fn(cfg, lambda _, b, gr=grads: {k: v[b["i"]] for k, v in gr.items()},
                              params, {"i": torch.arange(cfg.num_groups)}, state,
                              torch.tensor(t))
        out.append((tree_flatten(update)[0], [r.clone() for r in tree_flatten(state.residual)[0]],
                    {k: v.clone() for k, v in m.items()}))
    return out


@pytest.mark.parametrize("nonfinite", [False, True], ids=["finite", "nonfinite"])
@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_exchange_sequential_equals_the_former_sequence_over_11_steps(grad_dtype, nonfinite):
    """11 steps, two of them dense syncs, with a stacked, an unaligned and a
    dense leaf: updates, residuals and every counter bit for bit; the split
    runs twice a leaf and group."""
    cfg = exchange.ExchangeConfig(num_groups=4, group_size=2, sync_period=5, rho=1 / 64)
    rng = np.random.default_rng(11)
    steps = [{k: torch.from_numpy(rng.standard_normal((4, *s)).astype(np.float32))
              for k, s in SHAPES.items()} for _ in range(11)]
    if nonfinite:
        _plant(steps[2]["a"][1], 5)
        _plant(steps[6]["d"][3], 6)
    dtypes = dict.fromkeys(SHAPES, grad_dtype) | {"c": torch.float32}
    want = _run(_exchange_sequential_before, cfg, steps, dtypes)
    with ops.recording_launches() as counts:
        got = _run(exchange.exchange_sequential, cfg, steps, dtypes)
    assert counts["exchange_apply"] == 2 * len(SHAPES) * cfg.num_groups * len(steps)
    assert counts["exchange_threshold"] == 3 * cfg.num_groups * len(steps)
    for (u_g, r_g, m_g), (u_w, r_w, m_w) in zip(got, want):
        assert all(_same(a, b) for a, b in zip(u_g, u_w))
        assert all(_same(a, b) for a, b in zip(r_g, r_w))
        assert set(m_g) == set(m_w) and all(_same(m_g[k], m_w[k]) for k in m_w)
    assert [float(m["exchange/dense_step"]) for _, _, m in got] == [
        float(t % 5 == 4) for t in range(11)]


@pytest.mark.parametrize("fields", [
    dict(compressor="topk_exact"), dict(compressor="topk_q8"),
    dict(rho=1.0, group_size=4, sync_period=1, gamma=1.0)], ids=["exact", "q8", "dense"])
def test_other_filters_keep_the_generic_split(fields):
    cfg = exchange.ExchangeConfig(**{**dict(num_groups=4, group_size=2, sync_period=3,
                                            rho=1 / 64), **fields})
    grads = {k: torch.randn(4, *s) for k, s in SHAPES.items()}
    params = {k: torch.zeros(s) for k, s in SHAPES.items()}
    with ops.recording_launches() as counts:
        exchange.exchange_sequential(cfg, lambda _, b: {k: v[b["i"]] for k, v in grads.items()},
                                     params, {"i": torch.arange(4)},
                                     exchange.init_state(cfg, params), torch.tensor(0))
    assert counts["exchange_apply"] == 0


def test_plain_calls_launch_nothing():
    res, acc = torch.zeros(2048), torch.zeros(2048)
    before = dict(ops.LAUNCHES)
    ops.exchange_apply_add(res, torch.ones(2048, dtype=torch.bfloat16))
    ops.exchange_apply_split(res, acc, torch.tensor(1.0), torch.tensor(False), torch.tensor(0.5),
                             torch.zeros(()), torch.zeros(()), dense_bytes=(4, 0),
                             sparse_bytes=(8, 0))
    assert ops.LAUNCHES == before
    assert torch.equal(acc, torch.ones(2048)) and torch.equal(res, torch.zeros(2048))


def test_cuda_wrappers_refuse_a_host_tensor():
    res = torch.zeros(64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        exchange_apply_add_cuda(res, torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        exchange_apply_split_cuda(res, torch.zeros(64), torch.tensor(1.0), torch.tensor(True),
                                  None, torch.zeros(()), torch.zeros(()), dense_bytes=(4, 0),
                                  sparse_bytes=(8, 0))
