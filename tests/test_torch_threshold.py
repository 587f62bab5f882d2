"""The exchange's histogram threshold through ``kernels/ops.py`` on the CPU.

On the CPU ``ops.exchange_threshold`` is the plain version
(``kernels/exchange_threshold.py``): it launches nothing, and a
``recording_launches`` block counts each call as the one launch it makes on
the card. Every caller of the threshold goes through it: one call a group
for ``sparsify_leaf``, so ``exchange`` and ``exchange_sequential`` make one
a group for each leaf of at least ``min_leaf_size`` coordinates. The card's
kernel against the plain version is in ``tests/test_torch_cuda.py``; the
plain version against the JAX package in ``tests/test_torch_compress.py``.
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.core import compress, exchange
from repro_torch.kernels import ops
from repro_torch.kernels.exchange_threshold import (exchange_threshold_cuda,
                                                    exchange_threshold_plain)

KINDS = ("randn", "ties", "zeros99", "zeros", "huge")


def _input(kind: str, n: int) -> torch.Tensor:
    rng = np.random.default_rng(n * 10 + KINDS.index(kind))
    x = rng.standard_normal(n).astype(np.float32)
    if kind == "ties":
        x = rng.integers(-3, 4, n).astype(np.float32) * np.float32(0.25)
    elif kind == "zeros99":
        x = np.where(rng.random(n) < 0.01, x, np.float32(0))
    elif kind == "zeros":
        x = np.zeros(n, np.float32)
    elif kind == "huge":
        x[n // 3] = np.float32(3e37)
    return torch.from_numpy(x)


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [1, 7, 1024, 5120])
def test_plain_dispatch_is_one_recorded_call(n, kind, refine):
    x = _input(kind, n)
    before = dict(ops.LAUNCHES)
    for k in sorted({1, max(1, int(n / 64)), n}):
        with ops.recording_launches() as counts:
            got = ops.exchange_threshold(x, k, refine)
        assert counts == dict.fromkeys(ops.LAUNCHES, 0) | {"exchange_threshold": 1}
        want = exchange_threshold_plain(x, k, refine)
        assert got.shape == () and got.dtype == torch.float32
        assert got.view(torch.int32).item() == want.view(torch.int32).item()
        kept = int((x.abs() >= got).sum())
        floor = int((x.abs() >= x.abs().max() * 2.0**-22).sum())
        assert kept >= min(k, floor)
    assert ops.LAUNCHES == before  # the plain version launches nothing


def test_plain_version_takes_any_shape_and_float_type():
    x = _input("randn", 4096).reshape(16, 256)
    want = exchange_threshold_plain(x.reshape(-1), 40)
    assert torch.equal(ops.exchange_threshold(x, 40), want)
    assert torch.equal(ops.exchange_threshold(x.t(), 40), want)  # not contiguous
    bf = x.to(torch.bfloat16)
    assert torch.equal(ops.exchange_threshold(bf, 40),
                       exchange_threshold_plain(bf.to(torch.float32), 40))


def test_threshold_for_topk_goes_through_ops():
    x = _input("randn", 3000)
    with ops.recording_launches() as counts:
        t = compress.threshold_for_topk(x, 30)
    assert counts["exchange_threshold"] == 1
    assert torch.equal(t, exchange_threshold_plain(x, 30))


@pytest.mark.parametrize("name", ["topk_threshold", "topk_q8"])
@pytest.mark.parametrize("G", [1, 3])
def test_compress_grouped_makes_one_call_a_group(name, G):
    dw = torch.stack([_input("randn", 2048) * (g + 1) for g in range(G)]).reshape(G, 32, 64)
    comp = compress.get_compressor(name)(rho=0.05)
    with ops.recording_launches() as counts:
        comp.compress_grouped(dw)
    assert counts["exchange_threshold"] == G


@pytest.mark.parametrize("sequential", [False, True], ids=["stacked", "sequential"])
def test_exchange_calls_once_a_group_for_each_filtered_leaf(sequential):
    shapes = {"a": (40, 64), "b": (3000,), "c": (16,), "d": (8, 128)}
    cfg = exchange.ExchangeConfig(num_groups=4, group_size=2, sync_period=3, rho=0.02,
                                  min_leaf_size=1024)
    filtered = sum(math.prod(s) >= cfg.min_leaf_size for s in shapes.values())
    rng = np.random.default_rng(0)
    params = {k: torch.zeros(s) for k, s in shapes.items()}
    state = exchange.init_state(cfg, params)
    for step in range(3):  # two sparse steps and the dense sync: a threshold each
        grads = {k: torch.from_numpy(rng.standard_normal((4, *s)).astype(np.float32))
                 for k, s in shapes.items()}
        with ops.recording_launches() as counts:
            if sequential:
                _, state, _ = exchange.exchange_sequential(
                    cfg, lambda _, b, g=grads: {k: v[b["i"]] for k, v in g.items()}, params,
                    {"i": torch.arange(4)}, state, torch.tensor(step))
            else:
                _, state, _ = exchange.exchange(cfg, grads, state, torch.tensor(step))
        assert counts["exchange_threshold"] == cfg.num_groups * filtered == 12


def test_cuda_wrapper_refuses_a_host_tensor():
    with pytest.raises(ValueError, match="CUDA tensor"):
        exchange_threshold_cuda(torch.ones(8), 1)
