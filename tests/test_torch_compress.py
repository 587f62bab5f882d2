"""Port vs JAX package: the compressor registry (``core/compress.py``).

The same seeded numpy inputs go through both packages' compressors. The
kept sets are decided by comparisons (stable sort, ties toward the lower
index; thresholds), so ``sent``, ``residual`` and the masks are EQUAL, not
close; ``topk_q8``'s dequantized values too (one float32 division, round
half to even, one product). Within the port, ``sent + residual == dw`` bit
for bit for every entry. The histogram threshold is held to rtol 1e-6 (it
takes ``log``/``exp`` of float32 values, whose last bit may differ between
the libraries), and its kept count to the same count.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as jcp
from repro.core import exchange as jex
from repro.core.acpd import MethodConfig as JMethod
from repro_torch.core import compress as tcp
from repro_torch.core.acpd import MethodConfig as TMethod

NAMES = ("dense", "topk_exact", "topk_threshold", "topk_q8")


def _vector(seed, d, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32)
    if ties:  # duplicated magnitudes, both signs
        half = x[: (d + 1) // 2]
        x = np.concatenate([half, -half])[:d]
        rng.shuffle(x)
    return x


def test_registry_names_and_errors():
    assert tcp.available_compressors() == jcp.available_compressors()
    assert set(NAMES) <= set(tcp.available_compressors())
    with pytest.raises(ValueError, match="unknown compressor 'nope'"):
        tcp.get_compressor("nope")
    comp = tcp.get_compressor("topk_exact")(k=3)
    with pytest.raises(dataclasses.FrozenInstanceError):
        comp.k = 4
    assert hash(comp) == hash(tcp.TopKExact(k=3))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("d,k,ties", [(64, 5, False), (512, 40, True), (1001, 1, False),
                                      (300, 300, True)])
def test_compress_matches_jax(name, d, k, ties):
    x = _vector(d + k, d, ties)
    jc = jcp.get_compressor(name)(k=k, rho=k / d)
    tc = tcp.get_compressor(name)(k=k, rho=k / d)
    js, jr = jc.compress(jnp.asarray(x))
    ts, tr = tc.compress(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    assert torch.equal(ts + tr, torch.from_numpy(x))  # error feedback loses nothing
    assert tc.wire_bytes(d) == jc.wire_bytes(d)
    assert tc.payload_bytes(k) == jc.payload_bytes(k)
    assert tc.entry_bytes == jc.entry_bytes and tc.message_overhead == jc.message_overhead


@pytest.mark.parametrize("name", NAMES[1:])
def test_compress_batches_rows_as_single_messages(name):
    rows = np.stack([_vector(s, 256, ties=s % 2 == 1) for s in range(4)])
    comp = tcp.get_compressor(name)(k=20)
    sent, resid = comp.compress(torch.from_numpy(rows))
    for b in range(4):
        s1, r1 = comp.compress(torch.from_numpy(rows[b]))
        assert torch.equal(sent[b], s1) and torch.equal(resid[b], r1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,rho", [((3, 2048), 0.01), ((2, 16, 40), 0.05),
                                       ((4, 300), 0.5)])
def test_compress_grouped_matches_jax(name, shape, rho):
    rng = np.random.default_rng(int(np.prod(shape)))
    x = rng.standard_normal(shape).astype(np.float32) * np.float32(0.01)
    jc = jcp.get_compressor(name)(rho=rho)
    tc = tcp.get_compressor(name)(rho=rho)
    js, jm = jc.compress_grouped(jnp.asarray(x))
    ts, tm = tc.compress_grouped(torch.from_numpy(x))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.shape == shape and tm.dtype == torch.bool


@pytest.mark.parametrize("refine", [True, False])
@pytest.mark.parametrize("d,k", [(4096, 40), (1000, 1), (777, 500)])
def test_threshold_for_topk_matches_jax(d, k, refine):
    x = _vector(d * 3 + k, d) * np.float32(0.3)
    jt = float(jcp.threshold_for_topk(jnp.asarray(x), jnp.int32(k), refine))
    tt = float(tcp.threshold_for_topk(torch.from_numpy(x), k, refine))
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    kept = int((np.abs(x) >= tt).sum())
    assert kept == int((np.abs(x) >= jt).sum())
    assert kept >= min(k, int((np.abs(x) >= np.abs(x).max() * 2.0**-22).sum()))


def test_sparsify_leaf_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 64, 8)).astype(np.float32)
    js, jm = jcp.sparsify_leaf(jnp.asarray(x), 0.1)
    ts, tm = tcp.sparsify_leaf(torch.from_numpy(x), 0.1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_q8_round_half_to_even_and_levels():
    # |sent| / scale lands on +-127 at the maximum, and on .5 boundaries.
    x = np.array([127.0, -63.5, 0.5, 1.5, -2.5, 10.0, 0.0, -127.0], np.float32)
    comp = tcp.QuantizedTopK(k=8)
    sent, resid = comp.compress(torch.from_numpy(x))
    js, _ = jcp.QuantizedTopK(k=8).compress(jnp.asarray(x))
    np.testing.assert_array_equal(sent.numpy(), np.asarray(js))
    np.testing.assert_array_equal(sent.numpy(), [127, -64, 0, 2, -2, 10, 0, -127])
    assert torch.equal(sent + resid, torch.from_numpy(x))


@pytest.mark.parametrize("fields", [
    dict(rho=1.0), dict(rho=0.05), dict(rho=0.05, use_exact_k=False),
    dict(rho=0.05, compressor="topk_q8"), dict(rho=0.05, compressor="dense"),
    dict(rho=0.5, compressor="topk_threshold")])
def test_for_method_mapping(fields):
    d = 400
    jc = jcp.for_method(JMethod(name="m", **fields), d)
    tc = tcp.for_method(TMethod(name="m", **fields), d)
    assert type(tc).__name__ == type(jc).__name__
    assert (tc.compressor_name, tc.k, tc.rho, tc.refine) == (
        jc.compressor_name, jc.k, jc.rho, jc.refine)
    assert tc.wire_bytes(d) == jc.wire_bytes(d)


@pytest.mark.parametrize("compressor,rho", [("topk_threshold", 0.01), ("topk_q8", 0.1),
                                            ("topk_exact", 0.2), ("dense", 0.1),
                                            ("topk_q8", 1.0)])
def test_for_exchange_mapping(compressor, rho):
    cfg = jex.ExchangeConfig(num_groups=4, group_size=2, rho=rho, compressor=compressor,
                             refine=False)
    jc, tc = jcp.for_exchange(cfg), tcp.for_exchange(cfg)
    assert type(tc).__name__ == type(jc).__name__
    assert (tc.compressor_name, tc.k, tc.rho, tc.refine) == (
        jc.compressor_name, jc.k, jc.rho, jc.refine)
