"""The Qwen3-MoE cell's own pieces on the CPU: the cell through the harness
at a tiny cut, its counts by hand, its readers, its faults and control."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import calibrate_moe, harness
from perfbench.inputs import moe_weights
from perfbench.tests.test_perfbench_counting import metric_module

CELL = "qwen3-moe-30b-a3b.acpd-exchange"
SEED = 2**31 + 9_000_041
# d_model 64 and 8 experts (2 held a chip), width 32, top-2, in float32: the
# bf16 cut's rounding (the conftest cut's) moves its small updates by a share
# of a bf16 step each, so this cut checks the plumbing, the faults and the
# control, and test_perfbench_cells the bf16 cut at the cell's limits.
TINY = {"hidden_size": 64, "moe_intermediate_size": 32, "num_attention_heads": 4,
        "num_key_value_heads": 2, "head_dim": 16, "num_hidden_layers": 2, "num_experts": 8,
        "num_experts_per_tok": 2, "vocab_size": 256, "torch_dtype": "float32"}


@pytest.fixture(scope="module")
def full():
    cell = harness.find_cell(harness.load_bench(), CELL)
    return cell.config, cell.traffic


def tiny(steps: int = 3) -> harness.Cell:
    cell = harness.find_cell(harness.load_bench(), CELL)
    cell.config.update(TINY)
    cell.traffic.update(batch=8, seq=32, check_steps=steps, steady_steps=min(steps, 3))
    return cell


def test_the_cut_and_its_state_by_hand(full):
    config, traffic = full
    assert moe_weights.held(config) == (32, 0, 37_984)
    per_layer = (2048 * 4096 * 2 + 2048 * 512 * 2 + 2 * 128 + 2 * 2048 + 2048 * 128
                 + 32 * 3 * 2048 * 768)
    assert per_layer == 170_135_808
    total = sum(math.prod(s) for s, _ in moe_weights.shapes(config).values())
    assert total == 8 * per_layer + 2 * 2048 * 37_984 + 2048 == config["parameters"]
    # Each held expert's rows a group pass: 2 x 4,096 tokens x 8 choices x 32 / 128 / 32.
    group_tokens = traffic["batch"] * traffic["seq"] // traffic["exchange"]["num_groups"]
    assert group_tokens * 8 * 32 / 128 / 32 == 512


def test_step_flops_by_hand(full):
    config, traffic = full
    m = metric_module("moe_train.mfu")
    attn = 2048 * 4096 * 2 + 2048 * 512 * 2
    touched = 8 * (attn + 2048 * 128 + 8 * 32 / 128 * 3 * 2048 * 768) + 2048 * 37_984
    assert m.touched_params(config) == touched == 306_380_800
    assert m.attention_forward_flops(config, traffic) == \
        4 * 8 * 32 * 128 * (4096 * 4097 // 2) * 8
    want = 6 * touched * 32_768 + 3 * m.attention_forward_flops(config, traffic)
    assert m.step_flops(config, traffic) == pytest.approx(want, rel=1e-12)
    assert 8.66e13 < want < 8.67e13


def test_expert_products_and_threshold_bytes_by_hand(full):
    """The grouped products of a step: 65,536 held rows a layer (32,768 tokens
    x 8 choices x 32 / 128) in each of 8 layers, 3 products each in the
    monitored forward and 12 in
    the groups' passes (forward, remat's recompute, backward's two
    gradients); the threshold reads every filtered coordinate 3 times (max|x|
    and two histogram rounds) for 2 groups on 9 of every 10 steps."""
    config, traffic = full
    m = metric_module("moe_experts.roofline")
    assert m.held_rows(config, traffic) == 65_536
    assert m.products_per_row(traffic) == 15
    assert m.products_per_row(dict(traffic, remat=False)) == 12
    assert m.products_per_row(dict(traffic, remat=False, exchange=None)) == 9
    assert m.step_flops(config, traffic) == 2 * 2048 * 768 * 65_536 * 15 * 8
    t = metric_module("moe_threshold.roofline")
    e = traffic["exchange"]
    # Every leaf: stacked over 8 layers, even the q/k norms hold 8 x 128.
    coords = config["parameters"]
    assert t.filtered_coordinates(config, e) == coords == 1_516_670_976
    assert t.step_bytes(config, e) == pytest.approx(2 * 0.9 * 4 * 3 * coords)


MADE_UP = {"spans": {n: {"count": 64, "host_ms": 1.0, "self_host_ms": 1.0, "wait_ms": 0.0,
                         "device_ms": ms}
                     for n, ms in (("moe.route", 10.0), ("moe.dispatch", 20.0),
                                   ("moe.experts", 50.0), ("moe.combine", 20.0))},
           "dropped": 0, "launches": {}, "executor": {}, "blocks": {},
           "moe": {"calls": 64, "held_rows": 1_000_000, "largest_expert_rows": 64 * 600}}


def _ctx(config, traffic, units=2, busy=4.0, kernels=()):
    return harness.TraceContext(config=config, traffic=traffic, peaks=harness.peaks(),
                                units=units, window_s=5.0, busy_s=busy, kernels=list(kernels),
                                spans={})


def test_readers_on_a_made_up_trace(monkeypatch, full):
    from repro_torch import tracing

    config, traffic = full
    monkeypatch.setattr(tracing, "summary", lambda: MADE_UP)
    gemm = "_ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9xINS_4gemm6" \
        "kernel13GemmUniversalINS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEEE"
    kernels = [(gemm, 0, 10_000_000), (gemm, 0, 5_000_000), ("exchange_threshold_hist", 0, 8e6),
               ("ampere_bf16_gemm", 0, 1e9)]
    ctx = _ctx(config, traffic, kernels=kernels)
    assert harness.load_reader("moe.ms_per_step")(ctx) == pytest.approx(50.0)
    flops = metric_module("moe_experts.roofline").step_flops(config, traffic)
    assert harness.load_reader("moe_experts.roofline")(ctx) == \
        pytest.approx(100 * 2 * flops / 989e12 / 0.015)
    nbytes = metric_module("moe_threshold.roofline").step_bytes(config, traffic["exchange"])
    assert harness.load_reader("moe_threshold.roofline")(ctx) == \
        pytest.approx(100 * 2 * nbytes / harness.peaks()["hbm_bytes_per_s"] / 0.008)
    step = metric_module("moe_train.mfu").step_flops(config, traffic)
    assert harness.load_reader("moe_train.mfu")(ctx) == \
        pytest.approx(100 * 2 * step / (5 * 989e12))
    off_card = {**MADE_UP, "spans": {k: dict(v, device_ms=None)
                                     for k, v in MADE_UP["spans"].items()}}
    monkeypatch.setattr(tracing, "summary", lambda: off_card)
    bare = _ctx(config, traffic, busy=0.0)
    for name in ("moe.ms_per_step", "moe_experts.roofline", "moe_threshold.roofline",
                 "moe_train.mfu"):
        assert harness.load_reader(name)(bare) is None, name
    parent = {k: v for k, v in MADE_UP.items() if k != "moe"}
    parent["spans"] = {}
    monkeypatch.setattr(tracing, "summary", lambda: parent)  # a program without the layer
    ctx = _ctx(config, traffic, kernels=kernels[2:])
    assert harness.load_reader("moe.ms_per_step")(ctx) is None
    assert harness.load_reader("moe_experts.roofline")(ctx) is None


def test_the_tiny_cell_through_the_harness():
    """Untraced, then traced: correct within the cell's limits, and the
    traced run's host syncs are the exchange's plain histogram rounds' alone
    (the CPU's; the MoE layer and the attention scale add none)."""
    cell = tiny()
    out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"step_s", "peak_gb", "setup_s"}
    out = harness.run_cell(cell, SEED + 1, 0.2, True, "cpu")
    assert out["correct"] is True, out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert not {"moe.ms_per_step", "moe_experts.roofline", "moe_train.mfu"} & set(got)
    e = cell.traffic["exchange"]
    leaves = sum(math.prod(s) >= e["min_leaf_size"]
                 for s, _ in moe_weights.shapes(cell.config).values())
    assert got["exchange.syncs_per_step"] == 2 * 3 * e["num_groups"] * leaves


@pytest.mark.parametrize("fault", calibrate_moe.FAULTS)
def test_fault_is_not_correct(fault):
    cell = tiny()
    with calibrate_moe.planted(fault):
        out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is False, out["checks"]


def test_control_is_not_correct():
    """Float8 products in the reference, put in the program's place."""
    from perfbench.drivers import train_steps
    from perfbench.reference import qwen3_moe as reference

    cell = tiny()
    ws, ts = harness.derive_seed(SEED, 10), harness.derive_seed(SEED, 11)
    ctrl = reference.train(cell.config, cell.traffic, ws, ts, "cpu", steps=3, precision="fp8",
                           keep_values=True)
    want = reference.train(cell.config, cell.traffic, ws, ts, "cpu", steps=3,
                           judges=[ctrl["values"]])
    got = {"loss": ctrl["loss"], "bytes": ctrl["bytes"]}
    for k in ("grad", "change", "residual"):
        got[k] = dict(zip(ctrl["paths"], ctrl[k]))
    numbers = train_steps.compare(got, want, want["grad_dist"][0])
    limits = cell.limits["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


def test_the_parent_fails_at_set_up(monkeypatch):
    """A program without the held-experts config fails before any weight is made."""
    from perfbench.drivers import moe_steps
    from repro_torch.models import config as config_lib

    monkeypatch.delattr(config_lib, "HeldExpertsConfig")
    made = []
    monkeypatch.setattr(moe_weights, "make", lambda *a, **k: made.append(1))
    cell = tiny()
    with pytest.raises(ImportError):
        moe_steps.setup(cell.config, cell.traffic, SEED, torch.device("cpu"), cell.limits)
    assert not made
