"""The HuBERT cell's own pieces on the CPU: its counts by hand, its faults and
its control at the tiny cut, its files' key names, its readers."""

from __future__ import annotations

import math

import pytest
import torch

from perfbench import calibrate_audio, harness
from perfbench.inputs import audio, hubert_weights
from perfbench.tests.conftest import TINY_BATCH, TINY_DECODER, tiny_cell
from perfbench.tests.test_perfbench_counting import metric_module

CELL = "hubert-xlarge.acpd-exchange"
SEED = 2**31 + 9_000_011


@pytest.fixture(scope="module")
def full():
    cell = harness.find_cell(harness.load_bench(), CELL)
    return cell.config, cell.traffic


def test_parameters_are_the_published_count(full):
    from perfbench.drivers.audio_steps import model_config
    from repro_torch.models import model_spec
    from repro_torch.models.param import num_params

    config, _ = full
    conv = (512 * 10 + 512 * 3) + 4 * (512 * 512 * 3 + 512 * 3) + 2 * (512 * 512 * 2 + 512 * 3)
    assert conv == 4_210_176
    block = 4 * (1280 * 1280 + 1280) + 2 * 1280 * 5120 + 5120 + 1280 + 4 * 1280
    assert block == 19_677_440
    parts = [conv, 512 * 2 + 512 * 1280 + 1280, 1280, 1280 * 80 * 128 + 128 + 1280, 2 * 1280,
             48 * block, 1280 * 1024 + 1024 + 500 * 1024]
    assert parts[1:5] == [657_664, 1280, 13_108_608, 2560] and parts[6] == 1_823_744
    assert sum(parts) == 964_321_152 == config["parameters"]
    assert sum(math.prod(s) for s, _ in hubert_weights.shapes(config).values()) == sum(parts)
    assert num_params(model_spec(model_config(config))) == sum(parts)


def test_encoder_flops_by_hand(full):
    config, traffic = full
    m = metric_module("encoder.mfu")
    B, S = 8, 562
    assert hubert_weights.samples(config, S) == 179_920
    frames = [35_983, 17_991, 8_995, 4_497, 2_248, 1_124, 562]
    macs = 512 * 10 * frames[0] + sum(512 * 512 * 3 * f for f in frames[1:5]) \
        + sum(512 * 512 * 2 * f for f in frames[5:]) + 1280 * 80 * 128 * S
    assert m.conv_macs(config, S) == macs
    matrices = 48 * (4 * 1280 * 1280 + 2 * 1280 * 5120) + 512 * 1280 + 1280 * 1024
    assert m.matrix_params(config) == matrices
    attn = 4 * B * 16 * 80 * S * S * 48
    masked = B * audio.expected_masked_frames(S, 0.8, 10)
    want = 6 * matrices * B * S + 6 * macs * B + 3 * attn + 6 * 1024 * 500 * masked
    assert m.step_flops(config, traffic) == pytest.approx(want, rel=1e-12)
    assert 2.9e13 < want < 2.92e13
    roof = metric_module("encoder_attn.roofline")
    assert roof.attention_forward_flops(config, traffic) == attn
    # The monitored forward, each group's forward and its recompute under remat.
    assert roof.passes(traffic) == 3
    assert roof.passes(dict(traffic, remat=False)) == 2


def test_threshold_leaves_by_hand(full):
    """The exchange filters every leaf of at least 1,024 coordinates: all but
    the conv layers' biases and norms (512 each), the feature norm's two and
    the positional conv's g (128)."""
    config, traffic = full
    m = metric_module("encoder_threshold.roofline")
    e = traffic["exchange"]
    left_out = 7 * 512 + 7 * 2 * 512 + 2 * 512 + 128
    assert m.filtered_coordinates(config, e) == 964_321_152 - left_out == 964_309_248
    # B 2 of K 4 groups on 9 of every 10 steps, 3 passes of 4 B with refine.
    assert m.step_bytes(config, e) == pytest.approx(2 * 0.9 * 12 * 964_309_248)


def test_expected_masked_frames_against_draws():
    """The closed form against the stream's own masks (and by hand at a small S)."""
    # S 12, L 10: two starts of 2 (0 or 1), both always drawn: frames 0..10.
    assert audio.expected_masked_frames(12, 0.8, 10) == pytest.approx(11.0)
    config = dict(TINY_DECODER, conv_kernel=[10, 3, 3, 3, 3, 2, 2], conv_stride=[5, 2, 2, 2, 2, 2, 2])
    traffic = {"batch": 50, "seq": 40, "label_zipf": 1.1, "mask_prob": 0.8, "mask_length": 10}
    stream = audio.AudioStream(config, traffic, SEED, torch.device("cpu"))
    stream.samples = 1  # the waveforms are not looked at here
    draws = 2_000  # the span count is drawn a batch: 0.27 % of standard error
    got = sum(int(stream.next_batch()["mask"].sum()) for _ in range(draws)) / (50 * draws)
    assert got == pytest.approx(audio.expected_masked_frames(40, 0.8, 10), rel=1e-2)


def test_config_and_traffic_keep_the_tiny_cut_s_names(full):
    config, traffic = full
    assert set(TINY_DECODER) <= set(config) and set(TINY_BATCH) <= set(traffic)
    cell = tiny_cell(CELL)
    assert cell.config["hidden_size"] == 64 and cell.traffic["seq"] == 32
    assert cell.config["hidden_size"] % cell.config["num_conv_pos_embedding_groups"] == 0


def test_same_seed_same_batches():
    cell = tiny_cell(CELL)
    a = audio.AudioStream(cell.config, cell.traffic, SEED, torch.device("cpu"))
    b = audio.AudioStream(cell.config, cell.traffic, SEED, torch.device("cpu"))
    x, y = a.next_batch(), b.next_batch()
    assert all(torch.equal(x[k], y[k]) for k in x)
    assert x["waveform"].shape == (8, hubert_weights.samples(cell.config, 32))
    assert not torch.equal(a.next_batch()["waveform"], x["waveform"])


@pytest.mark.parametrize("fault", calibrate_audio.FAULTS)
def test_fault_is_not_correct(fault):
    """Over the first ``steady_steps`` (3) of the compared steps, whose values
    the check compares (the later steps add their bytes only): a third of
    the CPU time of all 11."""
    cell = tiny_cell(CELL)
    cell.traffic["check_steps"] = cell.traffic["steady_steps"]
    with calibrate_audio.planted(fault):
        out = harness.run_cell(cell, SEED, 0.2, False, "cpu")
    assert out["correct"] is False, out["checks"]


def test_control_is_not_correct():
    """Float8 products in the reference, put in the program's place."""
    from perfbench.drivers import train_steps
    from perfbench.reference import hubert as reference

    cell = tiny_cell(CELL)
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


MADE_UP = {"spans": {"audio.frontend": {"count": 10, "host_ms": 1.0, "self_host_ms": 1.0,
                                        "wait_ms": 0.0, "device_ms": 80.0},
                     "audio.posconv": {"count": 10, "host_ms": 1.0, "self_host_ms": 1.0,
                                       "wait_ms": 0.0, "device_ms": 12.0}},
           "dropped": 0, "launches": {}, "executor": {}}


@pytest.mark.parametrize("name, want", [("frontend.ms_per_step", 40.0),
                                        ("posconv.ms_per_step", 6.0)])
def test_span_readers(monkeypatch, name, want):
    from repro_torch import tracing

    ctx = harness.TraceContext(config={}, traffic={}, peaks=harness.peaks(), units=2,
                               window_s=1.0, busy_s=0.5, kernels=[], spans={})
    monkeypatch.setattr(tracing, "summary", lambda: MADE_UP)
    assert harness.load_reader(name)(ctx) == pytest.approx(want)
    off_card = {"spans": {k: dict(v, device_ms=None) for k, v in MADE_UP["spans"].items()}}
    monkeypatch.setattr(tracing, "summary", lambda: off_card)
    assert harness.load_reader(name)(ctx) is None


def test_device_readers_on_a_made_up_trace(full):
    config, traffic = full
    kernels = [("void flash_fwd_bf16<80>", 0, 4_000_000), ("exchange_threshold_hist", 0, 1_000_000)]
    ctx = harness.TraceContext(config=config, traffic=traffic, peaks=harness.peaks(), units=2,
                               window_s=5.0, busy_s=4.0, kernels=kernels, spans={})
    flops = metric_module("encoder.mfu").step_flops(config, traffic)
    assert harness.load_reader("encoder.mfu")(ctx) == pytest.approx(100 * 2 * flops / (5 * 989e12))
    attn = metric_module("encoder_attn.roofline").attention_forward_flops(config, traffic)
    assert harness.load_reader("encoder_attn.roofline")(ctx) == pytest.approx(
        100 * 2 * 3 * attn / 989e12 / 0.004)
    moved = metric_module("encoder_threshold.roofline").step_bytes(config, traffic["exchange"])
    assert harness.load_reader("encoder_threshold.roofline")(ctx) == pytest.approx(
        100 * 2 * moved / harness.peaks()["hbm_bytes_per_s"] / 0.001)
    empty = harness.TraceContext(config=config, traffic=traffic, peaks=harness.peaks(), units=2,
                                 window_s=5.0, busy_s=0.0, kernels=[], spans={})
    assert harness.load_reader("encoder.mfu")(empty) is None
    assert harness.load_reader("encoder_attn.roofline")(empty) is None
    assert harness.load_reader("encoder_threshold.roofline")(empty) is None
