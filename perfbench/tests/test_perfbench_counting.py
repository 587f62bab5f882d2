"""The metrics' counting functions against hand-worked cases and the program's own arithmetic."""

from __future__ import annotations

import math

import pytest

from perfbench import harness



def metric_module(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"m_{name.replace('.', '_')}",
                                                  harness.HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ACPD = {"method": {"protocol": "group", "B": 4, "T": 20, "H": 1000}, "num_outer": 1}
COCOA = {"method": {"protocol": "sync", "H": 1000}, "num_outer": 10}
RCV1 = {"workers": 8, "rows_per_worker": 20480, "num_features": 47236}


@pytest.mark.parametrize("traffic, config, want", [
    (ACPD, RCV1, 8 + 19 * 4 + 8),  # K at the start, B a round, K at the T-th
    (dict(ACPD, num_outer=2), RCV1, 8 + 2 * (19 * 4 + 8)),
    (COCOA, RCV1, 10 * 8),
    ({"method": {"protocol": "group", "B": 2, "T": 3, "H": 5}, "num_outer": 1},
     {"workers": 3, "rows_per_worker": 4, "num_features": 2}, 3 + 2 + 2 + 3),
])
def test_worker_epochs(traffic, config, want):
    assert metric_module("sdca_inner.roofline").worker_epochs(config, traffic) == want


def test_epoch_bytes_by_hand():
    m = metric_module("sdca_inner.roofline")
    # Two draws from two rows visit 1.5 distinct rows on average; d = 10:
    # rows x (d + label + norm) + w_eff + v + alpha + dalpha + order, 4 B each.
    config = {"rows_per_worker": 2, "num_features": 10}
    traffic = {"method": {"H": 2}}
    assert m.epoch_bytes(config, traffic) == pytest.approx(4 * (1.5 * 12 + 20 + 4 + 2))
    assert m.epoch_flops(config, traffic) == 6 * 10 * 2


def test_run_bound_at_rcv1_width():
    m = metric_module("sdca_inner.roofline")
    rows = 20480 * (1 - (1 - 1 / 20480) ** 1000)
    assert 975 < rows < 977
    per_epoch = 4 * (rows * 47238 + 2 * 47236 + 2 * 20480 + 1000) / 3.35e12
    assert m.bound_s(RCV1, ACPD, harness.peaks()) == pytest.approx(92 * per_epoch)
    assert 5.0e-3 < 92 * per_epoch < 5.2e-3  # bytes, not operations, bound the kernel


PHI3_2L = {"hidden_size": 5120, "intermediate_size": 17920, "num_attention_heads": 40,
           "num_key_value_heads": 10, "head_dim": 128, "vocab_size": 32064,
           "num_hidden_layers": 2}
BATCH = {"batch": 8, "seq": 1024}


def test_model_flops_of_two_layers_by_hand():
    m = metric_module("train.mfu")
    per_layer = 5120 * 5120 * 2 + 2 * 5120 * 1280 + 3 * 5120 * 17920
    assert m.matrix_params(PHI3_2L) == 2 * per_layer + 5120 * 32064 == 845_742_080
    attn_fwd = 4 * 8 * 40 * 128 * (1024 * 1025 // 2)
    want = 6 * 845_742_080 * 8192 + 3 * attn_fwd * 2
    assert m.step_flops(PHI3_2L, BATCH) == pytest.approx(want, rel=1e-12)
    assert 4.20e13 < want < 4.21e13


def test_matrix_params_are_the_programs_less_its_norms():
    from perfbench.drivers.train_steps import model_config
    from repro_torch.launch.flops import active_params

    cfg = model_config(dict(PHI3_2L, name="x", source="x", rope_theta=1e4,
                            rms_norm_eps=1e-5, torch_dtype="bfloat16"))
    norms = 2 * 2 * 5120 + 5120
    assert metric_module("train.mfu").matrix_params(PHI3_2L) == active_params(cfg) - norms


@pytest.mark.parametrize("exchange, passes", [(None, 1), ({"rho": 0.1}, 2)])
def test_flash_counted_work_is_the_programs_flash_flops(exchange, passes):
    from repro_torch.launch.hlo_analysis import flash_flops

    m = metric_module("flash_attn.roofline")
    traffic = dict(BATCH, exchange=exchange)
    one_layer = flash_flops((8, 1024, 10, 4, 128), True, None)
    assert m.attention_forward_flops(PHI3_2L, traffic) == 2 * one_layer
    assert m.passes(traffic) == passes


def test_idle_share_and_rooflines_read_nothing_without_device_time():
    ctx = harness.TraceContext(config=RCV1, traffic=ACPD, peaks=harness.peaks(), units=3,
                               window_s=1.0, busy_s=0.0, kernels=[], spans={})
    for name in ("sdca_inner.roofline", "device.idle_share.solver", "train.mfu",
                 "flash_attn.roofline", "grads.ms_per_step", "exchange.ms_per_step"):
        assert harness.load_reader(name)(ctx) is None


def test_readers_on_a_made_up_trace():
    kernels = [("sdca_cluster_kernel", 0, 10_000_000), ("void flash_fwd_bf16<1>", 0, 2_000_000)]
    ctx = harness.TraceContext(config=dict(RCV1, **PHI3_2L), traffic=dict(ACPD, **BATCH,
                               exchange={"rho": 0.1}), peaks=harness.peaks(), units=2,
                               window_s=4.0, busy_s=3.0, kernels=kernels,
                               spans={"value_and_grad": [10.0, 20.0], "exchange": [50.0, 60.0]})
    m = metric_module("sdca_inner.roofline")
    assert harness.load_reader("sdca_inner.roofline")(ctx) == pytest.approx(
        100 * 2 * m.bound_s(ctx.config, ctx.traffic, ctx.peaks) / 0.01)
    assert harness.load_reader("device.idle_share.solver")(ctx) == pytest.approx(25.0)
    assert harness.load_reader("grads.ms_per_step")(ctx) == pytest.approx(15.0)
    assert harness.load_reader("exchange.ms_per_step")(ctx) == pytest.approx(40.0)
    flops = metric_module("train.mfu").step_flops(ctx.config, ctx.traffic)
    assert harness.load_reader("train.mfu")(ctx) == pytest.approx(100 * 2 * flops / (4.0 * 989e12))
    fl = 2 * metric_module("flash_attn.roofline").attention_forward_flops(ctx.config, ctx.traffic)
    assert harness.load_reader("flash_attn.roofline")(ctx) == pytest.approx(
        100 * 2 * fl / 989e12 / 0.002)
    assert math.isfinite(harness.load_reader("train.mfu")(ctx))
