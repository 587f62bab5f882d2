"""Port vs JAX package: the launch layer's shapes, FLOPs and bytes, and the dry-run.

The JAX package's own functions are the reference: ``configs.input_specs``
and ``shape_supported`` for every (architecture x input shape), shapes and
dtypes leaf for leaf (token ids are int64 in the port, int32 in JAX);
``active_params``, ``model_flops``, ``hbm_bytes`` and ``memory_seconds`` (at
JAX's 819e9 bytes/s) held to relative 1e-12 on one card, one 16 x 16 pod
and two, with the exchange off and on; the ring byte rules against
``repro.launch.hlo_analysis.parse_collectives`` on HLO lines of each
collective. The port's FLOP counter (the step on ``meta`` tensors under
``FlopCounterMode``, the flash kernel from its shapes) is held to a closed
form of two reduced configs' products and to its own count without the
period extrapolation. ``dryrun.run_one`` and the CLI run on the CPU: the
abstract records at full size, and the steps themselves at reduced configs.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import analytic as janalytic
from repro.launch import flops as jflops
from repro.launch import hlo_analysis as jhlo
from repro_torch import configs as tconfigs
from repro_torch.launch import analytic, dryrun, flops, hlo_analysis
from repro_torch.launch.mesh import MESH_SHAPES, batch_divisor, data_axes, num_devices

ARCHS = list(jconfigs.ARCH_IDS)
SHAPES = list(jconfigs.INPUT_SHAPES)


def _cfgs(arch):
    return jconfigs.get_config(arch), tconfigs.get_config(arch)


def test_registry_and_shapes_equal_the_jax_package():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}


def _assert_leaf(t, j, where):
    want = str(j.dtype)
    if want == "int32":  # token ids: PyTorch's index type
        want = "int64"
    assert t.is_meta, where
    assert tuple(t.shape) == tuple(j.shape), where
    assert str(t.dtype).removeprefix("torch.") == want, where


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_shape_supported_match_jax(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    jshape, tshape = jconfigs.INPUT_SHAPES[shape], tconfigs.INPUT_SHAPES[shape]
    assert tconfigs.shape_supported(tcfg, tshape) == jconfigs.shape_supported(jcfg, jshape)
    if not jconfigs.shape_supported(jcfg, jshape)[0]:
        with pytest.raises(ValueError, match="unsupported"):
            tconfigs.input_specs(tcfg, tshape)
        return
    want = jconfigs.input_specs(jcfg, jshape)
    got = tconfigs.input_specs(tcfg, tshape)
    assert sorted(got) == sorted(want)
    if "batch" in want:
        assert sorted(got["batch"]) == sorted(want["batch"])
        for name, leaf in want["batch"].items():
            _assert_leaf(got["batch"][name], leaf, name)
        return
    _assert_leaf(got["token"], want["token"], "token")
    assert got["cache_len"] == tshape.seq_len and want["cache_len"].shape == ()
    assert len(got["caches"]) == len(want["caches"])
    for si, (ts, js) in enumerate(zip(got["caches"], want["caches"])):
        assert sorted(ts) == sorted(js)
        for key in js:
            assert type(ts[key]).__name__ == type(js[key]).__name__
            assert ts[key]._fields == js[key]._fields
            for field, a, b in zip(js[key]._fields, ts[key], js[key]):
                _assert_leaf(a, b, f"stage{si}.{key}.{field}")


@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_equal_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    assert flops.active_params(tcfg) == jflops.active_params(jcfg)
    for shape in SHAPES:
        got = flops.model_flops(tcfg, tconfigs.INPUT_SHAPES[shape])
        assert got == jflops.model_flops(jcfg, jconfigs.INPUT_SHAPES[shape])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_hbm_bytes_and_memory_seconds_equal_jax(arch, shape):
    """Every mesh shape (one card, 16 x 16, 2 x 16 x 16) and exchange (off,
    on), at JAX's bandwidth; the port's default is the H100's."""
    jcfg, tcfg = _cfgs(arch)
    jshape, tshape = jconfigs.INPUT_SHAPES[shape], tconfigs.INPUT_SHAPES[shape]
    for mesh in MESH_SHAPES.values():
        for exchange in (False, True):
            want = janalytic.hbm_bytes(jcfg, jshape, dict(mesh), exchange=exchange)
            got = analytic.hbm_bytes(tcfg, tshape, dict(mesh), exchange=exchange)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
            np.testing.assert_allclose(
                analytic.memory_seconds(tcfg, tshape, dict(mesh), 819e9, exchange=exchange),
                janalytic.memory_seconds(jcfg, jshape, dict(mesh), exchange=exchange),
                rtol=1e-12, atol=0)
            assert analytic.memory_seconds(tcfg, tshape, dict(mesh), exchange=exchange) == (
                got / 3.35e12)


def test_mesh_shape_arithmetic():
    assert [num_devices(m) for m in MESH_SHAPES.values()] == [1, 256, 512]
    assert data_axes(MESH_SHAPES["multi"]) == ("pod", "data")
    assert [batch_divisor(MESH_SHAPES[k]) for k in ("single", "production", "multi")] == [
        1, 16, 32]
    from repro_torch.launch.mesh import _pow2_floor

    assert [_pow2_floor(n) for n in (0, 1, 3, 8, 9)] == [1, 1, 2, 8, 8]


HLO = """\
  %ar = f32[256]{0} all-reduce(f32[256]{0} %p0), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[64,16]{1,0} all-gather(bf16[16,16]{1,0} %p1), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[64]{0} reduce-scatter(f32[256]{0} %p2), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
  %aa = f32[128]{0} all-to-all(f32[128]{0} %p3), replica_groups={{0,1}}
  %cp = f32[32]{0} collective-permute(f32[32]{0} %p4), source_target_pairs={{0,1},{1,0}}
  %ar1 = f32[100]{0} all-reduce(f32[100]{0} %p5), replica_groups={{0}}, to_apply=%add
"""


def test_ring_byte_rules_equal_the_jax_parsers():
    stats = jhlo.parse_collectives(HLO)
    assert [op["kind"] for op in stats.ops] == [
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute",
        "all-reduce"]
    for op in stats.ops:
        assert hlo_analysis.wire_bytes(op["kind"], op["bytes"], op["group"]) == op["wire"]
    # One card: a group of one sends nothing (a permute to itself neither).
    for kind in ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                 "collective-permute"):
        assert hlo_analysis.wire_bytes(kind, 4096, 1) == 0.0
    with pytest.raises(ValueError):
        hlo_analysis.wire_bytes("broadcast", 1, 2)


@pytest.mark.parametrize("S,W,causal", [(100, None, True), (100, None, False), (100, 37, True),
                                        (100, 37, False), (30, 64, True), (1, 1, False)])
def test_flash_flops_count_the_pairs_the_mask_keeps(S, W, causal):
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    keep = np.ones((S, S), bool)
    if causal:
        keep &= j <= i
    if W is not None:
        keep &= i - j < W
    assert hlo_analysis.flash_flops((2, S, 3, 2, 16), causal, W) == 4 * 2 * 3 * 2 * 16 * int(
        keep.sum())


def _prefill_closed_form(cfg, B, S):
    """Products of a dense attention stack's prefill: q, k, v, o and the
    SwiGLU MLP per layer, the head at the last position, and the flash
    kernel's pairs; norms, RoPE and the embedding gather count nothing."""
    D, hd, H, KV, F = cfg.d_model, cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads, \
        cfg.d_ff
    T = B * S
    total = 0
    for layout, periods in cfg.stages():
        for layer in layout:
            assert layer.kind == "attn" and layer.mlp == "dense"
            per = 2 * T * D * hd * (H + 2 * KV) + 2 * T * H * hd * D + 3 * 2 * T * D * F
            per += hlo_analysis.flash_flops((B, S, KV, H // KV, hd), cfg.causal, layer.window)
            total += periods * per
    return total + 2 * B * D * cfg.vocab_size


@pytest.mark.parametrize("arch", ["qwen3-14b", "gemma3-27b"])
def test_flop_counter_equals_a_closed_form(arch):
    """qwen3-14b's and gemma3-27b's ``reduced()`` prefill at B 2, S 80 (past
    gemma3's reduced window of 64): the counter plus the flash formula equals
    the closed form of their products; gemma3's 12 layers are two periods, so
    its count goes through the period extrapolation, and a train step's
    extrapolated count equals the direct one."""
    cfg = tconfigs.get_config(arch).reduced()
    shape = tconfigs.InputShape("t", 80, 2, "prefill")
    got = hlo_analysis.count_step_flops(cfg, shape)
    assert got["flops"] == _prefill_closed_form(cfg, 2, 80)
    assert got["flash_calls"] == cfg.num_layers
    train = tconfigs.InputShape("t", 80, 4, "train")
    direct = hlo_analysis._count_parts(cfg, train, None, True)
    counted = hlo_analysis.count_step_flops(cfg, train)
    assert (counted["matmul_flops"], counted["flash_flops"], counted["flash_calls"]) == direct
    assert counted["flash_calls"] == 2 * cfg.num_layers  # the forward and remat's recompute
    acpd = hlo_analysis.count_step_flops(cfg, train, groups=2)
    assert acpd["flash_calls"] == (1 + 2 * 2) * cfg.num_layers  # monitored + 2 x (1 + remat)


def test_exploit_window_false_counts_the_backward_over_every_block():
    """The forward kernel is counted by the pairs its mask keeps, the same for
    both; the backward's products over every kv-block without the window
    (at S 1,536 the 512-row blocks reach past the reduced window of 64)."""
    cfg = tconfigs.get_config("gemma3-27b").reduced()
    shape = tconfigs.InputShape("t", 1536, 1, "train")
    win = hlo_analysis.count_step_flops(cfg, shape)
    full = hlo_analysis.count_step_flops(cfg, shape, exploit_window=False)
    assert full["flash_flops"] == win["flash_flops"]
    assert full["matmul_flops"] > win["matmul_flops"]


def test_dryrun_records_a_full_size_combination_and_a_skip():
    rec = dryrun.run_one("qwen3-14b", "decode_32k", "production", "plain")
    assert rec["status"] == "ok" and rec["num_devices"] == 256
    r = rec["roofline"]
    assert r["hbm_bytes_per_device"] == analytic.hbm_bytes(
        tconfigs.get_config("qwen3-14b"), tconfigs.INPUT_SHAPES["decode_32k"],
        dict(MESH_SHAPES["production"]))
    assert r["flops_per_device"] == rec["counted"]["flops"] / 256
    assert r["useful_ratio"] == rec["model_flops_global"] / rec["counted"]["flops"]
    assert r["collective_s"] is None and r["dominant"] in ("compute", "memory")
    assert not rec["fits"] and rec["capacity_bytes"] == dryrun.CPU_CAPACITY
    assert r["memory_stats"]["caches"] > 80e9  # 40 layers x 128 x 32,768 slots
    skip = dryrun.run_one("hubert-xlarge", "decode_32k")
    assert skip["status"] == "skipped" and skip["reason"].startswith("encoder-only")


@pytest.mark.parametrize("kind,exchange,mesh", [("train", "plain", "single"),
                                                ("train", "acpd", "production"),
                                                ("prefill", "plain", "single"),
                                                ("decode", "plain", "multi")])
def test_dryrun_runs_each_step_kind_on_the_cpu(kind, exchange, mesh):
    """A reduced config at a small shape, ``run=True`` on the CPU: the step
    runs (the ACPD one with 16 groups on the 16 x 16 mesh's data slices),
    its loss or logits finite, beside the resident estimate."""
    cfg = tconfigs.get_config("qwen3-14b").reduced()
    shape = tconfigs.InputShape(f"small_{kind}", 32, 16, kind)
    rec = dryrun.run_one("qwen3-14b", shape, mesh, exchange, cfg=cfg, run=True,
                         device=torch.device("cpu"))
    assert rec["status"] == "ok" and rec["fits"]
    assert rec["groups"] == (16 if exchange == "acpd" else None)
    assert rec["run"]["status"] == "ran" and rec["run"]["finite"]
    assert rec["run"]["peak_bytes"] is None  # no card
    parts = rec["roofline"]["memory_stats"]
    assert rec["resident_bytes"] == parts["total"] == sum(
        v for k, v in parts.items() if k != "total")
    if exchange == "acpd":
        assert parts["exchange"] == 16 * 4 * (parts["params"] // 4)  # float32 params


def test_dryrun_cli_on_the_cpu(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert dryrun.main(["--arch", "mamba2-780m", "--shape", "all", "--device", "cpu",
                            "--no-exploit-window", "--out", str(tmp_path / "d.json")]) == 0
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [ln["shape"] for ln in lines] == SHAPES
    assert all(ln["status"] == "ok" and ln["exploit_window"] is False for ln in lines)
    assert [ln["fits"] for ln in lines] == [False, True, True, True]
    saved = json.loads((tmp_path / "d.json").read_text())
    assert [r["shape"] for r in saved] == SHAPES
