"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc``
per source, all started together), holds each one against its plain
PyTorch version at the main paths' shapes and times both (the SDCA kernel
for each of its three losses, and at each cluster size that fits, beside
the serial floor its probe kernel measures, and with a worker map that
launches 4 of the 8 workers), then drives the
main paths through the port's entry points: at RCV1 width (d = 47,236) the
paper's ACPD loop, the CoCoA+ baseline and the Table-I message filter on the
workers' updates, and a short CoCoA+ run with the smoothed hinge on the same
data; the same ACPD and CoCoA+ runs through the protocol engine
(``run_method`` / ``Session``: one SDCA launch per worker group, deferred gap
evaluation), held to the loops' accounting and gaps, and a few rounds of
every other engine protocol and local solver at that width, each with the
launch count its rule predicts; each protocol on a small problem on the
card against the host; then batched greedy serving of qwen3-14b at full width and
depth (40 layers, bfloat16, random weights from a seed), whose prefill runs
every attention layer through the flash-attention kernel, and a check of
the prefill path against the decode path on the card. The whole-run
executor's phases (one captured CUDA graph per run) hold the kernel's
device worker map and per-row modes, each scan-capable protocol on the
small problem against the card's event engine bit for bit, CoCoA+, LAG,
partial_work and a gap-stopped CoCoA+ at RCV1 width (one capture for two
runs, launches by rule, the replay under sync debug mode "error"), the
``map`` and ``vmap`` sweeps, a killed and resumed checkpointed run, and
``python -m repro_torch run`` on a written spec. The experiment service's
phases (``service_*``) build the service's own problem at RCV1 width and
serve tenants through ``repro_torch.serve``: ``map`` and ``vmap`` waves of
CoCoA+ cells and LAG waves (a wave that differs only in gammas, or pads to
the same bucket, captures nothing), an ACPD request on the solo lane, waves
of new graph signatures past the executor's cache (``memory_reserved``), a
checkpointed run killed and resumed, the HTTP front end, a second service
under the ``chaos`` schedule (an overrun batch whose abandoned attempt runs
beside the solo lane, a transient retry, a NaN-poisoned LAG cell), and two
cluster replicas, one killed at a checkpoint segment and taken over; every
delivered stream is held to a solo ``Session`` on the card. It also checks that
the bfloat16 flash kernel was compiled to tensor-core (HGMMA) and TMA
instructions, and that one top-k filter call runs at most four kernels
without a host sync. Launch counts are zeroed just before each path and
read just after it. Every phase prints one
JSON line; any failure raises and the script exits non-zero. The last line
is the device summary ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository's ``src`` beside it; without
either it fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent

# The main path's shapes: RCV1's width, the paper's rho*d, H, B, T; n cut
# from RCV1's 677,399 to K * N_K = 32,768 rows because the layout stores X
# dense (6.2 GB of float32 here, 128 GB at full n).
K, N_K, D, H = 8, 4096, 47_236, 1000
B, T, RHO_D, GAMMA = 4, 20, 1000, 0.5
SEED, LAM = 7, 1e-3
COCOA_ROUNDS = 10
# The experiment service's own problem: RCV1's width, n cut to 1,024 rows a
# worker (1.55 GB of X) so that each of the service phases' builds is short.
SVC_N_K = 1024
# The engine's other protocols at RCV1 width: one outer round of T rounds
# for the group family, ENGINE_LOCKSTEP_ROUNDS for the CoCoA solvers; the
# worker map of the mapped-kernel check (B = 4 of the K = 8 workers).
ENGINE_LOCKSTEP_ROUNDS = 5
WORKER_MAP = [5, 2, 7, 0]
# Engine against loop on the card: the kernel splits d over C = 16 CTAs for
# the loop's one-worker launches and over C = 16 (B = 4) or C = 8 (K = 8) for
# the engine's, and the engine scores every snapshot by two batched products,
# so the gaps agree to float32 rounding, not bit for bit.
ENGINE_GAP_RTOL = 1e-4

# The serve path: qwen3-14b at full width and depth, batch 4, a 2048-token
# prompt, 16 generated tokens; the consistency check at the same width with
# 2 layers in float32.
SERVE_ARCH, SERVE_B, SERVE_PLEN, SERVE_GEN = "qwen3-14b", 4, 2048, 16
CONSIST_LAYERS = 2

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores (the type the SDCA and top-k
# kernels compute in), and bf16 FLOP/s of the tensor cores (the least time
# for the attention's products in the serve path's type).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

# The SDCA kernel's losses by their template argument.
SDCA_LOSSES = ("ridge", "smoothed_hinge", "logistic")
HINGE_ROUNDS = 3


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def time_ms(fn, *, warmup: int, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def errors(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """Max absolute error, and max relative error over entries above 1e-6."""
    diff = (got.double() - want.double()).abs()
    big = want.abs() > 1e-6
    rel = diff[big] / want.double().abs()[big]
    return float(diff.max()), float(rel.max()) if rel.numel() else 0.0


def ptxas_by_entry(log: pathlib.Path) -> dict[str, dict]:
    """Registers and spill bytes of each kernel in an ``nvcc -Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            inst = re.search(r"sdca_cluster_kernelILi(\d)ELi(\d+)E", name)
            if inst:
                name = f"sdca_cluster_kernel<{SDCA_LOSSES[int(inst[1])]}, M={inst[2]}>"
            probe = re.search(r"cluster_probe_kernelILb(\d)E", name)
            if probe:
                name = f"cluster_probe_kernel<{'st_async' if probe[1] == '1' else 'barrier'}>"
            out[name] = dict(registers=None, spill_bytes=0)
        elif name and "spill stores" in ln:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            out[name]["spill_bytes"] = nums[1] + nums[2]  # stack frame, stores, loads
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.api import problems
    from repro_torch.api.session import EvalEvent, RoundEvent, Session
    from repro_torch.core import acpd, baselines, engine, filter as msg_filter, objectives, sdca
    from repro_torch.core.simulate import ClusterModel
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import _build, ops, ref, sdca_inner as sdca_mod
    from repro_torch.kernels import topk_filter as topk_mod
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, model_spec, prefill
    from repro_torch.models.param import tree_materialize

    dev = torch.device("cuda")
    smi = nvidia_smi()
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         float32_matmul_precision=torch.get_float32_matmul_precision())

    # -- build: one nvcc per source, all started together --------------------
    t0 = time.perf_counter()
    sources = ("sdca_inner", "topk_filter", "flash_attn")
    _build.build(*sources)
    ptxas = {}
    for name in sources:
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln or "(C75" in ln
                       ] if log.exists() else []  # C75xx: wgmma serialized
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)
    # The bf16 flash kernel must run both products on wgmma (HGMMA in SASS)
    # and load by TMA (UTMALDG).
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = shutil.which("cuobjdump") or str(
        pathlib.Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "cuobjdump")
    if pathlib.Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(_build.library_path("flash_attn"))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
        utmaldg = sum("UTMALDG" in ln for ln in sass.splitlines())
        emit("flash_sass", cuobjdump=cuobjdump, hgmma_instructions=hgmma,
             tma_load_instructions=utmaldg, has_hgmma=hgmma > 0)
        check(hgmma > 0, "the flash library holds HGMMA instructions")
    else:
        emit("flash_sass", cuobjdump=None, has_hgmma=None, note="no cuobjdump on this machine")

    # -- the main problem: rcv1_like at RCV1 width, on the card --------------
    t0 = time.perf_counter()
    problem = problems.rcv1_like(K=K, d=D, n_per_worker=N_K, seed=SEED, nnz_per_row=24,
                                 lam=LAM, loss="ridge", device=dev)
    torch.cuda.synchronize()
    emit("problem", K=K, n_per_worker=N_K, d=D, X_gb=problem.X.numel() * 4 / 1e9,
         seconds=time.perf_counter() - t0)
    n = K * N_K
    norms = torch.sum(problem.X * problem.X, dim=-1)
    k_keep = msg_filter.num_kept(D, RHO_D / D)
    kernels: dict[str, dict] = {}

    # -- kernel 1: sdca_inner at K=8, n_k=4096, d=47236, H=1000 --------------
    # All three losses against their plain versions; ridge also at both
    # cluster sizes an H100 can hold all 8 workers of (C = 16 fits 7 at once),
    # beside the serial floor from the exchange probe.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, N_K, (K, H), generator=gen, device=dev, dtype=torch.int32)
    w_eff = 0.01 * torch.randn(K, D, generator=gen, device=dev)
    alpha = 0.01 * torch.randn(K, N_K, generator=gen, device=dev)
    # Dual-feasible for the classification losses: y * alpha in (0, 1).
    alpha_cls = problem.y * (0.05 + 0.55 * torch.rand(K, N_K, generator=gen, device=dev))
    sp = GAMMA * B
    plan = sdca_mod.plan(K, N_K, D)
    sdca_ptxas = ptxas_by_entry(_build.library_path("sdca_inner").with_suffix(".log"))
    rows = sum(int(torch.unique(idx[k]).numel()) for k in range(K))
    nbytes = (rows * D * 4 + K * D * 4 * 2 + K * N_K * 4 * 4 + K * H * 4)
    flops = 6 * D * H * K  # two dot products and one axpy per step
    bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
    by_loss = {}
    for loss in ("ridge", "smoothed_hinge", "logistic"):
        args = (w_eff, alpha if loss == "ridge" else alpha_cls, problem.X, problem.y, norms,
                LAM, n, sp, idx)
        da_k, v_k = ops.sdca_epoch(*args, loss=loss)
        da_r, v_r = ref.sdca_inner_ref(*args, loss=loss)
        torch.cuda.synchronize()
        da_abs, da_rel = errors(da_k, da_r)
        v_abs, v_rel = errors(v_k, v_r)
        da_2, v_2 = ops.sdca_epoch(*args, loss=loss)
        bitwise = bool(torch.equal(da_k, da_2) and torch.equal(v_k, v_2))
        ok = (torch.allclose(da_k, da_r, rtol=1e-4, atol=1e-5)
              and torch.allclose(v_k, v_r, rtol=1e-4, atol=1e-5))
        ms = time_ms(lambda: ops.sdca_epoch(*args, loss=loss), warmup=2, reps=10)
        plain_ms = time_ms(lambda: ref.sdca_inner_ref(*args, loss=loss), warmup=1,
                           reps=3 if loss == "ridge" else 1)
        by_loss[loss] = dict(ms=ms, plain_ms=plain_ms, us_per_step=ms * 1e3 / H,
                             max_abs_err=max(da_abs, v_abs), max_rel_err=max(da_rel, v_rel))
        emit("kernel_sdca_inner_check", loss=loss, shape=dict(K=K, n_k=N_K, d=D, H=H),
             dalpha_abs=da_abs, dalpha_rel=da_rel, v_abs=v_abs, v_rel=v_rel, rtol=1e-4,
             atol=1e-5, within=ok, repeat_bitwise=bitwise, ms=ms, plain_ms=plain_ms,
             us_per_step=ms * 1e3 / H)
        check(ok, f"sdca_inner ({loss}) within rtol 1e-4 / atol 1e-5 of its plain version")
        check(bitwise, f"sdca_inner ({loss}) repeats bit for bit")
        del da_k, v_k, da_r, v_r, da_2, v_2
    # The two cluster sizes that fit (below 8 a slice outgrows a CTA): the
    # kernel's ms, and the serial floor, H round trips of the kernel's
    # exchange (st.async) from the probe, beside those of DSMEM stores and
    # barrier.cluster.
    args = (w_eff, alpha, problem.X, problem.y, norms, LAM, n, sp, idx)
    by_cluster = {}
    for C in (16, 8):
        p_c = sdca_mod._plan_dict(K, N_K, D, C)
        ms_c = time_ms(lambda: sdca_mod._launch(*args, "ridge", p_c), warmup=2, reps=10)
        floor = {kind: time_ms(lambda: sdca_mod.exchange_probe(K, C, H, dev,
                                                               barrier=kind == "barrier"),
                               warmup=2, reps=10) for kind in ("st_async", "barrier")}
        by_cluster[C] = dict(ms=ms_c, us_per_step=ms_c * 1e3 / H, stages=p_c["stages"],
                             per_thread=p_c["per_thread"], ctas=p_c["ctas"],
                             active_clusters=p_c["active_clusters"],
                             smem_bytes=p_c["smem_bytes"], floor_ms=floor["st_async"],
                             round_trip_us=floor["st_async"] * 1e3 / H,
                             barrier_floor_ms=floor["barrier"],
                             barrier_round_trip_us=floor["barrier"] * 1e3 / H)
    ridge = by_loss["ridge"]
    kernels["sdca_inner"] = dict(
        name="sdca_inner", route="cuda", source="src/repro_torch/csrc/sdca_inner.cu",
        replaces="src/repro/kernels/sdca_inner.py:78", max_abs_err=max(
            r["max_abs_err"] for r in by_loss.values()),
        max_rel_err=max(r["max_rel_err"] for r in by_loss.values()), ms=ridge["ms"],
        plain_ms=ridge["plain_ms"], bound_ms=bound_ms,
        bound_by="bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32 else "operations",
        library_ms=None, cluster=plan["cluster"],
        ms_by_loss={loss: r["ms"] for loss, r in by_loss.items()})
    emit("kernel_sdca_inner", shape=dict(K=K, n_k=N_K, d=D, H=H), cluster=plan["cluster"],
         ctas=plan["ctas"], stages=plan["stages"], per_thread=plan["per_thread"],
         smem_bytes=plan["smem_bytes"],
         active_clusters=plan["active_clusters"], max_d=sdca_mod.max_d(N_K),
         by_loss=by_loss, by_cluster=by_cluster,
         serial_floor_ms=by_cluster[plan["cluster"]]["floor_ms"], bound_ms=bound_ms,
         unique_rows=rows, bound_bytes=nbytes, bound_flops=flops, ptxas=sdca_ptxas)
    check(plan["cluster"] > 1, "sdca_inner runs one cluster of several CTAs per worker")
    check(all(r["spill_bytes"] == 0 for r in sdca_ptxas.values()), "sdca_inner spills nothing")

    # -- kernel 1b: sdca_inner with a worker map (B = 4 of K = 8) -------------
    # The engine's group relaunch: 4 clusters on workers 5, 2, 7, 0's rows of
    # the full X. Against the plain version on the same map, bit for bit
    # against an unmapped launch on the gathered copy X[workers], and bit
    # for bit on repeat.
    Bw = len(WORKER_MAP)
    g = torch.tensor(WORKER_MAP, device=dev)
    gathered = (problem.X[g].contiguous(), problem.y[g].contiguous(), norms[g].contiguous())
    plan_w = sdca_mod.plan(Bw, N_K, D)
    w_map = w_eff[:Bw].contiguous()
    idx_w = idx[:Bw].contiguous()
    map_rows = {}
    for loss in SDCA_LOSSES:
        a_full = alpha if loss == "ridge" else alpha_cls
        args = (w_map, a_full, problem.X, problem.y, norms, LAM, n, sp, idx_w)
        da_k, v_k = ops.sdca_epoch(*args, loss=loss, workers=WORKER_MAP)
        da_r, v_r = ref.sdca_inner_ref(*args, loss=loss, workers=WORKER_MAP)
        da_g, v_g = ops.sdca_epoch(w_map, a_full[g].contiguous(), gathered[0], gathered[1],
                                   gathered[2], LAM, n, sp, idx_w, loss=loss)
        da_2, v_2 = ops.sdca_epoch(*args, loss=loss, workers=WORKER_MAP)
        torch.cuda.synchronize()
        da_abs, da_rel = errors(da_k, da_r)
        v_abs, v_rel = errors(v_k, v_r)
        ok = (torch.allclose(da_k, da_r, rtol=1e-4, atol=1e-5)
              and torch.allclose(v_k, v_r, rtol=1e-4, atol=1e-5))
        gathered_equal = bool(torch.equal(da_k, da_g) and torch.equal(v_k, v_g))
        bitwise = bool(torch.equal(da_k, da_2) and torch.equal(v_k, v_2))
        ms = time_ms(lambda: ops.sdca_epoch(*args, loss=loss, workers=WORKER_MAP), warmup=2,
                     reps=10)
        map_rows[loss] = dict(ms=ms, max_abs_err=max(da_abs, v_abs),
                              max_rel_err=max(da_rel, v_rel), within=ok,
                              equals_gathered=gathered_equal, repeat_bitwise=bitwise)
        check(ok, f"mapped sdca_inner ({loss}) within rtol 1e-4 / atol 1e-5 of its plain "
                  f"version")
        check(gathered_equal, f"mapped sdca_inner ({loss}) equals the unmapped launch on "
                              f"X[workers] bit for bit")
        check(bitwise, f"mapped sdca_inner ({loss}) repeats bit for bit")
        del da_k, v_k, da_r, v_r, da_g, v_g, da_2, v_2
    rows_w = sum(int(torch.unique(idx_w[b]).numel()) for b in range(Bw))
    nbytes_w = rows_w * D * 4 + Bw * D * 4 * 2 + Bw * N_K * 4 * 4 + Bw * H * 4
    flops_w = 6 * D * H * Bw
    bound_w = max(nbytes_w / PEAK_BYTES, flops_w / PEAK_F32) * 1e3
    emit("kernel_sdca_inner_workers", workers=WORKER_MAP, shape=dict(B=Bw, K=K, n_k=N_K, d=D,
                                                                     H=H),
         cluster=plan_w["cluster"], ctas=plan_w["ctas"], stages=plan_w["stages"],
         bound_ms=bound_w, by_loss=map_rows)
    kernels["sdca_inner"].update(
        ms_workers_map=map_rows["ridge"]["ms"], workers_map=WORKER_MAP,
        cluster_workers_map=plan_w["cluster"], bound_ms_workers_map=bound_w,
        max_abs_err=max(kernels["sdca_inner"]["max_abs_err"],
                        *(r["max_abs_err"] for r in map_rows.values())))
    # -- kernel 1c: the map modes of the whole-run executor and the sweeps --
    # (a) The same 4-of-8 map as an int32 tensor on the card: used as it is,
    # no host check or sync (the launch runs under sync debug mode "error"),
    # equal to the host map's launch bit for bit; a bad entry (8) writes
    # nothing and lands in the error word, which raises once it is read.
    # (b) V = 2 variants x K = 8 rows over the one X, alpha and sigma' read
    # per row, against two launches of the same cluster size bit for bit.
    dmap = torch.tensor(WORKER_MAP, dtype=torch.int32, device=dev)
    err = sdca_mod.map_error_word(dev)
    args_h = (w_map, alpha, problem.X, problem.y, norms, LAM, n, sp, idx_w)
    da_h, v_h = ops.sdca_epoch(*args_h, workers=WORKER_MAP)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        da_d, v_d = ops.sdca_epoch(*args_h, workers=dmap, map_error=err)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    device_equal = bool(torch.equal(da_d, da_h) and torch.equal(v_d, v_h))
    sdca_mod.raise_map_error(err, K)  # no bad entry: does not raise
    bad = torch.tensor([5, 2, 8, 0], dtype=torch.int32, device=dev)
    err_bad = sdca_mod.map_error_word(dev)
    ops.sdca_epoch(*args_h, workers=bad, map_error=err_bad)
    try:
        sdca_mod.raise_map_error(err_bad, K)
        bad_raised = ""
    except ValueError as e:
        bad_raised = str(e)
    V2 = 2
    sp2 = GAMMA * K
    alpha2 = torch.cat([alpha, 0.5 * alpha]).contiguous()
    w2 = torch.cat([w_eff, 0.5 * w_eff]).contiguous()
    idx2 = torch.cat([idx, idx.flip(1)]).contiguous()
    sig2 = torch.tensor([sp] * K + [sp2] * K, dtype=torch.float32, device=dev)
    wm2 = torch.arange(K, dtype=torch.int32, device=dev).repeat(V2)
    err2 = sdca_mod.map_error_word(dev)
    rows_args = (w2, alpha2, problem.X, problem.y, norms, LAM, n, 0.0, idx2)
    da_v, v_v = ops.sdca_epoch(*rows_args, workers=wm2, map_error=err2, alpha_rows=True,
                               sigma_rows=sig2)
    plan_v = sdca_mod.plan(V2 * K, N_K, D)
    same_c = sdca_mod._plan_dict(K, N_K, D, plan_v["cluster"])
    parts = [sdca_mod._launch(w2[i * K:(i + 1) * K].contiguous(),
                              alpha2[i * K:(i + 1) * K].contiguous(), problem.X, problem.y,
                              norms, LAM, n, s_, idx2[i * K:(i + 1) * K].contiguous(),
                              "ridge", same_c) for i, s_ in enumerate((sp, sp2))]
    rows_equal = bool(torch.equal(da_v, torch.cat([p_[0] for p_ in parts]))
                      and torch.equal(v_v, torch.cat([p_[1] for p_ in parts])))
    sdca_mod.raise_map_error(err2, K)
    ms_device = time_ms(lambda: ops.sdca_epoch(*args_h, workers=dmap, map_error=err),
                        warmup=2, reps=10)
    ms_host = time_ms(lambda: ops.sdca_epoch(*args_h, workers=WORKER_MAP), warmup=2, reps=10)
    ms_rows = time_ms(lambda: ops.sdca_epoch(*rows_args, workers=wm2, map_error=err2,
                                             alpha_rows=True, sigma_rows=sig2),
                      warmup=2, reps=10)
    emit("kernel_sdca_inner_device_map", workers=WORKER_MAP, equals_host_map=device_equal,
         host_sync=False, bad_entry_raised=bad_raised, variants=V2, rows=V2 * K,
         rows_cluster=plan_v["cluster"], rows_equal_two_launches=rows_equal,
         ms_device_map=ms_device, ms_host_map=ms_host, ms_rows=ms_rows)
    check(device_equal, "a device worker map equals the host map bit for bit")
    check("entry 8" in bad_raised, "a bad device map entry raises once its word is read")
    check(rows_equal, "per-row alpha and sigma' equal two launches bit for bit")
    kernels["sdca_inner"].update(ms_device_map=ms_device, ms_rows_2x8=ms_rows)
    del gathered, g, w_map, idx_w, alpha2, w2, idx2, da_v, v_v, parts, da_d, v_d, da_h, v_h
    torch.cuda.empty_cache()

    # -- kernel 2: topk_filter at d=47236, k=1000, float32 and bfloat16 ------
    worker_dw = sdca.solve_subproblem(
        torch.zeros(D, device=dev), torch.zeros(N_K, device=dev), problem.X[0],
        problem.y[0], norms[0], LAM, n, sp, torch.Generator(device=dev).manual_seed(1),
        loss="ridge", num_steps=H).v
    inputs = {"random": torch.randn(D, generator=gen, device=dev), "worker_dw": worker_dw}
    topk_err = 0.0
    for label, x32 in inputs.items():
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype).contiguous()
            sent, resid, mask = ops.topk_filter(x, k_keep)
            s_p, r_p, m_p = topk_mod.topk_filter_plain(x, k_keep)
            topk_err = max(topk_err, float((sent.float() - s_p.float()).abs().max()),
                           float((resid.float() - r_p.float()).abs().max()))
            mag = x.float().abs()
            kept_min = float(torch.where(mask, mag, torch.full_like(mag, math.inf)).min())
            drop_max = float(torch.where(mask, torch.zeros_like(mag), mag).max())
            s_ref, _, _ = ref.topk_filter_ref(x, k_keep)
            row = dict(
                input=label, dtype=str(dtype).removeprefix("torch."),
                mask_equal_plain=bool(torch.equal(mask, m_p)),
                outputs_equal_plain=bool(torch.equal(sent, s_p) and torch.equal(resid, r_p)),
                count=int(mask.sum()),
                count_want=min(k_keep, int((mag >= mag.max() * topk_mod.FLOOR).sum())),
                conserves=bool(torch.equal(sent + resid, x)),
                kept_min=kept_min, drop_max=drop_max,
                banded=kept_min >= drop_max * (1 - 6e-3) - 1e-6,
                mass_vs_exact=float(sent.float().abs().sum() / s_ref.float().abs().sum()))
            emit("kernel_topk_filter_check", **row)
            check(row["mask_equal_plain"] and row["outputs_equal_plain"],
                  f"topk_filter equals topk_filter_plain ({label}, {dtype})")
            check(row["count"] == row["count_want"] and row["conserves"] and row["banded"],
                  f"topk_filter contract ({label}, {dtype})")
    x = worker_dw.contiguous()
    # One call is at most four kernels, with no host sync between them.
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.topk_filter(x, k_keep)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ops.topk_filter(x, k_keep)
        torch.cuda.synchronize()
    topk_kernels = [e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA]
    emit("kernel_topk_filter_launches", kernels_per_call=len(topk_kernels),
         names=topk_kernels, host_sync=False)
    check(0 < len(topk_kernels) <= 4, f"one topk_filter call ran {len(topk_kernels)} kernels")
    ms = time_ms(lambda: ops.topk_filter(x, k_keep), warmup=5, reps=100)
    plain_ms = time_ms(lambda: topk_mod.topk_filter_plain(x, k_keep), warmup=3, reps=20)
    library_ms = time_ms(lambda: torch.topk(x.abs(), k_keep), warmup=5, reps=100)
    nbytes = D * 4 * 3 + D  # dw read; sent, residual (float32) and mask written
    flops = 2 * 64 * D  # two 64-edge histogram passes of comparisons
    kernels["topk_filter"] = dict(
        name="topk_filter", route="cuda", source="src/repro_torch/csrc/topk_filter.cu",
        replaces="src/repro/kernels/topk_filter.py:149", max_abs_err=topk_err,
        ms=ms, plain_ms=plain_ms, bound_ms=max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3,
        bound_by="bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32 else "operations",
        library_ms=library_ms)
    emit("kernel_topk_filter", d=D, k=k_keep, dtype="float32", ms=ms, plain_ms=plain_ms,
         library_ms=library_ms, library="torch.topk(|dw|, k)", kernels_per_call=len(topk_kernels),
         bound_ms=kernels["topk_filter"]["bound_ms"], bound_bytes=nbytes)
    del inputs, worker_dw, args, alpha_cls

    # -- small input: the card's run against the host's on the same orders ---
    small = {}
    for where in ("cpu", "cuda"):
        p = problems.rcv1_like(K=4, d=512, n_per_worker=64, device=where)
        small[where] = acpd.run_method_reference(
            p, baselines.acpd(4, 512, B=2, T=5, rho_d=32, H=64),
            ClusterModel(4, straggler_sigma=4.0), num_outer=2, seed=3, device=where,
            visit_orders=acpd.torch_visit_orders(64, 64, 3, torch.device("cpu")))
    acct = all((h.bytes_up, h.bytes_down, h.sim_time) == (c.bytes_up, c.bytes_down, c.sim_time)
               for h, c in zip(small["cpu"].records, small["cuda"].records))
    gap_err = max(abs(h.gap - c.gap) / abs(h.gap)
                  for h, c in zip(small["cpu"].records, small["cuda"].records))
    w_close = bool(np.allclose(small["cuda"].w, small["cpu"].w, rtol=1e-4, atol=1e-6))
    emit("small_parity", accounting_equal=acct, max_gap_rel_err=gap_err, w_allclose=w_close)
    check(acct and w_close and gap_err < 1e-4, "small run on the card agrees with the host")

    # -- the engine on the small input: each protocol, card against host -----
    small_methods = {
        "group": baselines.acpd(4, 512, B=2, T=5, rho_d=32, H=64),
        "sync": baselines.cocoa_plus(4, H=64),
        "async": baselines.acpd_async(4, 512, T=5, rho_d=32, H=64),
        "lag": baselines.acpd_lag(4, 512, B=2, T=5, rho_d=32, H=64, lag_window=3),
        "cocoa_importance": baselines.cocoa_v1(4, H=64, local_solver="importance"),
        "cocoa_plus_accelerated": baselines.cocoa_plus_solver(4, H=64,
                                                              local_solver="accelerated"),
        "adaptive_b": baselines.acpd_adaptive(4, 512, T=5, rho_d=32, H=64),
        "hierarchical_b": baselines.acpd_hierarchical(4, 512, T=5, rho_d=32, H=64),
        "partial_work": baselines.acpd_partial_work(4, 512, B=2, T=5, rho_d=32, H=64,
                                                    n_chunks=4),
    }
    parity = {}
    for name, m in small_methods.items():
        runs = {}
        for where in ("cpu", "cuda"):
            p = problems.rcv1_like(K=4, d=512, n_per_worker=64, device=where)
            runs[where] = acpd.run_method(p, m, ClusterModel(4, straggler_sigma=4.0),
                                          num_outer=2, seed=3, device=where,
                                          draws=sdca.TorchDraws(3, "cpu"))
        h, c = runs["cpu"], runs["cuda"]
        acct = len(h.records) == len(c.records) and all(
            (x.bytes_up, x.bytes_down, x.sim_time, x.compute_time, x.comm_time)
            == (y.bytes_up, y.bytes_down, y.sim_time, y.compute_time, y.comm_time)
            for x, y in zip(h.records, c.records))
        gap_err = max(abs(x.gap - y.gap) / abs(x.gap) for x, y in zip(h.records, c.records))
        w_close = bool(np.allclose(c.w, h.w, rtol=1e-4, atol=1e-6))
        parity[name] = dict(accounting_equal=acct, max_gap_rel_err=gap_err, w_allclose=w_close)
        check(acct and w_close and gap_err < 1e-4,
              f"engine {name} on the card agrees with the host")
    emit("engine_small_parity", rtol=1e-4, by_protocol=parity)

    launches: dict[str, dict[str, int]] = {}
    cluster = ClusterModel(K, straggler_sigma=10.0)

    # -- main path 1: ACPD (Algorithms 1 + 2) at RCV1 width ------------------
    method = baselines.acpd(K, D, B=B, T=T, rho_d=RHO_D, gamma=GAMMA, H=H)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = acpd.run_method_reference(problem, method, cluster, num_outer=1, seed=SEED,
                                    eval_every=1, device=dev)
    torch.cuda.synchronize()
    wall = acpd_wall = time.perf_counter() - t0
    launches["acpd"] = dict(ops.LAUNCHES)
    gaps = [r.gap for r in res.records]
    emit("acpd", method=method.name, B=B, T=T, rho=method.rho, gamma=GAMMA, H=H,
         rounds=len(res.records), gap_first=gaps[0], gap_last=gaps[-1], gaps=gaps,
         gap_server_last=res.records[-1].gap_server, bytes_up=res.records[-1].bytes_up,
         bytes_down=res.records[-1].bytes_down, sim_time=res.records[-1].sim_time,
         wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches["acpd"])
    want = K + (T - 1) * B + K
    check(launches["acpd"]["sdca_inner"] == want,
          f"ACPD launched sdca_inner {launches['acpd']['sdca_inner']} times, want {want}")
    check(all(math.isfinite(g) for g in gaps), "ACPD gaps are finite")
    check(gaps[-1] < gaps[0], "ACPD gap falls")

    # -- main path 2: CoCoA+ on the same problem -----------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_c = acpd.run_method_reference(problem, baselines.cocoa_plus(K, H=H), cluster,
                                      num_outer=COCOA_ROUNDS, seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = cocoa_wall = time.perf_counter() - t0
    launches["cocoa_plus"] = dict(ops.LAUNCHES)
    gaps_c = [r.gap for r in res_c.records]
    emit("cocoa_plus", rounds=len(gaps_c), gap_first=gaps_c[0], gap_last=gaps_c[-1],
         gaps=gaps_c, bytes_up=res_c.records[-1].bytes_up,
         sim_time=res_c.records[-1].sim_time, wall_s=wall, launches=launches["cocoa_plus"])
    check(launches["cocoa_plus"]["sdca_inner"] == COCOA_ROUNDS,
          f"CoCoA+ launched sdca_inner {launches['cocoa_plus']['sdca_inner']} times")
    check(all(math.isfinite(g) for g in gaps_c) and gaps_c[-1] < gaps_c[0],
          "CoCoA+ gaps are finite and fall")

    # -- main path 2b: CoCoA+ with the smoothed hinge on the same X ----------
    # The same +-1 labels and rows (no second 6.2 GB problem); the dual
    # starts at 0, which is feasible for the hinge.
    hinge = dataclasses.replace(problem, loss="smoothed_hinge")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res_h = acpd.run_method_reference(hinge, baselines.cocoa_plus(K, H=H), cluster,
                                      num_outer=HINGE_ROUNDS, seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["cocoa_plus_smoothed_hinge"] = dict(ops.LAUNCHES)
    gaps_h = [r.gap for r in res_h.records]
    emit("cocoa_plus_smoothed_hinge", loss=hinge.loss, rounds=len(gaps_h), gaps=gaps_h,
         wall_s=wall, launches=launches["cocoa_plus_smoothed_hinge"])
    check(launches["cocoa_plus_smoothed_hinge"]["sdca_inner"] == HINGE_ROUNDS,
          "the hinge CoCoA+ run launched sdca_inner once a round")
    check(all(math.isfinite(g) for g in gaps_h)
          and all(b < a for a, b in zip(gaps_h, gaps_h[1:])),
          "the hinge CoCoA+ gaps are finite and fall")
    del hinge, res_h

    # -- main path 3: the Table-I filter on the workers' next updates --------
    # One local round of all K workers from the ACPD run's final state
    # (Alg. 2 line 4), then each worker's update through the kernel filter
    # (lines 7-9), as benchmarks/bench_table1.py times the filter.
    ops.reset_launch_counts()
    w_srv = torch.as_tensor(res.w, device=dev)
    alpha_t = torch.as_tensor(res.alpha, device=dev)
    upd = sdca.solve_subproblem_all(
        w_srv.expand(K, D).contiguous(), alpha_t, problem.X, problem.y, norms, LAM, n,
        method.resolved_sigma_prime(K), torch.Generator(device=dev).manual_seed(SEED),
        loss="ridge", num_steps=H)
    filtered = [ops.topk_filter(upd.v[k].contiguous(), k_keep) for k in range(K)]
    torch.cuda.synchronize()
    launches["table1_filter"] = dict(ops.LAUNCHES)
    kept = [int(m.sum()) for _, _, m in filtered]
    want_kept = [min(k_keep, int((upd.v[k].abs() >= upd.v[k].abs().max() * topk_mod.FLOOR).sum()))
                 for k in range(K)]
    conserved = all(bool(torch.equal(s + r, upd.v[k])) for k, (s, r, _) in enumerate(filtered))
    emit("table1_filter", k=k_keep, kept=kept, conserved=conserved,
         wire_bytes=msg_filter.message_bytes(k_keep), dense_bytes=msg_filter.dense_bytes(D),
         launches=launches["table1_filter"])
    check(launches["table1_filter"]["topk_filter"] == K, "filter launched once per worker")
    check(launches["table1_filter"]["sdca_inner"] == 1, "one all-worker SDCA launch")
    check(conserved and kept == want_kept, "filtered updates keep min(k, #above floor), conserve dw")

    # -- main path 5: the protocol engine (run_method -> Session -> engine) --
    # ACPD as above through the engine, on the loop's visit-order stream: one
    # launch for the K first rounds, one per group of B arrivals (19), one
    # for the K workers of the sync round, against the loop's 92.
    def drive(session):
        """Drain a Session; returns its result, the host wall and the CUDA-event
        ms from the last round to the first deferred certificate."""
        n_rounds = session.proto.num_rounds(session.num_outer)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0, timed = time.perf_counter(), False
        for ev in session.events():
            if isinstance(ev, RoundEvent) and ev.iteration == n_rounds:
                torch.cuda.synchronize()
                e0.record()
            elif isinstance(ev, EvalEvent) and not timed:
                e1.record()
                timed = True
        torch.cuda.synchronize()
        return session.result(), time.perf_counter() - t0, e0.elapsed_time(e1)

    def gap_rel(a, b) -> float:
        return max(abs(x.gap - y.gap) / abs(y.gap) for x, y in zip(a.records, b.records))

    def same_accounting(a, b) -> bool:
        fields = ("iteration", "bytes_up", "bytes_down", "sim_time")
        return len(a.records) == len(b.records) and all(
            [getattr(x, f) for f in fields] == [getattr(y, f) for f in fields]
            for x, y in zip(a.records, b.records))

    drive(Session(problem, method, cluster, num_outer=1, seed=SEED, device=dev))  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    res_e, wall, eval_ms = drive(Session(
        problem, method, cluster, num_outer=1, seed=SEED, eval_every=1, device=dev,
        draws=sdca.StreamDraws(acpd.torch_visit_orders(N_K, H, SEED, dev))))
    launches["engine_acpd"] = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 1e9
    gaps_e = [r.gap for r in res_e.records]
    # The batched evaluation alone at S = 20 snapshots, against one
    # certificate of the loops (gap_certificate) times 20.
    snaps_w = torch.stack([torch.as_tensor(res_e.w, device=dev)] * T)
    snaps_a = torch.stack([torch.as_tensor(res_e.alpha_applied, device=dev)] * T)
    eval_batched_ms = time_ms(lambda: engine._eval_batched(snaps_w, snaps_a, problem),
                              warmup=1, reps=5)
    cert_ms = time_ms(lambda: objectives.gap_certificate(problem, snaps_a[0], w=snaps_w[0]),
                      warmup=1, reps=3)
    emit("engine_acpd", method=method.name, executor="event", eval_mode="batched",
         rounds=len(gaps_e), gaps=gaps_e, gap_first=gaps_e[0], gap_last=gaps_e[-1],
         bytes_up=res_e.records[-1].bytes_up, bytes_down=res_e.records[-1].bytes_down,
         sim_time=res_e.records[-1].sim_time, wall_s=wall, loop_wall_s=acpd_wall,
         peak_mem_gb=peak, launches=launches["engine_acpd"],
         loop_launches=launches["acpd"]["sdca_inner"], deferred_eval_ms=eval_ms,
         eval_batched_ms_20=eval_batched_ms, gap_certificate_ms=cert_ms,
         accounting_equal_loop=same_accounting(res_e, res),
         max_gap_rel_vs_loop=gap_rel(res_e, res), gap_rtol=ENGINE_GAP_RTOL)
    want_e = 1 + (T - 1) + 1
    check(launches["engine_acpd"]["sdca_inner"] == want_e,
          f"engine ACPD launched sdca_inner {launches['engine_acpd']['sdca_inner']} times, "
          f"want {want_e}")
    check(same_accounting(res_e, res), "engine ACPD's bytes and clock equal the loop's")
    check(gap_rel(res_e, res) < ENGINE_GAP_RTOL, "engine ACPD's gaps agree with the loop's")
    check(all(math.isfinite(x) for x in gaps_e) and gaps_e[-1] < gaps_e[0],
          "engine ACPD gaps are finite and fall")
    del snaps_w, snaps_a

    # -- main path 5b: CoCoA+ through the engine (one launch a round) --------
    ops.reset_launch_counts()
    res_ec, wall, eval_ms = drive(Session(
        problem, baselines.cocoa_plus(K, H=H), cluster, num_outer=COCOA_ROUNDS, seed=SEED,
        device=dev, executor="event",
        draws=sdca.StreamDraws(acpd.torch_visit_orders(N_K, H, SEED, dev))))
    launches["engine_cocoa_plus"] = dict(ops.LAUNCHES)
    gaps_ec = [r.gap for r in res_ec.records]
    emit("engine_cocoa_plus", rounds=len(gaps_ec), gaps=gaps_ec, wall_s=wall,
         loop_wall_s=cocoa_wall, deferred_eval_ms=eval_ms,
         launches=launches["engine_cocoa_plus"],
         accounting_equal_loop=same_accounting(res_ec, res_c),
         max_gap_rel_vs_loop=gap_rel(res_ec, res_c), gap_rtol=ENGINE_GAP_RTOL)
    check(launches["engine_cocoa_plus"]["sdca_inner"] == COCOA_ROUNDS,
          "engine CoCoA+ launched sdca_inner once a round")
    check(same_accounting(res_ec, res_c), "engine CoCoA+'s bytes and clock equal the loop's")
    check(gap_rel(res_ec, res_c) < ENGINE_GAP_RTOL, "engine CoCoA+'s gaps agree with the loop's")

    # -- main path 5c: every other engine protocol and solver at RCV1 width --
    # Launches by each rule: the group family one for the first K rounds and
    # one per round (every round relaunches its arrivals); partial_work one
    # per chunk of each of those waves; the lockstep solvers one a round,
    # accelerated one per inner round (4).
    others = {
        "async": (baselines.acpd_async(K, D, T=T, rho_d=RHO_D, gamma=GAMMA, H=H), 1),
        "lag": (baselines.acpd_lag(K, D, B=B, T=T, rho_d=RHO_D, gamma=GAMMA, H=H), 1),
        "adaptive_b": (baselines.acpd_adaptive(K, D, T=T, rho_d=RHO_D, gamma=GAMMA, H=H), 1),
        "hierarchical_b": (baselines.acpd_hierarchical(K, D, T=T, rho_d=RHO_D, gamma=GAMMA,
                                                       H=H), 1),
        "partial_work": (baselines.acpd_partial_work(K, D, B=B, T=T, rho_d=RHO_D, gamma=GAMMA,
                                                     H=H, n_chunks=4), 4),
        "cocoa_importance": (baselines.cocoa_v1(K, H=H, local_solver="importance"), 1),
        "cocoa_accelerated": (baselines.cocoa_v1(K, H=H, local_solver="accelerated"), 4),
    }
    by_protocol = {}
    for name, (m, per_wave) in others.items():
        lockstep = m.protocol in ("cocoa", "cocoa_plus", "sync")
        ops.reset_launch_counts()
        r, wall, eval_ms = drive(Session(problem, m, cluster,
                                         num_outer=ENGINE_LOCKSTEP_ROUNDS if lockstep else 1,
                                         seed=SEED, device=dev, executor="event"))
        launches[f"engine_{name}"] = dict(ops.LAUNCHES)
        rounds = len(r.records)
        want = per_wave * (rounds if lockstep else 1 + rounds)
        gaps_p = [x.gap for x in r.records]
        by_protocol[name] = dict(protocol=m.protocol, local_solver=m.local_solver,
                                 rounds=rounds, launches=ops.LAUNCHES["sdca_inner"],
                                 launches_want=want, gap_first=gaps_p[0], gap_last=gaps_p[-1],
                                 bytes_up=r.records[-1].bytes_up,
                                 sim_time=r.records[-1].sim_time, wall_s=wall,
                                 deferred_eval_ms=eval_ms)
        check(ops.LAUNCHES["sdca_inner"] == want,
              f"engine {name} launched sdca_inner {ops.LAUNCHES['sdca_inner']} times, "
              f"want {want}")
        check(all(math.isfinite(x) for x in gaps_p), f"engine {name} gaps are finite")
    emit("engine_protocols", shape=dict(K=K, n_k=N_K, d=D, H=H), by_protocol=by_protocol)

    # -- the whole-run executor: one captured CUDA graph per run -------------
    from repro_torch.api import sweep as sweep_lib
    from repro_torch.core import executor

    def records_equal(a, b) -> bool:
        return len(a.records) == len(b.records) and all(
            dataclasses.asdict(x) == dataclasses.asdict(y) for x, y in zip(a.records, b.records))

    def accounting_equal(a, b) -> bool:
        fields = ("iteration", "bytes_up", "bytes_down", "sim_time", "compute_time",
                  "comm_time")
        return len(a.records) == len(b.records) and all(
            [getattr(x, f) for f in fields] == [getattr(y, f) for f in fields]
            for x, y in zip(a.records, b.records))

    def state_equal(a, b) -> bool:
        return bool(np.array_equal(a.w, b.w) and np.array_equal(a.alpha, b.alpha)
                    and (a.alpha_applied is None) == (b.alpha_applied is None)
                    and (a.alpha_applied is None
                         or np.array_equal(a.alpha_applied, b.alpha_applied)))

    def profiled(fn):
        """(wall s, device busy ms or None) of fn() under torch.profiler: the
        kernels' summed device time; None when the trace shows no kernel."""
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ = time.perf_counter() - t0
        busy = sum(e.device_time for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        return wall_, (busy if busy > 0 else None)

    # Small problem: each scan-capable protocol, a vector-sampled delay and
    # constant; on the card the executor equals the event engine bit for
    # bit, and the host's executor within rtol 1e-4.
    scan_small = {
        "sync": baselines.cocoa_plus(4, H=64),
        "cocoa_importance": baselines.cocoa_v1(4, H=64, local_solver="importance"),
        "cocoa_plus_accelerated": baselines.cocoa_plus_solver(4, H=64,
                                                              local_solver="accelerated"),
        "lag": baselines.acpd_lag(4, 512, B=2, T=5, rho_d=32, H=64, lag_window=3),
        "partial_work": baselines.acpd_partial_work(4, 512, B=2, T=5, rho_d=32, H=64,
                                                    n_chunks=4),
    }
    small_p = {where: problems.rcv1_like(K=4, d=512, n_per_worker=64, device=where)
               for where in ("cpu", "cuda")}
    scan_parity = {}
    for delay in ("constant", "pareto"):
        cl4 = ClusterModel(4, straggler_sigma=4.0, delay_model=delay)
        for name, m in scan_small.items():
            runs = {}
            for where, ex in (("cuda", "event"), ("cuda", "scan"), ("cpu", "scan")):
                runs[(where, ex)] = Session(
                    small_p[where], m, cl4, num_outer=2 if m.protocol in ("lag",
                                                                           "partial_work")
                    else 6, seed=3, executor=ex, device=where,
                    draws=sdca.TorchDraws(3, "cpu")).run()
            ce, cs, hs = runs[("cuda", "event")], runs[("cuda", "scan")], runs[("cpu", "scan")]
            row = dict(records_equal_event=records_equal(cs, ce),
                       state_equal_event=state_equal(cs, ce),
                       accounting_equal_host=accounting_equal(cs, hs),
                       max_gap_rel_host=gap_rel(cs, hs),
                       w_allclose_host=bool(np.allclose(cs.w, hs.w, rtol=1e-4, atol=1e-6)))
            scan_parity[f"{name}/{delay}"] = row
            check(row["records_equal_event"] and row["state_equal_event"],
                  f"scan {name} ({delay}) on the card equals the card's event run")
            check(row["accounting_equal_host"] and row["w_allclose_host"]
                  and row["max_gap_rel_host"] < 1e-4,
                  f"scan {name} ({delay}) on the card agrees with the host's")
    emit("scan_small_parity", rtol=1e-4, by_cell=scan_parity)
    del small_p

    # At RCV1 width: two runs each; the second replays the first's graph
    # under sync debug mode "error". Launches by the event engine's rule.
    def scan_phase(name, m, num_outer, want_launches, *, target_gap=None):
        stat = {"lag": "lag", "partial_work": "partial"}.get(
            m.protocol, "lockstep_gap" if target_gap is not None else "lockstep")
        kw = dict(num_outer=num_outer, seed=SEED, device=dev, target_gap=target_gap)
        Session(problem, m, cluster, executor="event", **kw).run()  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        event = Session(problem, m, cluster, executor="event", **kw).run()
        torch.cuda.synchronize()
        event_wall = time.perf_counter() - t0
        executor.clear_cache()  # the phase's first run captures
        executor.reset_stats()
        t0 = time.perf_counter()
        first = Session(problem, m, cluster, executor="scan", **kw).run()
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - t0
        ops.reset_launch_counts()
        executor.REPLAY_SYNC_DEBUG = "error"
        try:
            t0 = time.perf_counter()
            second = Session(problem, m, cluster, executor="scan", **kw).run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            executor.REPLAY_SYNC_DEBUG = 0
        launches[f"scan_{name}"] = dict(ops.LAUNCHES)
        n_launched = ops.LAUNCHES["sdca_inner"]
        captures = executor.STATS[f"{stat}_traces"]
        calls = executor.STATS[f"{stat}_calls"]
        graph = executor.last_graph(stat)
        event_wall_p, event_busy = profiled(lambda: Session(problem, m, cluster,
                                                            executor="event", **kw).run())
        scan_wall, busy = profiled(lambda: Session(problem, m, cluster, executor="scan",
                                                   **kw).run())
        row = dict(protocol=m.protocol, rounds=len(second.records), captures=captures,
                   runs=calls, launches=n_launched,
                   launches_want=want_launches, graph_launches=dict(graph.launches),
                   capture_ms=graph.capture_ms, first_run_wall_s=first_wall,
                   replay_wall_s=wall, event_wall_s=event_wall,
                   scan_wall_profiled_s=scan_wall, device_busy_ms=busy,
                   device_idle_share=(None if busy is None
                                      else 1.0 - busy / (scan_wall * 1e3)),
                   event_wall_profiled_s=event_wall_p,
                   event_device_idle_share=(None if event_busy is None
                                            else 1.0 - event_busy / (event_wall_p * 1e3)),
                   accounting_equal_event=accounting_equal(second, event),
                   records_equal_event=records_equal(second, event),
                   state_equal_event=state_equal(second, event),
                   repeat_equal=records_equal(first, second) and state_equal(first, second),
                   gaps=[r.gap for r in second.records])
        emit(f"scan_{name}", shape=dict(K=K, n_k=N_K, d=D, H=H), host_sync_in_replay=False,
             **row)
        check(captures == 1 and calls == 2, f"scan {name}: one capture for two runs "
                                            f"({captures} captures, {calls} runs)")
        check(n_launched == want_launches,
              f"scan {name} launched sdca_inner {n_launched} times, want {want_launches}")
        check(row["accounting_equal_event"], f"scan {name}'s accounting equals the event "
                                             f"engine's")
        check(row["repeat_equal"], f"scan {name} repeats bit for bit")
        check(all(math.isfinite(x) for x in row["gaps"]), f"scan {name} gaps are finite")
        return second, event, row

    cocoa = baselines.cocoa_plus(K, H=H)
    scan_c, _, _ = scan_phase("cocoa_plus", cocoa, COCOA_ROUNDS, COCOA_ROUNDS)
    lag_m = baselines.acpd_lag(K, D, B=B, T=T, rho_d=RHO_D, gamma=GAMMA, H=H)
    scan_phase("lag", lag_m, 1, 1 + T)
    pw_m = baselines.acpd_partial_work(K, D, B=B, T=T, rho_d=RHO_D, gamma=GAMMA, H=H,
                                       n_chunks=4)
    scan_phase("partial_work", pw_m, 1, 4 * (1 + T))
    # target_gap between the plain run's gaps of rounds 5 and 6; the graph
    # runs all rounds (compute-and-mask) and its records stop where the
    # event loop's do, at round 6.
    target = 0.5 * (scan_c.records[4].gap + scan_c.records[5].gap)
    g_scan, g_event, g_row = scan_phase("gap", cocoa, COCOA_ROUNDS, COCOA_ROUNDS,
                                        target_gap=target)
    check(g_row["records_equal_event"] and len(g_scan.records) == 6,
          "the gap run stops at the event loop's round with its records")

    # -- sweeps: 2 seeds x 2 gammas (lag: x 2 delay models) in one graph -----
    def sweep_phase(name, m, num_outer, delays, launches_vmap):
        grid = dict(num_outer=num_outer, seeds=(SEED, SEED + 1), gammas=(GAMMA, 1.0),
                    delays=delays)
        out = {}
        for batch in ("map", "vmap"):
            sweep_lib.run_sweep(problem, m, cluster, batch=batch, **grid)  # capture
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out[batch] = sweep_lib.run_sweep(problem, m, cluster, batch=batch, **grid)
            torch.cuda.synchronize()
            out[f"{batch}_wall_s"] = time.perf_counter() - t0
            out[f"{batch}_launches"] = ops.LAUNCHES["sdca_inner"]
            launches[f"sweep_{name}_{batch}"] = dict(ops.LAUNCHES)
        solo_equal, rel = True, 0.0
        solo_wall = 0.0
        for a, b in zip(out["map"], out["vmap"]):
            cl_v = dataclasses.replace(cluster, delay_model=a.delay, delay_params=())
            t0 = time.perf_counter()
            solo = Session(problem, a.result.method, cl_v, num_outer=num_outer, seed=a.seed,
                           executor="scan", device=dev).run()
            solo_wall += time.perf_counter() - t0
            solo_equal &= records_equal(solo, a.result) and state_equal(solo, a.result)
            rel = max(rel, gap_rel(b.result, a.result),
                      float(np.max(np.abs(b.result.w - a.result.w))
                            / np.max(np.abs(a.result.w))))
        cells = len(out["map"])
        row = dict(cells=cells, rounds=len(out["map"][0].rounds),
                   map_wall_s=out["map_wall_s"], vmap_wall_s=out["vmap_wall_s"],
                   solo_scan_wall_s=solo_wall, map_launches=out["map_launches"],
                   vmap_launches=out["vmap_launches"], vmap_launches_want=launches_vmap,
                   map_equals_solo=solo_equal, vmap_max_rel_vs_map=rel)
        emit(f"sweep_{name}", shape=dict(K=K, n_k=N_K, d=D, H=H), **row)
        check(solo_equal, f"sweep {name} map cells equal their solo scan runs bit for bit")
        check(out["vmap_launches"] == launches_vmap,
              f"sweep {name} vmap launched {out['vmap_launches']}, want {launches_vmap}")
        check(rel < 1e-4, f"sweep {name} vmap within rtol 1e-4 of map ({rel})")

    sweep_phase("cocoa_plus", cocoa, COCOA_ROUNDS, None, COCOA_ROUNDS)
    sweep_phase("lag", lag_m, 1, ("constant", "shifted_exponential"), 1 + T)

    # -- checkpoint: CoCoA+ in segments of 5, killed after one, resumed -----
    import tempfile

    class Killed(Exception):
        pass

    def kill_after_first(start):
        if start > 0:
            raise Killed(start)

    with tempfile.TemporaryDirectory() as cdir:
        ops.reset_launch_counts()
        killed = False
        try:
            Session(problem, cocoa, cluster, num_outer=COCOA_ROUNDS, seed=SEED, device=dev,
                    checkpoint_dir=cdir, checkpoint_every=5,
                    _segment_hook=kill_after_first).run()
        except Killed:
            killed = True
        resumed = Session(problem, cocoa, cluster, num_outer=COCOA_ROUNDS, seed=SEED,
                          device=dev, checkpoint_dir=cdir, checkpoint_every=5).run()
        launches["checkpoint"] = dict(ops.LAUNCHES)
    unbroken = Session(problem, cocoa, cluster, num_outer=COCOA_ROUNDS, seed=SEED,
                       executor="scan", device=dev).run()
    ck_equal = records_equal(resumed, unbroken) and state_equal(resumed, unbroken)
    emit("checkpoint", every=5, rounds=COCOA_ROUNDS, killed_after_first=killed,
         resumed_equals_unbroken=ck_equal, launches=launches["checkpoint"])
    check(killed and ck_equal, "the resumed checkpointed run equals the unbroken one")
    check(launches["checkpoint"]["sdca_inner"] == COCOA_ROUNDS,
          "the two halves launched sdca_inner once a round")

    # -- cli: python -m repro_torch run on a written spec, on the card -------
    from repro_torch.api import ExperimentSpec, MethodEntry, ProblemSpec

    cli_spec = ExperimentSpec(
        name="chip-cli", problem=ProblemSpec("rcv1_like", {"K": 4, "d": 2048}),
        cluster=ClusterModel(4, straggler_sigma=4.0),
        methods=(MethodEntry(baselines.cocoa_plus(4, H=256), 4),
                 MethodEntry(baselines.acpd_lag(4, 2048, B=2, T=5, rho_d=64, H=256), 1)),
        eval_every=2)
    with tempfile.TemporaryDirectory() as tmp:
        spec_path = pathlib.Path(tmp) / "spec.json"
        cli_spec.save(spec_path)
        env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch", "run", str(spec_path),
                               "--out", str(pathlib.Path(tmp) / "out.json")],
                              capture_output=True, text=True, timeout=300, env=env,
                              cwd=ROOT)
        cli_wall = time.perf_counter() - t0
        prov = (json.loads((pathlib.Path(tmp) / "out.json").read_text())["provenance"]
                if proc.returncode == 0 else None)
    emit("cli", returncode=proc.returncode, wall_s=cli_wall, provenance=prov,
         executors=[ln.split("executor=")[1].rstrip(") =") for ln in proc.stdout.splitlines()
                    if "executor=" in ln],
         stdout_tail=proc.stdout.splitlines()[-3:], stderr_tail=proc.stderr[-400:])
    check(proc.returncode == 0 and prov is not None and prov["device"].startswith("cuda"),
          "python -m repro_torch run ran the spec on the card")

    # Free the ACPD problem (6.2 GB of X) and the captured graphs' memory
    # before the model's 29.5 GB (gc: objects in reference cycles hold some).
    import gc

    executor.clear_cache()
    del problem, norms, upd, filtered, w_srv, alpha_t, res, res_c, idx, w_eff, alpha
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 5: the experiment service (repro_torch.serve) -------------
    # The service builds its own problem, n cut to SVC_N_K rows a worker (1.55
    # GB of X) so that each service's build stays short. Tenants' CoCoA+ and
    # LAG specs coalesce into sweep batches (one captured graph per batch
    # signature), ACPD rides the solo lane; every delivered stream is held
    # to a solo Session on the card (bit for bit under map, 1e-5 under vmap).
    import threading
    import urllib.request

    import repro_torch.serve.service as svc_mod
    from repro_torch import serve as svc_lib
    from repro_torch.core import faults

    svc_problem = ProblemSpec("rcv1_like", {"K": K, "d": D, "n_per_worker": SVC_N_K,
                                            "seed": SEED})

    def svc_spec(name, method, *, seed, sigma=10.0, num_outer=COCOA_ROUNDS,
                 delay="constant", params=None, **kw):
        return ExperimentSpec(
            name=name, problem=svc_problem,
            cluster=ClusterModel(K, straggler_sigma=sigma, delay_model=delay,
                                 delay_params=tuple((params or {}).items())),
            methods=(MethodEntry(method, num_outer),), eval_every=1, seed=seed, **kw)

    def cocoa_at(gamma):
        return baselines.cocoa_plus_solver(K, H=H, gamma=gamma)  # sigma' = gamma * K

    def lag_at(gamma):
        return baselines.acpd_lag(K, D, B=B, T=T, rho_d=RHO_D, gamma=gamma, H=H)

    def policy(batch="map", max_wait_s=0.0):
        return svc_lib.CoalescePolicy(max_batch=16, max_wait_s=max_wait_s,
                                      max_tenant_depth=8, batch=batch, shard="none")

    solos: dict[str, tuple] = {}

    def solo_of(spec):
        """(events, result, wall s) of the spec's solo Session on the card, on
        the reference problem (every service's build is the same data)."""
        spec = dataclasses.replace(spec, checkpoint_every=None)
        key = spec.to_json()
        if key not in solos:
            entry = spec.methods[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sess = Session(svc_prob, entry.config, spec.cluster, num_outer=entry.num_outer,
                           seed=spec.seed, eval_every=spec.eval_every, executor=spec.executor,
                           device=dev)
            events = list(sess.events())
            torch.cuda.synchronize()
            solos[key] = (events, sess.result(), time.perf_counter() - t0)
        return solos[key]

    def close_to(events, result, spec, rtol=1e-5):
        """vmap: the event types and every accounting field equal, the
        certificates and w within rtol of the solo run."""
        s_events, s_res, _ = solo_of(spec)
        if [type(e) for e in events] != [type(e) for e in s_events]:
            return False
        for a, b in zip(events, s_events):
            fa, fb = dataclasses.asdict(a), dataclasses.asdict(b)
            for f in ("gap", "gap_server", "primal", "dual"):
                if f in fa and abs(fa.pop(f) - fb[f]) > rtol * abs(fb.pop(f)):
                    return False
            if fa != fb:
                return False
        return float(np.max(np.abs(result.w - s_res.w))) <= rtol * float(
            np.max(np.abs(s_res.w)))

    def run_wave(svc, name, items, *, want_captures=None, want_launches=None,
                 want_errors=None, compare=True):
        """Submit ``items`` ((tenant, spec)), drain, and hold every stream to
        its solo run (unless not ``compare``); ``want_errors`` maps an item to
        the typed error it must end in. Returns the wave's row."""
        batch = svc.policy.batch
        proto = items[0][1].methods[0].config.protocol
        stat = "sweep_lag" if proto == "lag" else "sweep"
        traces0, calls0 = executor.STATS[f"{stat}_traces"], executor.STATS[f"{stat}_calls"]
        cache0, counters0 = svc.compile_cache.stats(), dict(svc.counters)
        got: dict[int, tuple] = {}

        def consume(i, h, t_sub):
            events, first, err = [], None, None
            try:
                for ev in h.events():
                    first = time.perf_counter() if first is None else first
                    events.append(ev)
            except Exception as e:  # the typed outcome is checked below
                err = e
            got[i] = (h, events, err, None if first is None else first - t_sub,
                      time.perf_counter() - t_sub)

        torch.cuda.synchronize()
        ops.reset_launch_counts()
        consumers = []
        for i, (tenant, spec) in enumerate(items):
            t_sub = time.perf_counter()
            consumers.append(threading.Thread(target=consume,
                                              args=(i, svc.submit(tenant, spec), t_sub)))
            consumers[-1].start()
        t0 = time.perf_counter()
        svc.drain()
        torch.cuda.synchronize()
        wall_ = time.perf_counter() - t0
        for th in consumers:
            th.join()
        # An attempt abandoned at its deadline runs on to its end on its own
        # thread: join it, so that the wave's count holds its launches.
        for th in threading.enumerate():
            if th.name.startswith("deadline-batch"):
                th.join()
        launches[f"service_{name}"] = dict(ops.LAUNCHES)
        outcomes, all_ok = [], True
        for i, (tenant, spec) in enumerate(items):
            h, events, err, first_s, stop_s = got[i]
            want = (want_errors or {}).get(i)
            if want is not None or err is not None:
                ok = want is not None and isinstance(err, want)
            elif not compare:
                ok = True
            elif batch == "vmap" and proto != "group":
                ok = close_to(events, h.result(), spec)
            else:
                s_events, s_res, _ = solo_of(spec)
                ok = events == s_events and state_equal(h.result(), s_res)
            all_ok &= ok
            outcomes.append(dict(tenant=tenant, seed=spec.seed,
                                 gamma=spec.methods[0].config.gamma,
                                 outcome="delivered" if err is None else type(err).__name__,
                                 as_expected=ok, submit_to_first_event_s=first_s,
                                 submit_to_stop_s=stop_s))
        cache1 = svc.compile_cache.stats()
        row = dict(wave=name, batch=batch, protocol=proto, tenants=len(items), wall_s=wall_,
                   solo_wall_sum_s=(sum(solo_of(s)[2] for _, s in items) if compare
                                    else None),
                   captures=executor.STATS[f"{stat}_traces"] - traces0,
                   runs=executor.STATS[f"{stat}_calls"] - calls0,
                   cache_hits=cache1["hits"] - cache0["hits"],
                   cache_misses=cache1["misses"] - cache0["misses"],
                   counters={k: v - counters0[k] for k, v in svc.counters.items()
                             if v != counters0[k]},
                   sdca_launches=launches[f"service_{name}"]["sdca_inner"],
                   memory_reserved_gb=torch.cuda.memory_reserved() / 1e9,
                   memory_allocated_gb=torch.cuda.memory_allocated() / 1e9,
                   all_as_expected=all_ok, by_tenant=outcomes)
        check(all_ok, f"service wave {name}: every stream is what its solo run says")
        if want_captures is not None:
            check(row["captures"] == want_captures,
                  f"service wave {name}: {row['captures']} captures, want {want_captures}")
            check(row["cache_misses"] == want_captures
                  and row["cache_hits"] == row["runs"] - want_captures,
                  f"service wave {name}: the cache mirror agrees with the captures")
        if want_launches is not None:
            check(row["sdca_launches"] == want_launches,
                  f"service wave {name}: {row['sdca_launches']} launches, want {want_launches}")
        return row

    # service_coalesce: map and vmap waves of 8, 3 and 4 CoCoA+ cells, two LAG
    # waves, one ACPD request on the solo lane; the second wave of each pair
    # differs from the first only in seeds and gammas (4 cells against 3: one
    # padded bucket), so it captures nothing.
    ck_dir = tempfile.TemporaryDirectory()
    svc = svc_lib.ExperimentService(policy(), checkpoint_dir=ck_dir.name, device=dev)
    t0 = time.perf_counter()
    svc_prob = svc._problem_for(svc_spec("build", cocoa_at(1.0), seed=0))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    # -- kernel 1d: sdca_inner at the service's shapes (n_k = SVC_N_K) ------
    # The launches the service's paths make, each against the plain version
    # on the same inputs (rtol 1e-4 / atol 1e-5, as kernel 1): the K-row
    # launch of every solo lockstep run and map cell (sigma' per row), the
    # 64-row launch of a vmap wave of 8 cells (device worker map, alpha and
    # sigma' per row, four sigma's), and the B-row launch of a LAG cell
    # (device worker map, sigma' per row).
    svc_norms = torch.sum(svc_prob.X * svc_prob.X, dim=-1)
    g_svc = torch.Generator(device=dev).manual_seed(SEED + 1)
    sig_cells = [g_ * K for g_ in (0.25, 0.5, 0.75, 1.0)] * 2  # cocoa_plus: gamma * K
    svc_cases = {
        "solo_map_8rows": (K, None, False, torch.full((K,), sig_cells[1], device=dev)),
        "vmap_64rows": (8 * K, torch.arange(K, dtype=torch.int32, device=dev).repeat(8), True,
                        torch.tensor(sig_cells, device=dev).repeat_interleave(K)),
        "lag_4rows": (B, torch.tensor(WORKER_MAP, dtype=torch.int32, device=dev), False,
                      torch.full((B,), 0.5 * B, device=dev)),
    }
    svc_rows = {}
    for case, (Bc, wmap, a_rows, sig_rows) in svc_cases.items():
        w_c = 0.01 * torch.randn(Bc, D, generator=g_svc, device=dev)
        a_c = 0.01 * torch.randn(Bc if a_rows else K, SVC_N_K, generator=g_svc, device=dev)
        idx_c = torch.randint(0, SVC_N_K, (Bc, H), generator=g_svc, device=dev,
                              dtype=torch.int32)
        err_c = sdca_mod.map_error_word(dev)
        args = (w_c, a_c, svc_prob.X, svc_prob.y, svc_norms, svc_prob.lam, svc_prob.n, 0.0,
                idx_c)
        kw = dict(loss=svc_prob.loss, workers=wmap, alpha_rows=a_rows, sigma_rows=sig_rows)
        da_k, v_k = ops.sdca_epoch(*args, map_error=err_c, **kw)
        da_r, v_r = ref.sdca_inner_ref(*args, **kw)
        da_2, v_2 = ops.sdca_epoch(*args, map_error=err_c, **kw)
        torch.cuda.synchronize()
        sdca_mod.raise_map_error(err_c, K)
        da_abs, da_rel = errors(da_k, da_r)
        v_abs, v_rel = errors(v_k, v_r)
        ok = (torch.allclose(da_k, da_r, rtol=1e-4, atol=1e-5)
              and torch.allclose(v_k, v_r, rtol=1e-4, atol=1e-5))
        bitwise = bool(torch.equal(da_k, da_2) and torch.equal(v_k, v_2))
        ms = time_ms(lambda: ops.sdca_epoch(*args, map_error=err_c, **kw), warmup=2, reps=10)
        plain_ms = time_ms(lambda: ref.sdca_inner_ref(*args, **kw), warmup=0, reps=1)
        p_c = sdca_mod.plan(Bc, SVC_N_K, D)
        rows_c = sum(int(torch.unique(idx_c[b]).numel()) for b in range(Bc))
        nbytes_c = rows_c * D * 4 + Bc * D * 4 * 2 + Bc * SVC_N_K * 4 * 4 + Bc * H * 4
        svc_rows[case] = dict(
            rows=Bc, worker_map=wmap is not None, alpha_rows=a_rows, sigma_rows=True,
            cluster=p_c["cluster"], stages=p_c["stages"], per_thread=p_c["per_thread"],
            dalpha_abs=da_abs, dalpha_rel=da_rel, v_abs=v_abs, v_rel=v_rel, within=ok,
            repeat_bitwise=bitwise, ms=ms, plain_ms=plain_ms,
            bound_ms=max(nbytes_c / PEAK_BYTES, 6 * D * H * Bc / PEAK_F32) * 1e3)
        check(ok, f"sdca_inner at the service's {case} within rtol 1e-4 / atol 1e-5 of its "
                  f"plain version")
        check(bitwise, f"sdca_inner at the service's {case} repeats bit for bit")
        del w_c, a_c, idx_c, da_k, v_k, da_r, v_r, da_2, v_2
    emit("kernel_sdca_inner_service_check", shape=dict(K=K, n_k=SVC_N_K, d=D, H=H),
         loss=svc_prob.loss, rtol=1e-4, atol=1e-5, by_launch=svc_rows)
    kernels["sdca_inner"].update(
        max_abs_err=max(kernels["sdca_inner"]["max_abs_err"],
                        *(max(r["dalpha_abs"], r["v_abs"]) for r in svc_rows.values())),
        ms_service={c: r["ms"] for c, r in svc_rows.items()},
        plain_ms_service={c: r["plain_ms"] for c, r in svc_rows.items()},
        bound_ms_service={c: r["bound_ms"] for c, r in svc_rows.items()})
    del svc_norms

    for warm in (svc_spec("w", cocoa_at(1.0), seed=99),
                 svc_spec("w", lag_at(0.5), seed=99, num_outer=1)):
        solo_of(warm)  # the solo runs' own graphs, captured before any timing
    sigmas = (1.0, 10.0)

    def cocoa_wave(name, n, gammas, seed0):
        return [(f"tenant{i % 4}", svc_spec(f"{name}{i}", cocoa_at(gammas[i % len(gammas)]),
                                            seed=seed0 + i, sigma=sigmas[(i // 2) % 2]))
                for i in range(n)]

    rows = []
    for batch in ("map", "vmap"):
        svc.policy = policy(batch)
        per_cell = COCOA_ROUNDS if batch == "map" else 0
        # The warm 3- and 5-cell waves run 4 and 8 cells' work (the padding)
        # beside the sum of their solo replays.
        for name, n, gammas, seed0, captures in (
                ("8", 8, (0.5, 1.0), 0, 1), ("3", 3, (0.5, 1.0), 8, 1),
                ("4", 4, (1.0, 0.5, 0.25, 0.75), 11, 0), ("8_warm", 8, (0.25, 0.75), 15, 0),
                ("3_warm", 3, (0.25, 0.75), 23, 0), ("5_warm", 5, (0.5, 0.25), 26, 0)):
            cells = engine._bucket_size(n)  # the padded bucket
            rows.append(run_wave(svc, f"cocoa_{batch}{name}",
                                 cocoa_wave(f"{batch}{name}-", n, gammas, seed0),
                                 want_captures=captures,
                                 want_launches=per_cell * cells or COCOA_ROUNDS))
    svc.policy = policy("map")
    lag_delays = (("constant", None), ("shifted_exponential", {"tail_mean": 1.0}))

    def lag_wave(name, gammas, seed0):
        return [(f"tenant{i}", svc_spec(f"{name}{i}", lag_at(gammas[i % len(gammas)]),
                                        seed=seed0 + i, num_outer=1,
                                        delay=lag_delays[i % 2][0], params=lag_delays[i % 2][1]))
                for i in range(4)]

    rows.append(run_wave(svc, "lag_map4", lag_wave("l", (0.5,), 20), want_captures=1,
                         want_launches=4 * (1 + T)))
    rows.append(run_wave(svc, "lag_map4_gammas", lag_wave("m", (0.25, 0.75), 24),
                         want_captures=0, want_launches=4 * (1 + T)))
    rows.append(run_wave(svc, "acpd_solo",
                         [("tenant0", svc_spec("acpd", baselines.acpd(K, D, B=B, T=T,
                                                                      rho_d=RHO_D, H=H),
                                               seed=30, num_outer=1))],
                         want_launches=1 + T))
    check(svc.counters["solo_requests"] == 1, "the ACPD request took the solo lane")
    lock_reps = 100_000
    t0 = time.perf_counter()
    for _ in range(lock_reps):
        with executor._LOCK:
            pass
    lock_us = (time.perf_counter() - t0) / lock_reps * 1e6
    emit("service_coalesce", problem=dict(K=K, n_per_worker=SVC_N_K, d=D, H=H,
                                          X_gb=svc_prob.X.numel() * 4 / 1e9),
         build_s=build_s, waves=rows, service_counters=dict(svc.counters),
         compile_cache=svc.compile_cache.stats(), stats=dict(executor.STATS),
         lock_acquire_release_us=lock_us,
         memory_reserved_gb=torch.cuda.memory_reserved() / 1e9)

    # service_memory: waves of 2 cells with 1..20 rounds, each a new graph
    # signature, past the executor's 16 cached graphs; memory_reserved after
    # each (the graphs' private pools).
    svc.policy = policy("map")
    mem = []
    for rounds in range(1, 21):
        run_wave(svc, "memory", [(f"tenant{i}", svc_spec(f"mem{rounds}-{i}", cocoa_at(1.0),
                                                         seed=100 + i, num_outer=rounds))
                                 for i in range(2)], want_captures=1, compare=False)
        mem.append(dict(rounds=rounds, cached_graphs=len(executor._CACHE),
                        memory_reserved_gb=torch.cuda.memory_reserved() / 1e9,
                        memory_allocated_gb=torch.cuda.memory_allocated() / 1e9))
    launches.pop("service_memory")
    emit("service_memory", waves=mem, cache_size=executor._CACHE_SIZE,
         grew_after_full=mem[-1]["memory_reserved_gb"] > max(
             m["memory_reserved_gb"] for m in mem if m["cached_graphs"] < executor._CACHE_SIZE))

    # service_checkpoint: a checkpointed CoCoA+ spec killed at the segment
    # starting at round 5, resubmitted, resumed bit for bit.
    ck = svc_spec("ck", cocoa_at(1.0), seed=40, checkpoint_every=5)
    svc.fault = faults.get_fault("worker_crash")(crashes=0, crash_round=5)
    killed_row = run_wave(svc, "checkpoint_killed", [("tenant0", ck)],
                          want_errors={0: faults.WorkerCrashError}, want_launches=5)
    svc.fault = faults.NoFault()
    segments0 = executor.STATS["lockstep_segment_calls"]
    resumed_row = run_wave(svc, "checkpoint", [("tenant0", dataclasses.replace(
        ck, checkpoint_every=5))], want_launches=5)
    emit("service_checkpoint", every=5, rounds=COCOA_ROUNDS, killed=killed_row,
         resumed=resumed_row,
         segments_after_resume=executor.STATS["lockstep_segment_calls"] - segments0)
    check(executor.STATS["lockstep_segment_calls"] - segments0 == 1,
          "the resumed run ran one segment")

    # service_http: the dispatcher thread behind ThreadingHTTPServer.
    svc.policy = policy("map", max_wait_s=0.01)
    svc.start()
    server = svc_lib.serve_http(svc, "127.0.0.1", 0)
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    http_spec = svc_spec("http", cocoa_at(0.5), seed=50)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    req = urllib.request.Request(f"{base}/submit", method="POST", data=json.dumps(
        {"tenant": "tenant0", "spec": http_spec.to_dict()}).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        job = json.loads(r.read())
    with urllib.request.urlopen(f"{base}/events/{job['job_id']}", timeout=300) as r:
        streamed = [svc_lib.event_from_dict(e) for e in json.loads(r.read())["events"]]
    http_wall = time.perf_counter() - t0
    with urllib.request.urlopen(f"{base}/stats", timeout=60) as r:
        http_stats = json.loads(r.read())
    launches["service_http"] = dict(ops.LAUNCHES)
    server.shutdown()
    server_thread.join()
    svc.stop()
    http_equal = streamed == solo_of(http_spec)[0]
    emit("service_http", wall_s=http_wall, events=len(streamed), equal_solo=http_equal,
         devices=http_stats["devices"], compile_cache=http_stats["compile_cache"],
         launches=launches["service_http"])
    check(http_equal, "the HTTP event stream equals the solo run")
    check(http_stats["devices"]["platform"] == "gpu"
          and http_stats["devices"]["kind"] == torch.cuda.get_device_name(0),
          "GET /stats names the card")
    del svc
    ck_dir.cleanup()

    # service_chaos: a second service under the chaos schedule and a batch
    # deadline. A LAG batch (sigma' = gamma * B) is dispatched first: it
    # overruns (the fault sleeps inside the watchdog window), is requeued on
    # the solo lane, and its abandoned attempt wakes up and runs the batch,
    # with its NaN-poisoned cell, on its own thread while this thread runs
    # the CoCoA+ batch (one transient fault, one retry) and the solo lane.
    # A second LAG wave is poisoned at the same cell and captures nothing.
    deadline = 2.0
    svc2 = svc_lib.ExperimentService(
        policy("map"), device=dev,
        recovery=svc_lib.RecoveryPolicy(max_attempts=3, backoff_base_s=0.001,
                                        batch_deadline_s=deadline),
        fault=faults.get_fault("chaos")(seed=5, delay_s=deadline + 0.05, poison=1))
    t0 = time.perf_counter()
    svc2._problem_for(svc_spec("build", cocoa_at(1.0), seed=0))
    torch.cuda.synchronize()
    build2_s = time.perf_counter() - t0
    spans = []
    real_sweep, real_solo = svc_mod.run_sweep_cells, svc2._run_solo

    def timed_sweep(*a, **kw):
        t_in = time.perf_counter()
        out = real_sweep(*a, **kw)  # its results are on the host when it returns
        spans.append(("sweep", threading.current_thread().name, t_in, time.perf_counter(),
                      a[2], out))
        return out

    def timed_solo(req):
        t_in = time.perf_counter()
        real_solo(req)
        spans.append(("solo", threading.current_thread().name, t_in, time.perf_counter(),
                      None, None))

    svc_mod.run_sweep_cells, svc2._run_solo = timed_sweep, timed_solo
    try:
        lag_items = lag_wave("x", (0.5,), 60)
        cocoa_items = cocoa_wave("y", 4, (0.5, 1.0), 64)
        # The abandoned LAG batch (4 cells, 4 * (1 + T)), the same 4 cells
        # on the solo lane, and the CoCoA+ batch's retry (4 cells, 10 rounds).
        first = run_wave(svc2, "chaos_overrun_and_retry", lag_items + cocoa_items,
                         want_launches=2 * 4 * (1 + T) + 4 * COCOA_ROUNDS)
        poison_at = svc2.fault.poison_cells(4, svc_lib.batch_key(
            lag_items[0][1], lag_items[0][1].methods[0], policy=svc2.policy))
        second = run_wave(svc2, "chaos_poisoned_lag", lag_wave("z", (0.25, 0.75), 70),
                          want_captures=0, want_launches=4 * (1 + T),
                          want_errors={i: svc_lib.CellDivergenceError for i in poison_at})
    finally:
        svc_mod.run_sweep_cells, svc2._run_solo = real_sweep, real_solo
    c = first["counters"]
    check(c.get("timeouts") == 1 and c.get("requeued_solo") == 4 and c.get("retries") == 1
          and c.get("batches") == 1 and c.get("solo_requests") == 4 and not c.get("failed"),
          f"chaos: one overrun requeued 4 solo, one retry, one batch ({c})")
    abandoned = [s for s in spans if s[1].startswith("deadline-batch") and s[4][0].seed == 60]
    check(len(abandoned) == 1, "the overrun LAG batch's abandoned attempt ran to its end")
    _, ab_thread, ab_in, ab_out, ab_cells, ab_variants = abandoned[0]
    others = [s for s in spans if s is not abandoned[0]]  # the batch, the solo lane
    overlap = sum(max(0.0, min(ab_out, s[3]) - max(ab_in, s[2])) for s in others)
    finite = executor.finite_certificates(ab_variants).tolist()
    ab_equal = all(state_equal(v.result, solo_of(spec)[1]) and records_equal(
        v.result, solo_of(spec)[1]) for i, (v, (_, spec)) in enumerate(zip(ab_variants,
                                                                           lag_items))
        if i not in poison_at)
    c2 = second["counters"]
    emit("service_chaos", deadline_s=deadline, build_s=build2_s, waves=[first, second],
         poisoned_cells=list(poison_at), abandoned_attempt=dict(
             thread=ab_thread, seconds=ab_out - ab_in, overlap_with_this_thread_s=overlap,
             finite=finite, healthy_cells_equal_solo=ab_equal),
         service_counters=dict(svc2.counters))
    check(overlap > 0.0, "the abandoned attempt ran while this thread served the batch "
                         "and the solo lane")
    check(ab_equal and [not f for f in finite] == [i in poison_at for i in range(4)],
          "the abandoned attempt's healthy cells equal their solo runs; only the "
          "poisoned cell diverged")
    check(c2.get("masked_cells") == 1 and c2.get("failed") == 1,
          "the poisoned LAG wave failed exactly its poisoned tenant")
    del svc2

    # service_cluster: two in-process replicas on a temporary cluster
    # directory; r0 is killed at the checkpoint segment starting at round 5,
    # r1 takes its lease over and resumes; each job delivered exactly once.
    with tempfile.TemporaryDirectory() as cdir:
        clock = svc_lib.ManualClock()
        kill = faults.get_fault("replica_kill")(replica="r0", at_segment=5)
        replicas = [svc_lib.ClusterReplica(
            cdir, rid, clock=clock, fault=kill if rid == "r0" else None, lease_ttl_s=5.0,
            service_kwargs=dict(policy=policy("map"), device=dev)) for rid in ("r0", "r1")]
        client = svc_lib.ClusterClient(cdir, clock=clock)
        cl_specs = [svc_spec(f"cl{i}", cocoa_at(1.0), seed=80 + i, checkpoint_every=5)
                    for i in range(2)]
        keys = [client.submit(f"tenant{i}", s) for i, s in enumerate(cl_specs)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        summary = svc_lib.run_cluster(replicas, client, clock=clock, advance_s=1.0,
                                      max_ticks=60)
        torch.cuda.synchronize()
        cluster_wall = time.perf_counter() - t0
        launches["service_cluster"] = dict(ops.LAUNCHES)
        delivered = []
        for key, spec in zip(keys, cl_specs):
            events, result = client.try_result(key)
            plain = dataclasses.replace(spec, checkpoint_every=None)
            record = json.loads((pathlib.Path(cdir) / "results" / f"{key}.json").read_text())
            delivered.append(dict(owner=record["owner"], epoch=record["epoch"],
                                  equal_solo=events == solo_of(plain)[0] and state_equal(
                                      result, solo_of(plain)[1])))
        n_results = len(list((pathlib.Path(cdir) / "results").glob("*.json")))
        emit("service_cluster", wall_s=cluster_wall, ticks=summary["ticks"],
             dead=summary["dead"], hung_jobs=summary["hung_jobs"], delivered=delivered,
             result_records=n_results, replicas=summary["replicas"],
             launches=launches["service_cluster"])
        check("r0" in summary["dead"] and summary["hung_jobs"] == 0,
              "r0 died at its segment and no job hung")
        check(summary["replicas"]["r1"]["takeovers"] == 1, "r1 took the dead lease over")
        check(n_results == 2 and all(d["equal_solo"] for d in delivered),
              "each job delivered once, bit for bit its uninterrupted solo run")
        check(any(d["owner"] == "r1" and d["epoch"] == 1 for d in delivered),
              "the taken-over job was delivered by r1 at epoch 1")
        del replicas
    del svc_prob, solos, spans, abandoned, ab_variants, real_sweep, real_solo
    executor.clear_cache()
    gc.collect()  # the services and replicas hold their problems in reference cycles
    torch.cuda.empty_cache()

    # -- kernel 3: flash_attention_fwd at the serve shape and a ragged S -----
    flash_err = {"float32": 0.0, "bfloat16": 0.0}
    tol = {"float32": 1e-5, "bfloat16": 3e-2}
    serve_shape = dict(B=SERVE_B, S=SERVE_PLEN, KV=8, G=5, hd=128)  # qwen3-14b's GQA
    cases = [(dict(serve_shape, B=2, S=1000), dt, c)
             for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    # The tensor-core kernel at another head dim (its swizzle) and G = 1.
    cases += [(dict(B=2, S=1000, KV=8, G=1, hd=64), torch.bfloat16, c) for c in (True, False)]
    cases += [(serve_shape, dt, True) for dt in (torch.float32, torch.bfloat16)]
    for shape, dtype, causal in cases:
        B_, S_, KV_, G_, hd_ = (shape[k] for k in ("B", "S", "KV", "G", "hd"))
        q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(dtype)
        k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
        v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
        out = ops.flash_attention_fwd(q, k_, v_, causal=causal)
        want = ref.flash_attention_fwd_ref(q, k_, v_, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).removeprefix("torch.")
        err = float((out.float() - want.float()).abs().max())
        rtol = 1e-5 if dtype == torch.float32 else 0.0
        within = bool(torch.allclose(out.float(), want.float(), rtol=rtol, atol=tol[name]))
        bitwise = bool(torch.equal(out, ops.flash_attention_fwd(q, k_, v_, causal=causal)))
        flash_err[name] = max(flash_err[name], err)
        emit("kernel_flash_attention_check", shape=shape, dtype=name, causal=causal,
             max_abs_err=err, rtol=rtol, atol=tol[name], within=within,
             repeat_bitwise=bitwise)
        check(within, f"flash_attention_fwd within tolerance ({shape}, {name}, {causal})")
        check(bitwise, f"flash_attention_fwd repeats bit for bit ({shape}, {name})")
    # Timing at the serve shape, bfloat16, causal: the kernel, the plain
    # version, and SDPA on the (B, H, S, hd) layout (timed only, never used).
    ms = time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, causal=True), warmup=2, reps=10)
    plain_ms = time_ms(lambda: ref.flash_attention_fwd_ref(q, k_, v_, causal=True),
                       warmup=1, reps=3)
    B_, S_, KV_, G_, hd_ = q.shape
    qs = q.reshape(B_, S_, KV_ * G_, hd_).transpose(1, 2).contiguous()
    ks, vs = k_.transpose(1, 2).contiguous(), v_.transpose(1, 2).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = time_ms(lambda: sdpa(qs, ks, vs, is_causal=True, enable_gqa=True),
                         warmup=2, reps=10)
    sdpa_err = float((sdpa(qs, ks, vs, is_causal=True, enable_gqa=True).transpose(1, 2)
                      .reshape(q.shape).float() - out.float()).abs().max())
    flops = 4 * B_ * KV_ * G_ * hd_ * S_ * (S_ + 1) // 2  # q.k and p.v on the causal half
    nbytes = 2 * q.numel() * q.element_size() + 2 * k_.numel() * k_.element_size()
    bound_ms = max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3
    kernels["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:86",
        max_abs_err=max(flash_err.values()), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES else "bytes",
        library_ms=library_ms)
    emit("kernel_flash_attention", shape=serve_shape, dtype="bfloat16", causal=True,
         max_abs_err_by_dtype=flash_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
         library_max_abs_diff=sdpa_err, bound_ms=bound_ms, bound_flops=flops,
         bound_bytes=nbytes, achieved_tflops=flops / (ms * 1e-3) / 1e12)
    del q, k_, v_, out, want, qs, ks, vs
    torch.cuda.empty_cache()

    # -- main path 4: serve qwen3-14b at full width and depth ----------------
    cfg = get_config(SERVE_ARCH)
    t0 = time.perf_counter()
    params = tree_materialize(model_spec(cfg), torch.Generator(device=dev).manual_seed(SEED),
                              dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = make_token_dataset(SERVE_B * SERVE_PLEN, cfg.vocab_size, 0).reshape(
        SERVE_B, SERVE_PLEN)
    serve.generate(params, prompts, cfg, 2, device=dev)  # warm-up: cuBLAS, allocator
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gen_res = serve.generate(params, prompts, cfg, SERVE_GEN, device=dev)
    wall = time.perf_counter() - t0
    launches["serve"] = dict(ops.LAUNCHES)
    emit("serve", arch=cfg.arch_id, layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.param_dtype, batch=SERVE_B, prompt_len=SERVE_PLEN, gen=SERVE_GEN,
         max_seq=SERVE_PLEN + SERVE_GEN, init_s=init_s, prefill_s=gen_res.prefill_s,
         decode_ms_per_token=gen_res.decode_s / (SERVE_GEN - 1) * 1e3, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         prefill_flash_launches=gen_res.prefill_flash_launches,
         decode_flash_launches=gen_res.decode_flash_launches,
         logits_finite=gen_res.logits_finite, tokens_row0=gen_res.tokens[0].tolist(),
         launches=launches["serve"])
    check(gen_res.prefill_flash_launches == cfg.num_layers,
          f"prefill launched the flash kernel {gen_res.prefill_flash_launches} times")
    check(gen_res.decode_flash_launches == 0, "decode launched no flash kernel")
    check(launches["serve"]["flash_attention_fwd"] == cfg.num_layers,
          "the serve path launched the flash kernel once per layer")
    check(gen_res.logits_finite, "all logits finite")
    check(gen_res.tokens.shape == (SERVE_B, SERVE_GEN), "generated (B, gen) tokens")
    del params
    torch.cuda.empty_cache()

    # -- the kernel's prefill against the cache's decode, on the card --------
    # Logits at position 2048 from one prefill over 2049 tokens (a ragged
    # last tile) and from prefill over 2048 then one decode step.
    cfg2 = dataclasses.replace(cfg, num_layers=CONSIST_LAYERS, param_dtype="float32",
                               compute_dtype="float32")
    p2 = tree_materialize(model_spec(cfg2), torch.Generator(device=dev).manual_seed(SEED),
                          dev)
    toks = torch.as_tensor(make_token_dataset(SERVE_PLEN + 1, cfg2.vocab_size, 1),
                           device=dev).long()[None]
    ops.reset_launch_counts()
    whole, _, _ = prefill(p2, {"tokens": toks}, cfg2, max_seq=SERVE_PLEN + 1)
    _, caches, plen = prefill(p2, {"tokens": toks[:, :SERVE_PLEN]}, cfg2,
                              max_seq=SERVE_PLEN + 1)
    stepped, _ = decode_step(p2, toks[:, SERVE_PLEN], caches, plen + 1, cfg2)
    torch.cuda.synchronize()
    consist = dict(ops.LAUNCHES)
    diff = float((whole - stepped).abs().max())
    close = bool(torch.allclose(stepped, whole, rtol=1e-3, atol=1e-3))
    emit("serve_consistency", layers=CONSIST_LAYERS, dtype="float32", batch=1,
         prompt_len=SERVE_PLEN + 1, max_abs_diff=diff, rtol=1e-3, atol=1e-3,
         within=close, same_argmax=bool(torch.equal(whole.argmax(-1), stepped.argmax(-1))),
         launches=consist)
    check(consist["flash_attention_fwd"] == 2 * CONSIST_LAYERS, "both prefills used the kernel")
    check(close, "prefill over S+1 tokens agrees with prefill over S plus one decode step")
    del p2, caches
    torch.cuda.empty_cache()

    for name, entry in kernels.items():
        entry["launches"] = sum(path[name] for path in launches.values())
        entry["launches_by_path"] = {p: c[name] for p, c in launches.items()}
        check(entry["launches"] > 0, f"{name} ran on a main path")
    print(json.dumps({"kernels": list(kernels.values())}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
