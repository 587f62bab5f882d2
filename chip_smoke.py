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
delivered stream is held to a solo ``Session`` on the card. The training
phases drive ``python -m repro_torch.launch.train``'s setup (codeqwen1.5-7b at
full width, 2 layers, the ACPD grouped delta exchange, AdamW) for 12 steps
through ``build_train_step`` (every attention layer's forward on the flash
kernel with its log-sum-exp, the FlashAttention-2 backward in PyTorch), hold
one step of the kernel path against the plain forward and the dense exchange
against the plain gradient, and resume the run from its step-6 checkpoint
bit for bit; ``kernel_flash_attention_lse`` holds the kernel's output and
log-sum-exp against the plain version's at the serve shape and the training
path's two shapes. First of all, while the card holds nothing else, the MoE
and SSM serve paths run: qwen3-moe-30b-a3b (48 layers, 128 experts, 61.09
GB of bf16 weights) and mamba2-780m (48 SSD layers) at full width and depth
through ``serve.generate`` with the serve path's batch, prompt and tokens
(the MoE line also gives the first MoE layer's prefill routing: slots
dropped at capacity 648, the most-loaded expert), each one's prefill held
against prefill plus a decode step at 2 layers in float32 (the MoE one at
capacity factor 16, where nothing drops; the SSM one, the chunked SSD
against the recurrence, at JAX's SSD tolerances), and jamba's reduced
hybrid stack (attention, SSD, dense and MoE layers in one period) on the
card against the host; ``kernel_flash_attention_moe`` times the flash
kernel at qwen3-moe's GQA shape (KV 4, G 8). Right after the MoE model,
gemma3-27b (62 layers, 52 with a 1,024-key sliding window and a ring cache,
56.84 GB of weights) and pixtral-12b (1,024 patch embeddings before the
prompt) are served at full width and depth the same way, gemma3's prefill
held against prefill plus a decode step over wrapped rings at full width
in float32 over one 5 + 1 period; at the end hubert-xlarge (48 layers,
head dim 80, not causal, frame embeddings) trains for a few steps at full
width and depth through the train CLI's ACPD setup. The flash kernel's
window and head dim 80 are held to the plain version in both dtypes (W
1,024, 1,000 and 37, causal and not; hd 80; gemma3's global shape; the
lse under both) and timed at gemma3's local and global, pixtral's and
hubert's shapes against SDPA (with the window's boolean mask) and the
bound. The logit softcap (cap 50) is held to the plain version in both
kernels at those four shapes, with and without the lse, and timed beside
the capless launch; the full-range launch (the model's exploit_window=False)
equals the windowed launch bit for bit at gemma3's local shape and at S
32,768; gemma3-27b's full-width prefill runs again on the same weights with
exploit_window=False (``serve_window_baseline``: the same logits bit for
bit, its seconds beside the exploiting prefill's); the float32
prefill-against-decode check runs again with the cap
(``serve_consistency_window_softcap``), and the training check with the cap
against autograd through the plain forward (``train_softcap_check``); the
capped launches are timed beside compiled ``flex_attention`` with the cap
as its ``score_mod``, and the S 32,768 full-range launch beside SDPA's
memory-efficient backend with the window's boolean mask. After the
``cli`` phase, ``analyze`` runs the port's static analyzer on the card: its
run contracts at the JAX package's toy sizes and, on the executor's
captured lockstep and LAG graphs at RCV1 width (which launch
``sdca_inner``), one capture per run signature, launches linear in the
round count and no host sync in two replays under sync debug mode
"error"; then the lint of ``src/repro_torch`` and ``python -m repro_torch
analyze``. At the
end ``dryrun`` records every (architecture x input shape) of
``repro_torch.launch.dryrun`` on meta tensors and runs once each that fits
the card, its peak beside the resident estimate. It also checks that
the bfloat16 flash kernel was compiled to tensor-core (HGMMA) and TMA
instructions, and that one top-k filter call runs at most four kernels
without a host sync. ``kernel_exchange_threshold`` holds the exchange's
threshold kernel to its plain rounds bit for bit at the exchange cell's
leaf sizes, checks that a call runs its three named kernels without a host
sync, and times it beside its bound, the plain rounds and ``torch.histc``;
both training phases check that it ran once a group and filtered leaf of
every step. ``kernel_exchange_apply`` holds the exchange's split
(``csrc/exchange_apply.cu``) to its plain passes bit for bit at the exchange
cells' largest leaves and times each pass beside its byte bound and its plain
version; both training phases check two launches a group and leaf of every
step. Launch counts are zeroed just before each path and
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
import os
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
# The MoE and SSM serve paths: qwen3-moe-30b-a3b (61.09 GB of weights) and
# mamba2-780m at full width and depth, with the serve path's batch, prompt and
# tokens; their consistency checks at 2 layers in float32, the MoE one at
# capacity factor 16 (C > N: no slot drops, so the 2049-token prefill and the
# 2048-token prefill plus a decode step route alike); the SSM one at JAX's own
# SSD tolerances (tests/test_ssm.py). The hybrid stack: jamba's reduced()
# config (16 layers, 4 experts, float32), card against host, prefill of
# HYBRID_PLEN tokens and HYBRID_STEPS decode steps. Its float32 logits move
# by 1.4e-4 to 8e-4 on the host itself when every SSD step size dt moves by
# one ulp (both inits), more than a fixed 1e-4: the card must stay within
# HYBRID_BAND times that shift, measured in the same run.
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = "qwen3-moe-30b-a3b", "mamba2-780m", "jamba-1.5-large-398b"
# The window, vision and audio paths: gemma3-27b (62 layers, 52 of them with a
# 1,024-key window and a ring cache; 56.84 GB of weights) and pixtral-12b
# (1,024 patch embeddings before the 2,048-token prompt: S = 3,072) served at
# full width and depth with the serve path's batch, prompt and tokens;
# gemma3's consistency check at full width in float32 over one period (5
# local + 1 global layers), its prompt past the window so that the decode
# step writes over a wrapped ring; hubert-xlarge (48 layers, head dim 80,
# not causal) trained at full width and depth through the train CLI's ACPD
# setup, batch 8 x 1,024, AUDIO_STEPS steps.
WINDOW_ARCH, VISION_ARCH, AUDIO_ARCH = "gemma3-27b", "pixtral-12b", "hubert-xlarge"
WINDOW_CONSIST_LAYERS, AUDIO_STEPS = 6, 6
MOE_CONSIST_CF = 16.0
SSM_RTOL, SSM_ATOL = 1e-4, 2e-5
HYBRID_B, HYBRID_PLEN, HYBRID_STEPS, HYBRID_TOL, HYBRID_BAND = 2, 256, 3, 1e-4, 3.0

# The training path: codeqwen1.5-7b at full width, depth cut from 32 to 2
# layers (the K = 4 float32 residuals alone are 16 B a parameter: at 32
# layers they would be 116 GB), the CLI's ACPD defaults (K = 4 groups, B = 2,
# T = 10, rho = 1/64, gamma = 0.9, AdamW lr 1e-3, warm-up 3), batch 8 x
# 1,024 tokens, 12 steps (step 9 is a dense sync), checkpointed at step 6.
# The check at the same width: batch 4 x 512, one step.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_B, TRAIN_SEQ = "codeqwen1.5-7b", 2, 8, 1024
TRAIN_STEPS, TRAIN_CKPT_AT = 12, 6
CHECK_B, CHECK_SEQ = 4, 512
# bf16 tolerances, the loss within 1e-2 relative and each gradient leaf
# within 5e-2 in relative L2 norm: every activation of the 2-layer stack is a
# bf16 rounding (2^-8) of a float32 sum, and the deepest leaf (the
# embedding) collects those of both layers. Against the plain forward the
# kernel also rounds P to bf16 before P V; the dense exchange against the
# plain gradient runs groups of 1 row where the plain step runs 4, so the
# GEMMs sum in other orders and round other values.
CHECK_LOSS_RTOL, CHECK_GRAD_RTOL = 1e-2, 5e-2
# The dense exchange against the plain gradient again in float32 (fan-in
# init): the same sums in other orders, 1e-4 in relative L2 norm.
CHECK_F32_RTOL = 1e-4

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3 bytes/s,
# float32 FLOP/s outside the tensor cores (the type the SDCA and top-k
# kernels compute in), and bf16 FLOP/s of the tensor cores (the least time
# for the attention's products in the serve path's type).
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

# The logit softcap's checks: gemma-2's published attn_logit_softcapping
# (no config in the repository sets one); the kernel checks take sm_scale 4x
# the model's, so that standard normal q and k give scores of about +-20,
# which the cap bends. The full-range launch at prefill_32k's length.
SOFTCAP, CAP_SCALE, FULL_RANGE_S = 50.0, 4.0, 32_768

# The exchange threshold's leaf sizes: phi3-medium-14b's at 2 layers (the
# benchmark's exchange cell), one 5,120 x 17,920 MLP matrix and the 2-layer
# stack of one, at the exchange's rho 1/64. Its library yardstick, one
# torch.histc pass into the kernel's 65 bins over +-10 sigma of the input.
THRESHOLD_SIZES, THRESHOLD_RHO, THRESHOLD_SIGMA = (91_750_400, 183_500_800), 1 / 64, 1e-3

# The exchange split's leaf sizes: phi3-medium-14b's largest (the 2-layer
# stack of one 5,120 x 17,920 MLP matrix) and HuBERT X-Large's stacked FFN
# matrix (48 x 1,280 x 5,120), bf16 gradients at the exchange's rho 1/64.
APPLY_SIZES = (183_500_800, 314_572_800)

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


def threshold_calls(spec, exch) -> int:
    """Threshold kernel calls of one exchange step: one a group and filtered leaf."""
    from repro_torch.models.param import tree_flatten

    if exch.rho >= 1.0:
        return 0
    leaves = tree_flatten(spec)[0]
    return exch.num_groups * sum(math.prod(s.shape) >= exch.min_leaf_size for s in leaves)


def apply_calls(spec, exch) -> int:
    """Split launches of one exchange step: two a group and leaf where the
    filter is topk_threshold (the fused split), none otherwise."""
    from repro_torch.core import compress
    from repro_torch.models.param import tree_flatten

    if not isinstance(compress.for_exchange(exch), compress.TopKThreshold):
        return 0
    return 2 * exch.num_groups * len(tree_flatten(spec)[0])


def kernel_exchange_apply(dev, gen) -> dict:
    """``csrc/exchange_apply.cu`` at the exchange cells' largest leaves: both
    passes bit for bit their plain versions (a participating sparse group),
    no host sync, then each pass timed alone beside its byte bound and its
    plain version. Pass 2 is timed in three modes, each launch right after a
    pass 1 (so the kept set is a fresh one), by CUDA events around it alone:
    a participating sparse group, a resting one (p_g = 0) and the dense
    step. Returns the kernels line's row."""
    from repro_torch.kernels import exchange_apply as apply_mod, ops

    nb = dict(dense_bytes=(4, 0), sparse_bytes=(8, 0))
    one, zero = torch.tensor(1.0, device=dev), torch.tensor(0.0, device=dev)
    no, yes = torch.tensor(False, device=dev), torch.tensor(True, device=dev)
    by_size = {}
    for n_leaf in APPLY_SIZES:
        k_leaf = max(1, int(n_leaf * THRESHOLD_RHO))
        grad = (torch.randn(n_leaf, generator=gen, device=dev) * THRESHOLD_SIGMA).to(
            torch.bfloat16)
        res = torch.randn(n_leaf, generator=gen, device=dev).mul_(THRESHOLD_SIGMA)
        acc = torch.zeros(n_leaf, device=dev)
        counts = [torch.zeros((), device=dev) for _ in range(2)]
        r_p, a_p, c_p = res.clone(), acc.clone(), [c.clone() for c in counts]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.exchange_apply_add(res, grad)
            thresh = ops.exchange_threshold(res, k_leaf)
            ops.exchange_apply_split(res, acc, one, no, thresh, *counts, **nb)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        apply_mod.exchange_apply_add_plain(r_p, grad)
        kept = int((r_p.abs() >= thresh).sum())
        apply_mod.exchange_apply_split_plain(r_p, a_p, one, no, thresh, *c_p, **nb)
        equal = all(bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
                    for a, b in ((res, r_p), (acc, a_p), *zip(counts, c_p)))
        emit("kernel_exchange_apply_check", n=n_leaf, k=k_leaf, kept=kept,
             sent_count=float(counts[0]), byte_count=float(counts[1]), bits_equal_plain=equal)
        check(equal, f"exchange_apply equals its plain passes bit for bit (n {n_leaf})")
        check(float(counts[0]) == kept, "the split counted the kept coordinates")
        del r_p, a_p
        torch.cuda.empty_cache()

        def split_ms(pg, dense, warmup=3, reps=20):
            marks = []
            for r in range(warmup + reps):
                ops.exchange_apply_add(res, grad)
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                ops.exchange_apply_split(res, acc, pg, dense, thresh, *counts, **nb)
                e1.record()
                if r >= warmup:
                    marks.append((e0, e1))
            torch.cuda.synchronize()
            return sum(a.elapsed_time(b) for a, b in marks) / len(marks)

        def plain_pair():
            apply_mod.exchange_apply_add_plain(res, grad)
            apply_mod.exchange_apply_split_plain(res, acc, one, no, thresh, *counts, **nb)

        sparse_bytes = (4 + 12 * kept / n_leaf) * n_leaf  # d read; acc and res where kept
        row = dict(
            k=k_leaf, kept=kept,
            add_ms=time_ms(lambda: ops.exchange_apply_add(res, grad), warmup=3, reps=20),
            add_bound_ms=10 * n_leaf / PEAK_BYTES * 1e3,
            split_sparse_ms=split_ms(one, no), split_sparse_bound_ms=sparse_bytes / PEAK_BYTES * 1e3,
            split_resting_ms=split_ms(zero, no), split_resting_bound_ms=4 * n_leaf / PEAK_BYTES * 1e3,
            split_dense_ms=split_ms(one, yes), split_dense_bound_ms=16 * n_leaf / PEAK_BYTES * 1e3,
            add_plain_ms=time_ms(lambda: apply_mod.exchange_apply_add_plain(res, grad),
                                 warmup=1, reps=5),
            pair_plain_ms=time_ms(plain_pair, warmup=1, reps=5))
        row["split_plain_ms"] = row["pair_plain_ms"] - row["add_plain_ms"]
        by_size[n_leaf] = row
        emit("kernel_exchange_apply", n=n_leaf, grad_dtype="bfloat16", **row)
        del grad, res, acc
        torch.cuda.empty_cache()
    at = by_size[APPLY_SIZES[0]]
    return dict(
        name="exchange_apply", route="cuda", source="src/repro_torch/csrc/exchange_apply.cu",
        replaces="none: src/repro/core/exchange.py exchange_sequential's split is jnp",
        max_abs_err=0.0, n=APPLY_SIZES[0], ms=at["add_ms"] + at["split_sparse_ms"],
        plain_ms=at["pair_plain_ms"], bound_ms=at["add_bound_ms"] + at["split_sparse_bound_ms"],
        bound_by="bytes", library_ms=None, ms_by_size=by_size)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def attention_layers(cfg) -> int:
    """Attention layers in the stack: the flash launches of one prefill."""
    return sum(periods * sum(l.kind == "attn" for l in layout)
               for layout, periods in cfg.stages())


def serve_path(phase: str, cfg, dev: torch.device,
               baseline: bool = False) -> dict[str, dict[str, int]]:
    """Serve ``cfg`` at its width and depth through ``serve.generate``.

    Weights from ``SEED`` on the card, SERVE_B Zipf prompts of SERVE_PLEN
    tokens (a VLM's after min(num_patch_tokens, SERVE_PLEN // 2) standard
    normal patch embeddings from ``SEED``, as the serve CLI draws them), one
    2-token warm-up (cuBLAS, the allocator; for a MoE model it also records
    the first MoE layer's prefill routing), then SERVE_GEN tokens with the
    launch counts zeroed just before and read just after. Emits one line,
    checks it, frees the weights; returns the launches by path: ``phase``'s,
    and with ``baseline`` also those of ``window_baseline`` on the same
    weights (path ``phase + "_baseline"``)."""
    import gc

    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import model_spec
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.param import tree_materialize

    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    params = tree_materialize(model_spec(cfg), torch.Generator(device=dev).manual_seed(SEED),
                              dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = make_token_dataset(SERVE_B * SERVE_PLEN, cfg.vocab_size, 0).reshape(
        SERVE_B, SERVE_PLEN)
    patches, n_patch = None, 0
    if cfg.frontend == "vision_stub":
        n_patch = min(cfg.num_patch_tokens, SERVE_PLEN // 2)
        patches = np.random.default_rng(SEED).standard_normal(
            (SERVE_B, n_patch, cfg.d_model)).astype(np.float32)
    routings, real_route = [], moe_lib.route
    if cfg.num_experts:
        moe_lib.route = lambda *a: routings.append(real_route(*a)) or routings[-1]
    try:
        serve.generate(params, prompts, cfg, 2, patch_embeds=patches, device=dev)  # warm-up
    finally:
        moe_lib.route = real_route
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gen_res = serve.generate(params, prompts, cfg, SERVE_GEN, patch_embeds=patches, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    extra = {}
    if routings:  # the first MoE layer's prefill (N = B x prompt tokens)
        r = routings[0]
        load = torch.bincount(r.top_e.reshape(-1), minlength=cfg.num_experts)
        extra = dict(experts=cfg.num_experts, top_k=cfg.experts_per_token,
                     capacity=moe_lib.capacity(SERVE_B * SERVE_PLEN, cfg),
                     capacity_factor=cfg.moe_capacity_factor,
                     layer0_slots_dropped_share=float((~r.keep).float().mean()),
                     layer0_max_expert_load=int(load.max()),
                     layer0_experts_unused=int((load == 0).sum()),
                     layer0_aux=float(r.aux))
    windows = [l.window for layout, n in cfg.stages() for l in layout * n]
    if any(windows):  # ring caches of `window` slots for the windowed layers
        W = max(w for w in windows if w)
        kv_bytes = 2 * SERVE_B * cfg.num_kv_heads * cfg.resolved_head_dim * 2
        extra.update(window=W, windowed_layers=sum(w is not None for w in windows),
                     ring_cache_gb=sum(w is not None for w in windows) * W * kv_bytes / 1e9,
                     linear_cache_gb=sum(w is None for w in windows)
                     * (SERVE_PLEN + n_patch + SERVE_GEN) * kv_bytes / 1e9)
    if n_patch:
        extra.update(patch_tokens=n_patch)
    want_flash = attention_layers(cfg)
    emit(phase, arch=cfg.arch_id, layers=cfg.num_layers, d_model=cfg.d_model,
         dtype=cfg.param_dtype, batch=SERVE_B, prompt_len=SERVE_PLEN, gen=SERVE_GEN,
         max_seq=SERVE_PLEN + n_patch + SERVE_GEN, mem_before_gb=mem_before, init_s=init_s,
         prefill_s=gen_res.prefill_s,
         decode_ms_per_token=gen_res.decode_s / (SERVE_GEN - 1) * 1e3, wall_s=wall,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         prefill_flash_launches=gen_res.prefill_flash_launches,
         decode_flash_launches=gen_res.decode_flash_launches,
         logits_finite=gen_res.logits_finite, tokens_row0=gen_res.tokens[0].tolist(),
         launches=launches, **extra)
    check(gen_res.prefill_flash_launches == want_flash,
          f"{phase}: prefill launched the flash kernel {gen_res.prefill_flash_launches} "
          f"times, want one per attention layer ({want_flash})")
    check(gen_res.decode_flash_launches == 0, f"{phase}: decode launched no flash kernel")
    check(launches["flash_attention_fwd"] == want_flash,
          f"{phase}: the path launched the flash kernel once per attention layer")
    check(gen_res.logits_finite, f"{phase}: all logits finite")
    check(gen_res.tokens.shape == (SERVE_B, SERVE_GEN), f"{phase}: generated (B, gen) tokens")
    paths = {phase: launches}
    if baseline:
        paths[phase + "_baseline"] = window_baseline(phase + "_baseline", params, prompts, cfg,
                                                     dev, gen_res.prefill_s)
    del params, routings, gen_res
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def window_baseline(phase: str, params: dict, prompts: np.ndarray, cfg, dev: torch.device,
                    generate_prefill_s: float) -> dict[str, int]:
    """The windowed model's prefill with ``exploit_window=False`` (the JAX
    package's baseline: every windowed layer's flash launch loads each tile
    up to the diagonal and leaves the window to the mask) on the weights
    already loaded, against the exploiting prefill, in turns (exploiting,
    baseline, baseline, exploiting), each timed to a synchronize. The logits
    must be equal bit for bit and the baseline must launch the flash kernel
    once per attention layer; its first run is the path (launch counts zeroed
    just before it, read just after). Returns that run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import prefill

    batch = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.int64, device=dev)}
    secs: dict[bool, list[float]] = {True: [], False: []}
    logits, path = {}, None
    for exploit in (True, False, False, True):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        lg, caches, _ = prefill(params, batch, cfg, max_seq=SERVE_PLEN + SERVE_GEN,
                                exploit_window=exploit)
        torch.cuda.synchronize()
        secs[exploit].append(time.perf_counter() - t0)
        if not exploit and path is None:
            path = dict(ops.LAUNCHES)
        logits.setdefault(exploit, lg)
        del caches, lg
    equal = bool(torch.equal(logits[True], logits[False]))
    want = attention_layers(cfg)
    windows = [l.window for layout, n in cfg.stages() for l in layout * n]
    emit(phase, arch=cfg.arch_id, layers=cfg.num_layers, batch=SERVE_B, prompt_len=SERVE_PLEN,
         windowed_layers=sum(w is not None for w in windows), window=max(w or 0 for w in windows),
         prefill_s_exploiting=secs[True], prefill_s_baseline=secs[False],
         generate_prefill_s=generate_prefill_s,
         baseline_over_exploiting=min(secs[False]) / min(secs[True]),
         logits_equal_bitwise=equal,
         max_abs_diff=float((logits[True] - logits[False]).abs().max()),
         logits_finite=bool(torch.isfinite(logits[False]).all()), launches=path)
    check(equal, f"{phase}: the baseline's logits equal the exploiting prefill's bit for bit")
    check(path["flash_attention_fwd"] == want,
          f"{phase}: the baseline launched the flash kernel once per attention layer ({want})")
    return path


def flash_tiles(S: int, window: int | None, exploit_window: bool = True) -> int:
    """K/V tiles that the bf16 kernel loads for one (batch, head) in a causal
    launch: 128-row query blocks, 128-key tiles from k_lo (the first query's
    window, 0 for a full-range launch) to the diagonal."""
    total = 0
    for q0 in range(0, S, 128):
        k_hi = (min(q0 + 128, S) - 1) // 128 + 1
        k_lo = max(0, q0 - window + 1) // 128 if window and exploit_window else 0
        total += k_hi - k_lo
    return total


def _heads_first(q, k_, v_):
    """(B, S, KV, G, hd) q and (B, S, KV, hd) k, v as (B, H, S, hd) copies,
    query head kv * G + g: the layout of PyTorch's attention calls."""
    B_, S_, KV_, G_, hd_ = q.shape
    return (q.reshape(B_, S_, KV_ * G_, hd_).transpose(1, 2).contiguous(),
            k_.transpose(1, 2).contiguous(), v_.transpose(1, 2).contiguous())


def _softcap_score(score, b, h, q_idx, kv_idx):
    return SOFTCAP * torch.tanh(score / SOFTCAP)


def flex_capped(q, k_, v_, causal: bool, window: int | None, sm_scale: float,
                mine: torch.Tensor) -> dict:
    """The library yardstick of a capped launch (timed only, never used on a
    path): compiled ``flex_attention`` with ``score_mod`` = cap * tanh(s /
    cap), the causal flag and the window as a block mask, GQA; its ms and
    its largest difference from the kernel's output ``mine``."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    S_ = q.shape[1]

    def keep(b, h, q_idx, kv_idx):
        if causal and window:
            return (q_idx >= kv_idx) & (q_idx - kv_idx < window)
        return q_idx >= kv_idx if causal else q_idx - kv_idx < window

    mask = (create_block_mask(keep, None, None, S_, S_, device=q.device)
            if causal or window else None)
    qs, ks, vs = _heads_first(q, k_, v_)
    flex = torch.compile(flex_attention)

    def call():
        return flex(qs, ks, vs, score_mod=_softcap_score, block_mask=mask, scale=sm_scale,
                    enable_gqa=True)

    t0 = time.perf_counter()
    got = call().transpose(1, 2).reshape(q.shape)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    diff = float((got.float() - mine.float()).abs().max())
    return dict(library_ms=time_ms(call, warmup=2, reps=10), library_max_abs_diff=diff,
                library_compile_s=compile_s,
                library="torch.compile(flex_attention)(score_mod=cap*tanh(s/cap), "
                        "block_mask=causal/window, enable_gqa=True)")


def flash_softcap_phase(dev: torch.device, gen: torch.Generator, shapes: dict) -> dict:
    """kernel_flash_attention_softcap: both kernels' capped instantiations
    (cap SOFTCAP, sm_scale CAP_SCALE times the model's) against the plain
    version, with and without the lse, at each of ``shapes`` (label: (shape,
    causal, window)), in both dtypes; bf16 timed beside the capless launch
    at the same inputs and scale and beside compiled ``flex_attention``
    with the cap as its ``score_mod`` (:func:`flex_capped`). Tolerances: kernel 3's (float32 rtol 1e-5
    / atol 1e-5; the lse rtol 1e-5 with atol 2e-5 / 1e-4) and in bf16 atol
    3e-2 plus one bf16 step of the value (rtol 2^-7): at the larger scale a
    row's softmax is nearly one key's, so outputs reach that key's value, up
    to ~5 for standard normal v, where both sides' rounding to bf16 may
    differ by one step, 2^-5 = 0.03125."""
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.hlo_analysis import flash_flops

    tol = {"float32": 1e-5, "bfloat16": 3e-2}
    lse_tol = {"float32": 2e-5, "bfloat16": 1e-4}
    rows, worst = {}, {"float32": 0.0, "bfloat16": 0.0}
    for label, (shape, causal, window) in shapes.items():
        B_, S_, KV_, G_, hd_ = (shape[k] for k in ("B", "S", "KV", "G", "hd"))
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).removeprefix("torch.")
            q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(dtype)
            k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            kw = dict(causal=causal, window=window, sm_scale=CAP_SCALE * hd_**-0.5)
            out, lse = ops.flash_attention_fwd(q, k_, v_, softcap=SOFTCAP, return_lse=True, **kw)
            want, want_lse = ref.flash_attention_fwd_ref(q, k_, v_, softcap=SOFTCAP,
                                                         return_lse=True, **kw)
            alone = ops.flash_attention_fwd(q, k_, v_, softcap=SOFTCAP, **kw)
            torch.cuda.synchronize()
            rtol = 1e-5 if dtype == torch.float32 else 2**-7
            err = float((out.float() - want.float()).abs().max())
            lse_err = float((lse - want_lse).abs().max())
            capless = ref.flash_attention_fwd_ref(q, k_, v_, **kw)
            row = dict(
                shape=shape, causal=causal, window=window, dtype=name, softcap=SOFTCAP,
                sm_scale=kw["sm_scale"], max_abs_err=err, rtol=rtol, atol=tol[name],
                lse_max_abs_err=lse_err,
                within=bool(torch.allclose(out.float(), want.float(), rtol=rtol,
                                           atol=tol[name])),
                lse_within=bool(torch.allclose(lse, want_lse, rtol=1e-5, atol=lse_tol[name])),
                out_unchanged_by_lse=bool(torch.equal(out, alone)),
                cap_moves_output_by=float((want.float() - capless.float()).abs().max()))
            del want, want_lse, capless, alone, lse
            if dtype == torch.bfloat16:
                nbytes = 2 * q.numel() * q.element_size() + 2 * k_.numel() * k_.element_size()
                flops = flash_flops(tuple(q.shape), causal, window)
                row.update(
                    ms=time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, softcap=SOFTCAP, **kw),
                               warmup=2, reps=10),
                    ms_with_lse=time_ms(lambda: ops.flash_attention_fwd(
                        q, k_, v_, softcap=SOFTCAP, return_lse=True, **kw), warmup=2, reps=10),
                    capless_ms=time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, **kw),
                                       warmup=2, reps=10),
                    plain_ms=time_ms(lambda: ref.flash_attention_fwd_ref(
                        q, k_, v_, softcap=SOFTCAP, **kw), warmup=1, reps=3),
                    **flex_capped(q, k_, v_, causal, window, kw["sm_scale"], out),
                    bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
                    bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
                    else "bytes")
            worst[name] = max(worst[name], err)
            rows[f"{label}_{name}"] = row
            emit("kernel_flash_attention_softcap", at=label, **row)
            check(row["within"], f"capped flash within tolerance ({label}, {name}: {err})")
            check(row["lse_within"], f"capped flash lse within tolerance ({label}, {name})")
            check(row["out_unchanged_by_lse"], f"capped flash output unchanged by the lse "
                  f"({label}, {name})")
            del q, k_, v_, out
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, by_shape=rows)


def sdpa_window(q, k_, v_, window: int, mine: torch.Tensor) -> dict:
    """The library yardstick of a causal windowed launch at a length where no
    score matrix fits (timed only, never used on a path): SDPA's
    memory-efficient backend with the window as an (S, S) boolean mask (1
    GiB at S 32,768); its ms and its largest difference from ``mine``. The
    backend takes no GQA with a mask (torch 2.11: "both fused kernels
    require query, key and value to have the same num_heads"), so k and v
    are repeated to the query heads first, outside the timing: the same
    function."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    S_ = q.shape[1]
    i = torch.arange(S_, device=q.device)[:, None]
    j = torch.arange(S_, device=q.device)[None, :]
    mask = (i - j < window) & (j <= i)
    qs, ks, vs = _heads_first(q, k_, v_)
    G_ = q.shape[3]
    ks, vs = ks.repeat_interleave(G_, dim=1), vs.repeat_interleave(G_, dim=1)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def call():
        return sdpa(qs, ks, vs, attn_mask=mask)

    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        diff = float((call().transpose(1, 2).reshape(q.shape).float() - mine.float())
                     .abs().max())
        ms = time_ms(call, warmup=1, reps=3)
    return dict(library_ms=ms, library_max_abs_diff=diff,
                library="scaled_dot_product_attention(attn_mask=window) on "
                        "SDPBackend.EFFICIENT_ATTENTION, k and v repeated to the query heads")


def flash_full_range_phase(dev: torch.device, gen: torch.Generator, shape: dict,
                           window: int) -> dict:
    """kernel_flash_attention_full_range: the full-range launch (the model's
    exploit_window=False) at gemma3's local shape against the plain version
    (both dtypes) and against the windowed launch bit for bit, output and
    lse; then at B 1, S FULL_RANGE_S the two launches against each other
    only (the plain version would build a (KV G, S, S) float32 score tensor
    of ~137 GB). bf16 timed both ways beside the tiles each loads, and at S
    FULL_RANGE_S beside SDPA with the window's boolean mask."""
    from repro_torch.kernels import ops, ref

    tol = {"float32": 1e-5, "bfloat16": 3e-2}
    rows = {}
    for label, sh in (("gemma3_local", shape),
                      (f"gemma3_local_{FULL_RANGE_S}", dict(shape, B=1, S=FULL_RANGE_S))):
        B_, S_, KV_, G_, hd_ = (sh[k] for k in ("B", "S", "KV", "G", "hd"))
        dtypes = (torch.float32, torch.bfloat16) if S_ < FULL_RANGE_S else (torch.bfloat16,)
        for dtype in dtypes:
            name = str(dtype).removeprefix("torch.")
            q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(dtype)
            k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            kw = dict(causal=True, window=window)
            full, full_lse = ops.flash_attention_fwd(q, k_, v_, exploit_window=False,
                                                     return_lse=True, **kw)
            win, win_lse = ops.flash_attention_fwd(q, k_, v_, return_lse=True, **kw)
            torch.cuda.synchronize()
            row = dict(shape=sh, window=window, dtype=name,
                       bitwise_equal_windowed=bool(torch.equal(full, win)),
                       lse_bitwise_equal_windowed=bool(torch.equal(full_lse, win_lse)),
                       max_abs_diff_windowed=float((full.float() - win.float()).abs().max()))
            if S_ < FULL_RANGE_S:
                want = ref.flash_attention_fwd_ref(q, k_, v_, **kw)
                rtol = 1e-5 if dtype == torch.float32 else 0.0
                row.update(max_abs_err=float((full.float() - want.float()).abs().max()),
                           within=bool(torch.allclose(full.float(), want.float(), rtol=rtol,
                                                      atol=tol[name])))
                del want
            if dtype == torch.bfloat16:
                tiles = {e: flash_tiles(S_, window, e) for e in (True, False)}
                row.update(
                    ms_full_range=time_ms(lambda: ops.flash_attention_fwd(
                        q, k_, v_, exploit_window=False, **kw), warmup=2, reps=10),
                    ms_windowed=time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, **kw),
                                        warmup=2, reps=10),
                    tiles_full_range=tiles[False], tiles_windowed=tiles[True],
                    tile_ratio=tiles[False] / tiles[True])
                row["time_ratio"] = row["ms_full_range"] / row["ms_windowed"]
                if S_ == FULL_RANGE_S:
                    row.update(sdpa_window(q, k_, v_, window, win))
            rows[f"{label}_{name}"] = row
            emit("kernel_flash_attention_full_range", at=label, **row)
            check(row["bitwise_equal_windowed"] and row["lse_bitwise_equal_windowed"],
                  f"the full-range launch equals the windowed one bit for bit ({label}, {name})")
            check(row.get("within", True), f"the full-range launch within tolerance of the "
                  f"plain version ({label}, {name})")
            del q, k_, v_, full, win, full_lse, win_lse
    torch.cuda.empty_cache()
    return rows


def has_name(name: str) -> bool:
    """Whether the dotted ``name`` exists: its longest importable module
    prefix, then attributes."""
    import importlib

    parts = name.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            if not hasattr(obj, attr):
                return False
            obj = getattr(obj, attr)
        return True
    return False


def analyze_phase(dev: torch.device, problem) -> dict[str, int]:
    """analyze: the port's static analyzer on the card. Its run contracts at
    the JAX package's toy sizes (``run_contracts()``: one capture per run
    signature, launches linear in R, two replays under sync debug mode
    "error", the carries in place, the sweep buckets sharing a graph), then
    the lockstep and LAG contracts on ``problem`` (RCV1 width, H 1,000, R 3
    and 6), whose captured graphs launch ``sdca_inner`` at full width; that
    every spelling of the ``version-floor`` rule is missing from this
    torch; the lint of ``src/repro_torch`` against its baseline; and ``python -m
    repro_torch analyze`` in a subprocess. Every verdict must be ok. Returns
    the phase's launches (the counts are zeroed at its start)."""
    from repro_torch.analysis import contracts, lint
    from repro_torch.analysis.findings import Baseline
    from repro_torch.core import executor
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    toy = contracts.run_contracts(device=dev)
    emit("analyze_contracts", size="toy K 2, n_k 3, d 4, R 3 and 6",
         seconds=time.perf_counter() - t0,
         verdicts={r.name: r.ok for r in toy}, details={r.name: r.detail for r in toy})
    for r in toy:
        check(r.ok, f"analyze (toy): {r.format()}")
    for stat, check_fn in (("lockstep", contracts.check_lockstep_contracts),
                           ("lag", contracts.check_lag_contracts)):
        t0 = time.perf_counter()
        results = check_fn(dev, problem=problem, H=H, rounds=(3, 6))
        graph = executor.last_graph(stat)
        emit("analyze_contracts_rcv1", path=stat, shape=dict(K=K, n_k=N_K, d=D, H=H),
             rounds=[3, 6], seconds=time.perf_counter() - t0,
             verdicts={r.name: r.ok for r in results},
             details={r.name: r.detail for r in results},
             graph_launches_r6=dict(graph.launches), capture_ms_r6=graph.capture_ms)
        for r in results:
            check(r.ok, f"analyze (RCV1 width): {r.format()}")
        check(graph.launches["sdca_inner"] > 0,
              f"analyze: the captured {stat} graph launches sdca_inner")
    launches = dict(ops.LAUNCHES)
    # version-floor's table: every spelling still missing from this torch.
    floor = lint.get_rule("version-floor")
    present = [n for n in sorted(floor.BANNED) if has_name(n)] + [
        f"Tensor.{m}" for m in sorted(floor.TENSOR_METHODS) if hasattr(torch.Tensor, m)]
    emit("analyze_version_floor", torch=torch.__version__,
         spellings=len(floor.BANNED) + len(floor.TENSOR_METHODS), present_here=present)
    check(not present, f"analyze: version-floor's spellings are missing from this torch "
          f"(present: {present})")
    t0 = time.perf_counter()
    found = lint.lint_paths([ROOT / "src" / "repro_torch"], root=ROOT)
    new, accepted, stale = Baseline.load(ROOT / "ANALYSIS_BASELINE_TORCH.json").split(found)
    emit("analyze_lint", rules=list(lint.default_rules()), findings=len(found), new=len(new),
         accepted=len(accepted), stale=len(stale), seconds=time.perf_counter() - t0,
         files=len(list((ROOT / "src" / "repro_torch").rglob("*.py"))))
    check(not new and not stale, "analyze: the port lints clean against its baseline")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch", "analyze"], capture_output=True,
                          text=True, timeout=600, env=env, cwd=ROOT)
    emit("analyze_cli", returncode=proc.returncode, wall_s=time.perf_counter() - t0,
         last_line=(proc.stdout.splitlines() or [""])[-1], stderr_tail=proc.stderr[-400:])
    check(proc.returncode == 0, "python -m repro_torch analyze exits 0 on the card")
    return launches


def dryrun_phase(dev: torch.device) -> dict:
    """dryrun: ``repro_torch.launch.dryrun`` for every (architecture x input
    shape) on one card (the abstract record on meta tensors, one line each),
    then each combination whose resident bytes fit the card run once at its
    full shape (``dryrun_run``): its peak memory must be at least the
    resident estimate and its output finite, or it ran out of memory, which
    is recorded (the estimate counts no activation beyond remat's period
    inputs). Returns the seconds of both parts and the runs' outcomes."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, get_config
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    capacity = torch.cuda.mem_get_info(dev)[1]
    records = []
    for arch in ARCH_IDS:
        for shape in INPUT_SHAPES:
            rec = dryrun.run_one(arch, shape, device=dev, capacity=capacity)
            records.append(rec)
            emit("dryrun", **dryrun.summary(rec))
    abstract_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outcomes = {}
    for rec in records:
        if rec["status"] != "ok" or not rec["fits"]:
            continue
        run = dryrun.run_step(get_config(rec["arch"]), INPUT_SHAPES[rec["shape"]], dev,
                              seed=SEED)
        key = f"{rec['arch']}/{rec['shape']}"
        outcomes[key] = run["status"]
        emit("dryrun_run", arch=rec["arch"], shape=rec["shape"],
             resident_bytes=rec["resident_bytes"], capacity_bytes=capacity,
             resident_parts=rec["roofline"]["memory_stats"], **run)
        if run["status"] == "ran":
            check(run["peak_bytes"] >= rec["resident_bytes"],
                  f"dryrun {key}: the measured peak holds the resident estimate")
            check(run["finite"], f"dryrun {key}: the step's output is finite")
    run_s = time.perf_counter() - t0
    emit("dryrun_seconds", combinations=len(records), abstract_s=abstract_s, run_s=run_s,
         outcomes=outcomes)
    check(len(records) == len(ARCH_IDS) * len(INPUT_SHAPES) and all(
        r["status"] in ("ok", "skipped") for r in records), "dryrun: a record per combination")
    check("ran" in outcomes.values(), "dryrun: a combination that fits ran on the card")
    return dict(abstract_s=abstract_s, run_s=run_s, outcomes=outcomes)


def consistency_path(phase: str, cfg, dev: torch.device, rtol: float, atol: float,
                     **fields) -> dict[str, int]:
    """Logits at position SERVE_PLEN from one prefill over SERVE_PLEN + 1
    tokens (a ragged last tile, chunk) against a prefill over SERVE_PLEN and
    one decode step, on the card, weights from ``SEED``."""
    import gc

    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, model_spec, prefill
    from repro_torch.models.param import tree_materialize

    p2 = tree_materialize(model_spec(cfg), torch.Generator(device=dev).manual_seed(SEED), dev)
    toks = torch.as_tensor(make_token_dataset(SERVE_PLEN + 1, cfg.vocab_size, 1),
                           device=dev).long()[None]
    ops.reset_launch_counts()
    whole, _, _ = prefill(p2, {"tokens": toks}, cfg, max_seq=SERVE_PLEN + 1)
    _, caches, plen = prefill(p2, {"tokens": toks[:, :SERVE_PLEN]}, cfg,
                              max_seq=SERVE_PLEN + 1)
    stepped, _ = decode_step(p2, toks[:, SERVE_PLEN], caches, plen + 1, cfg)
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    diff = float((whole - stepped).abs().max())
    close = bool(torch.allclose(stepped, whole, rtol=rtol, atol=atol))
    same = bool(torch.equal(whole.argmax(-1), stepped.argmax(-1)))
    emit(phase, arch=cfg.arch_id, layers=cfg.num_layers, dtype=cfg.param_dtype, batch=1,
         prompt_len=SERVE_PLEN + 1, max_abs_diff=diff,
         max_abs_logit=float(whole.abs().max()), rtol=rtol, atol=atol, within=close,
         same_argmax=same, launches=launches, **fields)
    check(launches["flash_attention_fwd"] == 2 * attention_layers(cfg),
          f"{phase}: both prefills used the kernel once per attention layer")
    check(close, f"{phase}: prefill over S+1 tokens agrees with prefill over S plus one "
          "decode step")
    check(same, f"{phase}: the same argmax")
    del p2, caches
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def fan_in_params(params: dict, cfg) -> dict:
    """``params`` with every stacked ``normal`` leaf of the init rule (drawn
    with std 1/sqrt(layers), ROADMAP C3) rescaled to std 1/sqrt(fan_in), its
    second-to-last dim: the same draw at a well-conditioned scale."""
    from repro_torch.models import model_spec

    def rescale(p, s):
        if isinstance(p, dict):
            return {k: rescale(p[k], s[k]) for k in p}
        if s.init == "normal" and s.scale is None and len(s.shape) >= 3:
            return (p.float() * math.sqrt(s.shape[0] / s.shape[-2])).to(p.dtype)
        return p

    return rescale(params, model_spec(cfg))


def hybrid_small(dev: torch.device) -> dict[str, int]:
    """jamba's reduced() stack (attention, SSD, dense and MoE layers in one
    period), float32, at the init rule's weights and at the fan-in init
    (``fan_in_params``): prefill and HYBRID_STEPS decode steps (fed the next
    prompt-stream tokens) on the card against the same on the host, the
    flash kernel once per attention layer per prefill on the card. The
    card's largest logit difference must stay within HYBRID_BAND times the
    host's own under a one-ulp shift of every SSD step size dt (the
    stack's rounding sensitivity, measured here), with the same argmax at
    every step; agreement within HYBRID_TOL is printed beside it."""
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import ops
    from repro_torch.models import decode_step, model_spec, prefill
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.param import tree_map, tree_materialize

    cfg = get_config(HYBRID_ARCH).reduced()
    cpu = torch.device("cpu")
    stream = torch.as_tensor(make_token_dataset(
        HYBRID_B * (HYBRID_PLEN + HYBRID_STEPS), cfg.vocab_size, 2)).long().reshape(
            HYBRID_B, HYBRID_PLEN + HYBRID_STEPS)

    def run(params, where):
        toks = stream.to(where)
        logits, caches, plen = prefill(params, {"tokens": toks[:, :HYBRID_PLEN]}, cfg,
                                       max_seq=HYBRID_PLEN + HYBRID_STEPS)
        out = [logits]
        for i in range(HYBRID_STEPS):
            logits, caches = decode_step(params, toks[:, HYBRID_PLEN + i], caches,
                                         plen + 1 + i, cfg)
            out.append(logits)
        return [t.cpu() for t in out]

    def max_diffs(a, b):
        return [float((x - y).abs().max()) for x, y in zip(a, b)]

    rows = {}
    ops.reset_launch_counts()  # the host's runs launch nothing
    for init in ("rule", "fan_in"):
        p_cpu = tree_materialize(model_spec(cfg), torch.Generator().manual_seed(SEED), cpu)
        if init == "fan_in":
            p_cpu = fan_in_params(p_cpu, cfg)
        want = run(p_cpu, cpu)
        got = run(tree_map(lambda t: t.to(dev), p_cpu), dev)
        torch.cuda.synchronize()
        real = ssm_lib._softplus
        ssm_lib._softplus = lambda x: real(x) * (1 + 2**-23)
        try:
            shifted = max_diffs(run(p_cpu, cpu), want)
        finally:
            ssm_lib._softplus = real
        diffs, band = max_diffs(got, want), HYBRID_BAND * max(shifted)
        rows[init] = dict(
            max_abs_diff_by_step=diffs, host_dt_one_ulp_max_abs_diff_by_step=shifted,
            band=band, within_band=max(diffs) <= band,
            max_abs_logit=float(max(w.abs().max() for w in want)),
            within_tol=[bool(torch.allclose(g, w, rtol=HYBRID_TOL, atol=HYBRID_TOL))
                        for g, w in zip(got, want)],
            same_argmax=[bool(torch.equal(g.argmax(-1), w.argmax(-1)))
                         for g, w in zip(got, want)])
    launches = dict(ops.LAUNCHES)
    emit("hybrid_small", arch=cfg.arch_id, reduced=True, layers=cfg.num_layers,
         d_model=cfg.d_model, experts=cfg.num_experts,
         period=[f"{l.kind}+{l.mlp}" for l in cfg.layout], dtype=cfg.param_dtype,
         batch=HYBRID_B, prompt_len=HYBRID_PLEN, decode_steps=HYBRID_STEPS,
         band_factor=HYBRID_BAND, tol=HYBRID_TOL, launches=launches, **rows)
    check(launches["flash_attention_fwd"] == 2 * attention_layers(cfg),
          f"hybrid_small: each card prefill launched the flash kernel once per attention "
          f"layer ({attention_layers(cfg)}), got {launches['flash_attention_fwd']} in two")
    for init, row in rows.items():
        check(row["within_band"], f"hybrid_small: card within {HYBRID_BAND} x the host's "
              f"one-ulp shift of the host ({init}: {max(row['max_abs_diff_by_step'])} against "
              f"{row['band']})")
        check(all(row["same_argmax"]), f"hybrid_small: the same argmax at every step ({init})")
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # torch.compile's caches (the flex_attention yardstick) stay in the checkout.
    for var, sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, str(ROOT / ".compile_cache" / sub))
    from repro_torch.api import problems
    from repro_torch.api.session import EvalEvent, RoundEvent, Session
    from repro_torch.core import acpd, baselines, engine, filter as msg_filter, objectives, sdca
    from repro_torch.core.simulate import ClusterModel
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref, sdca_inner as sdca_mod
    from repro_torch.kernels import topk_filter as topk_mod
    from repro_torch.kernels import exchange_threshold as thr_mod
    from repro_torch.launch.hlo_analysis import flash_flops
    from repro_torch.models import model_spec
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
    sources = ("sdca_inner", "topk_filter", "flash_attn", "exchange_threshold", "exchange_apply")
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

    # -- main path 7: serve the MoE and SSM models at full width and depth ---
    # First, while the card holds nothing else: qwen3-moe-30b-a3b's weights
    # alone are 61.09 GB. Then the consistency checks and the hybrid stack.
    launches: dict[str, dict[str, int]] = {}
    launches.update(serve_path("serve_moe", get_config(MOE_ARCH), dev))
    # -- main path 8: sliding windows and ring caches, the vision frontend --
    # gemma3-27b's 56.84 GB of weights, next while the card is empty again.
    t0 = time.perf_counter()
    # ... and on the same weights its exploit_window=False baseline.
    launches.update(serve_path("serve_window", get_config(WINDOW_ARCH), dev, baseline=True))
    emit("phase_seconds", path="serve_window", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    wcfg = dataclasses.replace(get_config(WINDOW_ARCH), num_layers=WINDOW_CONSIST_LAYERS,
                               param_dtype="float32", compute_dtype="float32")
    consistency_path("serve_consistency_window", wcfg, dev, 1e-3, 1e-3,
                     window=wcfg.layout[0].window,
                     period=[l.window for l in wcfg.layout],
                     note="prompt past the window: prefill leaves the rings wrapped and the "
                     "decode step overwrites each ring's oldest slot")
    emit("phase_seconds", path="serve_consistency_window", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    consistency_path("serve_consistency_window_softcap",
                     dataclasses.replace(wcfg, attn_logit_softcap=SOFTCAP), dev, 1e-3, 1e-3,
                     window=wcfg.layout[0].window, softcap=SOFTCAP,
                     note="the capped flash kernel in prefill against the capped decode "
                     "(attend_cache) over wrapped rings")
    emit("phase_seconds", path="serve_consistency_window_softcap",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    launches.update(serve_path("serve_vision", get_config(VISION_ARCH), dev))
    emit("phase_seconds", path="serve_vision", seconds=time.perf_counter() - t0)
    consistency_path(
        "serve_consistency_moe", dataclasses.replace(
            get_config(MOE_ARCH), num_layers=CONSIST_LAYERS, param_dtype="float32",
            compute_dtype="float32", moe_capacity_factor=MOE_CONSIST_CF),
        dev, 1e-3, 1e-3, moe_capacity_factor=MOE_CONSIST_CF,
        note="capacity factor 16: C > N, so no slot drops in either prefill")
    launches.update(serve_path("serve_ssm", get_config(SSM_ARCH), dev))
    consistency_path(
        "serve_consistency_ssm", dataclasses.replace(
            get_config(SSM_ARCH), num_layers=CONSIST_LAYERS, param_dtype="float32",
            compute_dtype="float32"),
        dev, SSM_RTOL, SSM_ATOL, note="chunked SSD against the one-step recurrence")
    launches["hybrid_small"] = hybrid_small(dev)

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

    # -- kernel 4: exchange_threshold at the exchange cell's leaf sizes ------
    thr_by_size = {}
    for n_leaf in THRESHOLD_SIZES:
        x = torch.randn(n_leaf, generator=gen, device=dev).mul_(THRESHOLD_SIGMA)
        k_leaf = max(1, int(n_leaf * THRESHOLD_RHO))
        for refine in (True, False):
            got = ops.exchange_threshold(x, k_leaf, refine)
            want = thr_mod.exchange_threshold_plain(x, k_leaf, refine)
            equal = bool(torch.equal(got.view(torch.int32), want.view(torch.int32)))
            emit("kernel_exchange_threshold_check", n=n_leaf, k=k_leaf, refine=refine,
                 threshold=float(got), plain=float(want), bits_equal_plain=equal)
            check(equal, f"exchange_threshold equals its plain rounds bit for bit "
                  f"(n {n_leaf}, refine {refine})")
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ops.exchange_threshold(x, k_leaf)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            ops.exchange_threshold(x, k_leaf)
            torch.cuda.synchronize()
        split: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                split[e.name] = split.get(e.name, 0.0) + e.device_time_total / 1e3
        check(len(split) == 3 and all("exchange_threshold" in k for k in split),
              f"one refined exchange_threshold call ran three named kernels: {list(split)}")
        lim = 10 * THRESHOLD_SIGMA
        nbytes = 12 * n_leaf  # x read by the max pass and both rounds
        thr_by_size[n_leaf] = row = dict(
            k=k_leaf, ms=time_ms(lambda: ops.exchange_threshold(x, k_leaf), warmup=3, reps=20),
            ms_unrefined=time_ms(lambda: ops.exchange_threshold(x, k_leaf, False),
                                 warmup=3, reps=20),
            plain_ms=time_ms(lambda: thr_mod.exchange_threshold_plain(x, k_leaf),
                             warmup=2, reps=5),
            library_ms=time_ms(lambda: torch.histc(x, bins=65, min=-lim, max=lim),
                               warmup=3, reps=20),
            bound_ms=nbytes / PEAK_BYTES * 1e3, bound_bytes=nbytes, split_ms=split)
        emit("kernel_exchange_threshold", n=n_leaf, dtype="float32", refine=True,
             library="torch.histc(x, 65 bins)", **row)
        del x, got, want
    torch.cuda.empty_cache()
    at = thr_by_size[THRESHOLD_SIZES[0]]
    kernels["exchange_threshold"] = dict(
        name="exchange_threshold", route="cuda",
        source="src/repro_torch/csrc/exchange_threshold.cu",
        replaces="none: src/repro/core/compress.py threshold_for_topk is jnp",
        max_abs_err=0.0, n=THRESHOLD_SIZES[0], ms=at["ms"], plain_ms=at["plain_ms"],
        bound_ms=at["bound_ms"], bound_by="bytes", library_ms=at["library_ms"],
        ms_by_size={n: {m: r[m] for m in ("ms", "ms_unrefined", "plain_ms", "library_ms",
                                          "bound_ms")} for n, r in thr_by_size.items()})

    # -- kernel 5: the exchange's split at the exchange cells' largest leaves --
    kernels["exchange_apply"] = kernel_exchange_apply(dev, gen)

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

    # -- analyze: the static analyzer's run contracts on the captured graphs -
    t0 = time.perf_counter()
    launches["analyze"] = analyze_phase(dev, problem)
    emit("phase_seconds", path="analyze", seconds=time.perf_counter() - t0)

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

    # -- kernel 3: flash_attention_fwd at the serve shapes and a ragged S ----
    flash_err = {"float32": 0.0, "bfloat16": 0.0}
    tol = {"float32": 1e-5, "bfloat16": 3e-2}
    serve_shape = dict(B=SERVE_B, S=SERVE_PLEN, KV=8, G=5, hd=128)  # qwen3-14b's GQA
    moe_shape = dict(B=SERVE_B, S=SERVE_PLEN, KV=4, G=8, hd=128)  # qwen3-moe-30b-a3b's
    moe_err = {}
    cases = [(dict(serve_shape, B=2, S=1000), dt, c)
             for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    # The tensor-core kernel at another head dim (its swizzle) and G = 1.
    cases += [(dict(B=2, S=1000, KV=8, G=1, hd=64), torch.bfloat16, c) for c in (True, False)]
    cases += [(moe_shape, dt, True) for dt in (torch.float32, torch.bfloat16)]
    # The window and hd 80: gemma3-27b's local (W 1,024 at S 2,048)
    # and global shapes (KV 16, G 2), W 1,000 at S 1,000, W 37 at a ragged
    # S, hubert-xlarge's hd 80 (KV 16, G 1), causal and not, both dtypes.
    gemma_shape = dict(B=SERVE_B, S=SERVE_PLEN, KV=16, G=2, hd=128)
    hubert_shape = dict(B=TRAIN_B // 4, S=TRAIN_SEQ, KV=16, G=1, hd=80)
    new_cases = [(dict(gemma_shape, B=2), 1024), (dict(gemma_shape, B=2, S=1000), 1000),
                 (dict(gemma_shape, B=2, S=777), 37), (dict(hubert_shape, S=1000), None)]
    cases = [(sh, dt, c) for sh, dt, c in cases] + [
        (dict(sh, W=w) if w else sh, dt, c) for sh, w in new_cases
        for dt in (torch.float32, torch.bfloat16) for c in (True, False)]
    cases += [(gemma_shape, dt, True) for dt in (torch.float32, torch.bfloat16)]
    cases += [(serve_shape, dt, True) for dt in (torch.float32, torch.bfloat16)]
    # pixtral-12b's prefill (2,048 tokens after 1,024 patches: S = 3,072, G 4).
    pixtral_shape = dict(B=SERVE_B, S=SERVE_PLEN + SERVE_PLEN // 2, KV=8, G=4, hd=128)
    cases += [(pixtral_shape, dt, True) for dt in (torch.float32, torch.bfloat16)]
    new_err = {"float32": 0.0, "bfloat16": 0.0}  # the window and hd 80 cases
    for shape, dtype, causal in cases:
        B_, S_, KV_, G_, hd_ = (shape[k] for k in ("B", "S", "KV", "G", "hd"))
        W_ = shape.get("W")
        q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(dtype)
        k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
        v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
        out = ops.flash_attention_fwd(q, k_, v_, causal=causal, window=W_)
        want = ref.flash_attention_fwd_ref(q, k_, v_, causal=causal, window=W_)
        torch.cuda.synchronize()
        name = str(dtype).removeprefix("torch.")
        err = float((out.float() - want.float()).abs().max())
        rtol = 1e-5 if dtype == torch.float32 else 0.0
        within = bool(torch.allclose(out.float(), want.float(), rtol=rtol, atol=tol[name]))
        bitwise = bool(torch.equal(out, ops.flash_attention_fwd(q, k_, v_, causal=causal,
                                                                window=W_)))
        flash_err[name] = max(flash_err[name], err)
        if shape == moe_shape:
            moe_err[name] = err
        if W_ is not None or hd_ == 80 or shape in (gemma_shape, pixtral_shape):
            new_err[name] = max(new_err[name], err)
        emit("kernel_flash_attention_check", shape=shape, dtype=name, causal=causal,
             window=W_, max_abs_err=err, rtol=rtol, atol=tol[name], within=within,
             repeat_bitwise=bitwise)
        check(within, f"flash_attention_fwd within tolerance ({shape}, {name}, {causal})")
        check(bitwise, f"flash_attention_fwd repeats bit for bit ({shape}, {name})")
        if shape == moe_shape and dtype == torch.bfloat16:
            moe_qkv = (q, k_, v_)
        del q, k_, v_, out, want
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def flash_times(q, k_, v_, causal: bool = True, window: int | None = None) -> dict:
        """bfloat16: the kernel, the plain version, and SDPA on the (B, H, S,
        hd) layout (timed only, never used; with a window, one call with its
        boolean mask), beside the bound: q.k and p.v over the (query, key)
        pairs the mask lets through, counted from S, the causal flag and W."""
        kw = dict(causal=causal, window=window)
        out = ops.flash_attention_fwd(q, k_, v_, **kw)
        ms = time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, **kw), warmup=2, reps=10)
        plain_ms = time_ms(lambda: ref.flash_attention_fwd_ref(q, k_, v_, **kw),
                           warmup=1, reps=3)
        S_ = q.shape[1]
        qs, ks, vs = _heads_first(q, k_, v_)
        if window is None:
            lib_kw = dict(is_causal=causal)
        else:  # True where query i may attend to key j
            i = torch.arange(S_, device=q.device)[:, None]
            j = torch.arange(S_, device=q.device)[None, :]
            lib_kw = dict(attn_mask=(i - j < window) & ((j <= i) if causal else True))
        library_ms = time_ms(lambda: sdpa(qs, ks, vs, enable_gqa=True, **lib_kw),
                             warmup=2, reps=10)
        sdpa_err = float((sdpa(qs, ks, vs, enable_gqa=True, **lib_kw).transpose(1, 2)
                          .reshape(q.shape).float() - out.float()).abs().max())
        flops = flash_flops(tuple(q.shape), causal, window)  # the pairs the mask keeps
        nbytes = 2 * q.numel() * q.element_size() + 2 * k_.numel() * k_.element_size()
        return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    library_max_abs_diff=sdpa_err,
                    bound_ms=max(flops / PEAK_BF16, nbytes / PEAK_BYTES) * 1e3,
                    bound_by="operations" if flops / PEAK_BF16 >= nbytes / PEAK_BYTES
                    else "bytes", bound_flops=flops, bound_bytes=nbytes,
                    achieved_tflops=flops / (ms * 1e-3) / 1e12)

    B_, S_, KV_, G_, hd_ = (serve_shape[k] for k in ("B", "S", "KV", "G", "hd"))
    q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(torch.bfloat16)
    k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(torch.bfloat16)
    v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(torch.bfloat16)
    at_serve = flash_times(q, k_, v_)
    kernels["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda", source="src/repro_torch/csrc/flash_attn.cu",
        replaces="src/repro/kernels/flash_attn.py:86",
        max_abs_err=max(flash_err.values()),
        **{k: at_serve[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    emit("kernel_flash_attention", shape=serve_shape, dtype="bfloat16", causal=True,
         max_abs_err_by_dtype=flash_err,
         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
         **at_serve)
    at_moe = flash_times(*moe_qkv)
    emit("kernel_flash_attention_moe", shape=moe_shape, dtype="bfloat16", causal=True,
         max_abs_err_by_dtype=moe_err,
         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)", **at_moe)
    del q, k_, v_, moe_qkv
    torch.cuda.empty_cache()
    # The new paths' shapes, bf16: gemma3's windowed and global layers,
    # pixtral's prefill (S = 2,048 + 1,024 patches) and hubert's per-group
    # training forward (hd 80, not causal).
    at_new = {}
    for label, shape, causal, window in (
            ("gemma3_local", gemma_shape, True, 1024), ("gemma3_global", gemma_shape, True, None),
            ("pixtral", pixtral_shape, True, None),
            ("hubert_group", hubert_shape, False, None)):
        B_, S_, KV_, G_, hd_ = (shape[k] for k in ("B", "S", "KV", "G", "hd"))
        q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(torch.bfloat16)
        t0 = time.perf_counter()
        at_new[label] = dict(shape=shape, causal=causal, window=window,
                             **flash_times(q, k_, v_, causal, window))
        emit("kernel_flash_attention_" + label, dtype="bfloat16",
             library="scaled_dot_product_attention(enable_gqa=True"
             + (", attn_mask=window)" if window else f", is_causal={causal})"),
             seconds=time.perf_counter() - t0, **at_new[label])
        del q, k_, v_
    torch.cuda.empty_cache()

    # -- kernel 3c: the logit softcap and the full-range launch --------------
    t0 = time.perf_counter()
    at_cap = flash_softcap_phase(dev, gen, {
        "gemma3_local": (gemma_shape, True, 1024), "gemma3_global": (gemma_shape, True, None),
        "pixtral": (pixtral_shape, True, None), "hubert_group": (hubert_shape, False, None)})
    at_full = flash_full_range_phase(dev, gen, gemma_shape, 1024)
    emit("phase_seconds", path="kernel_flash_attention_softcap_full_range",
         seconds=time.perf_counter() - t0)

    # -- kernel 3b: the flash kernel at the training path's shapes, with lse --
    # At the serve shape and at codeqwen1.5-7b's per-group training shape
    # (8 rows over 4 groups: B 2, KV = 32, G = 1) with lse, and at the
    # monitored full-batch forward's (B 8) without it, both dtypes: the output
    # against the plain version's with kernel 3's tolerances, lse against the
    # plain logsumexp, the output with lse bit for bit the launch without, and
    # the launches timed.
    lse_tol = {"float32": 2e-5, "bfloat16": 1e-4}
    lse_err = {"float32": 0.0, "bfloat16": 0.0}
    out_err = {}  # by shape and dtype
    lse_ms = {}
    train_shape = dict(B=TRAIN_B // 4, S=TRAIN_SEQ, KV=32, G=1, hd=128)
    for label, shape, with_lse, causal, window in (
            ("serve", serve_shape, True, True, None), ("train", train_shape, True, True, None),
            ("train_monitored", dict(train_shape, B=TRAIN_B), False, True, None),
            # the lse under gemma3's window and at hubert's hd 80
            ("gemma3_local", gemma_shape, True, True, 1024),
            ("hubert_group", hubert_shape, True, False, None),
            # hubert's monitored full-batch forward (B 8, no lse)
            ("hubert_monitored", dict(hubert_shape, B=TRAIN_B), False, False, None)):
        kw = dict(causal=causal, window=window)
        for dtype in (torch.float32, torch.bfloat16):
            B_, S_, KV_, G_, hd_ = (shape[k] for k in ("B", "S", "KV", "G", "hd"))
            q = torch.randn(B_, S_, KV_, G_, hd_, generator=gen, device=dev).to(dtype)
            k_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            v_ = torch.randn(B_, S_, KV_, hd_, generator=gen, device=dev).to(dtype)
            name = str(dtype).removeprefix("torch.")
            rtol = 1e-5 if dtype == torch.float32 else 0.0
            row = dict(at=label, shape=shape, dtype=name, causal=causal, window=window,
                       return_lse=with_lse)
            if with_lse:
                out, lse = ops.flash_attention_fwd(q, k_, v_, return_lse=True, **kw)
                want_out, want = ref.flash_attention_fwd_ref(q, k_, v_, return_lse=True, **kw)
                same_out = bool(torch.equal(out, ops.flash_attention_fwd(q, k_, v_, **kw)))
            else:
                out = ops.flash_attention_fwd(q, k_, v_, **kw)
                want_out = ref.flash_attention_fwd_ref(q, k_, v_, **kw)
            torch.cuda.synchronize()
            o_err = float((out.float() - want_out.float()).abs().max())
            o_within = bool(torch.allclose(out.float(), want_out.float(), rtol=rtol,
                                           atol=tol[name]))
            out_err[f"{label}_{name}"] = o_err
            flash_err[name] = max(flash_err[name], o_err)
            row.update(out_max_abs_err=o_err, out_rtol=rtol, out_atol=tol[name],
                       out_within=o_within)
            check(o_within, f"flash output within tolerance ({label}, {name})")
            without_ms = time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, **kw),
                                 warmup=2, reps=10)
            with_ms = None
            if with_lse:
                err = float((lse - want).abs().max())
                within = bool(torch.allclose(lse, want, rtol=1e-5, atol=lse_tol[name]))
                lse_err[name] = max(lse_err[name], err)
                with_ms = time_ms(lambda: ops.flash_attention_fwd(q, k_, v_, return_lse=True,
                                                                  **kw),
                                  warmup=2, reps=10)
                row.update(lse_max_abs_err=err, rtol=1e-5, atol=lse_tol[name], within=within,
                           out_unchanged=same_out, ms_with_lse=with_ms)
                check(within, f"flash lse within tolerance ({label}, {name})")
                check(same_out, f"flash output unchanged by return_lse ({label}, {name})")
                del lse, want
            plain_ms = time_ms(lambda: ref.flash_attention_fwd_ref(q, k_, v_,
                                                                   return_lse=with_lse, **kw),
                               warmup=1, reps=3)
            lse_ms[f"{label}_{name}"] = dict(with_lse=with_ms, without_lse=without_ms,
                                             plain=plain_ms)
            emit("kernel_flash_attention_lse", **row, ms_without_lse=without_ms,
                 plain_ms=plain_ms)
            del q, k_, v_, out, want_out
    out_err.update({f"moe_{name}": err for name, err in moe_err.items()})
    lse_ms["moe_bfloat16"] = dict(with_lse=None, without_lse=at_moe["ms"],
                                  plain=at_moe["plain_ms"], library=at_moe["library_ms"],
                                  bound=at_moe["bound_ms"])
    for label, row in at_new.items():
        lse_ms[f"{label}_bfloat16"] = dict(with_lse=lse_ms.get(f"{label}_bfloat16", {}).get(
            "with_lse"), without_lse=row["ms"], plain=row["plain_ms"],
            library=row["library_ms"], bound=row["bound_ms"], bound_by=row["bound_by"])
    kernels["flash_attention_fwd"].update(
        max_abs_err=max(*flash_err.values(), *at_cap["max_abs_err"].values()),
        softcap_max_abs_err=at_cap["max_abs_err"],
        softcap_ms_by_shape={k: {m: r.get(m) for m in ("ms", "ms_with_lse", "capless_ms",
                                                       "plain_ms", "bound_ms")}
                             for k, r in at_cap["by_shape"].items() if "ms" in r},
        full_range_ms_by_shape={k: {m: r.get(m) for m in ("ms_full_range", "ms_windowed",
                                                          "tile_ratio", "time_ratio")}
                                for k, r in at_full.items() if "ms_full_range" in r},
        out_max_abs_err_by_shape=out_err,
        window_hd80_max_abs_err=new_err,
        lse_max_abs_err=lse_err, ms_with_lse=lse_ms["serve_bfloat16"]["with_lse"],
        ms_by_shape=lse_ms)
    torch.cuda.empty_cache()

    # -- main path 4: serve qwen3-14b at full width and depth ----------------
    cfg = get_config(SERVE_ARCH)
    launches.update(serve_path("serve", cfg, dev))

    # -- the kernel's prefill against the cache's decode, on the card --------
    consistency_path("serve_consistency", dataclasses.replace(
        cfg, num_layers=CONSIST_LAYERS, param_dtype="float32", compute_dtype="float32"),
        dev, 1e-3, 1e-3)

    # -- main path 6: ACPD-exchange training of codeqwen1.5-7b ---------------
    # The CLI's setup (python -m repro_torch.launch.train --arch codeqwen1.5-7b
    # ...) at 2 layers, through build_train_step, TokenPipeline and the
    # checkpoint module; step 6's state is saved for train_resume.
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core import exchange as exch_lib
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps as train_steps
    from repro_torch.launch import train as train_cli
    from repro_torch.models import train_loss
    from repro_torch.models.param import tree_flatten, tree_leaves_with_path, tree_map
    from repro_torch.optim.optimizers import init_state as opt_init

    args = train_cli.parser().parse_args(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_B),
         "--seq", str(TRAIN_SEQ), "--seed", str(SEED)])
    setup = train_cli.setup_from_args(args)
    tcfg = dataclasses.replace(setup.cfg, num_layers=TRAIN_LAYERS)
    setup = dataclasses.replace(setup, cfg=tcfg)
    exch = setup.exchange
    step_fn = train_steps.build_train_step(setup, dev)

    def fresh_params():
        return tree_materialize(model_spec(tcfg), torch.Generator(device=dev).manual_seed(SEED),
                                dev)

    def state_leaves(params, opt_state, exch_state):
        return (tree_flatten(params)[0] + [opt_state.step] + tree_flatten(opt_state.mu)[0]
                + tree_flatten(opt_state.nu)[0] + tree_flatten(exch_state.residual)[0])

    def fingerprint(t: torch.Tensor) -> tuple[int, int]:
        """Two int64 sums of the tensor's raw words (plain and index-weighted):
        equal tensors give equal pairs; one changed bit changes them."""
        words = t.detach().reshape(-1)
        words = words.view(torch.int16 if words.element_size() == 2 else torch.int32)
        total = weighted = 0
        for lo in range(0, words.numel(), 1 << 26):
            w = words[lo:lo + (1 << 26)].to(torch.int64)
            idx = torch.arange(lo, lo + w.numel(), device=w.device) % 65521 + 1
            total += int(w.sum())
            weighted += int((w * idx).sum())
        return total, weighted

    n_params = sum(math.prod(s.shape) for s in tree_flatten(model_spec(tcfg))[0])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = fresh_params()
    opt_state = opt_init(setup.optimizer, params)
    exch_state = exch_lib.init_state(exch, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pipe = TokenPipeline(tcfg, TRAIN_B, TRAIN_SEQ, seed=SEED, device=dev)
    ckpt_root = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    rows, ckpt_save_s = [], None
    ops.reset_launch_counts()
    t_run = time.perf_counter()
    for step in range(TRAIN_STEPS):
        batch = pipe.next_batch()
        before = ops.LAUNCHES["flash_attention_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, exch_state, m = step_fn(params, opt_state, exch_state, batch)
        torch.cuda.synchronize()
        row = {k.removeprefix("exchange/"): float(v) for k, v in m.items()}
        row.update(step=step, ms=(time.perf_counter() - t0) * 1e3,
                   flash_launches=ops.LAUNCHES["flash_attention_fwd"] - before)
        rows.append(row)
        if step + 1 == TRAIN_CKPT_AT:
            t0 = time.perf_counter()
            save_checkpoint(ckpt_root, step + 1, {"params": params, "opt": opt_state,
                                                  "exch": exch_state},
                            extra={"step": step + 1, "pipeline": pipe.state_dict()})
            ckpt_save_s = time.perf_counter() - t0
    run_s = time.perf_counter() - t_run
    launches["train"] = dict(ops.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    K_t, B_t, T_t = exch.num_groups, exch.group_size, exch.sync_period
    want_flash = (1 + 2 * K_t) * TRAIN_LAYERS
    steady = sorted(r["ms"] for r in rows[3:])
    losses = [r["loss"] for r in rows]
    final_prints = [fingerprint(t) for t in state_leaves(params, opt_state, exch_state)]
    meta_ref = {"params": tree_map(lambda t: torch.empty_like(t, device="meta"), params),
                "opt": type(opt_state)(*(tree_map(lambda t: torch.empty_like(t, device="meta"),
                                                  x) for x in opt_state)),
                "exch": exch_lib.ExchangeState(tree_map(
                    lambda t: torch.empty_like(t, device="meta"), exch_state.residual))}
    emit("train", arch=tcfg.arch_id, layers=tcfg.num_layers, d_model=tcfg.d_model,
         heads=tcfg.num_heads, kv_heads=tcfg.num_kv_heads, d_ff=tcfg.d_ff,
         vocab=tcfg.vocab_size, dtype=tcfg.param_dtype, params=n_params, batch=TRAIN_B,
         seq=TRAIN_SEQ, exchange=dataclasses.asdict(exch),
         optimizer=dataclasses.asdict(setup.optimizer), init_s=init_s, run_s=run_s,
         steps=rows, median_step_ms_3_11=steady[len(steady) // 2],
         step_ms_range_3_11=[steady[0], steady[-1]], peak_mem_gb=peak_gb,
         flash_launches_per_step_rule=want_flash, ckpt_save_s=ckpt_save_s,
         launches=launches["train"])
    check(all(math.isfinite(x) for x in losses), "every training loss is finite")
    for r in rows:
        dense = r["step"] % T_t == T_t - 1
        check(r["dense_step"] == float(dense), f"step {r['step']} dense flag")
        check(r["participating"] == (K_t if dense else B_t),
              f"step {r['step']}: {r['participating']} groups participated")
        check(not dense or r["sent_fraction"] == 1.0, "the dense step sends everything")
        check(r["flash_launches"] == want_flash,
              f"step {r['step']} launched the flash kernel {r['flash_launches']} times, "
              f"want (1 + 2K) x layers = {want_flash}")
    check(any(r["dense_step"] for r in rows), "the run holds a dense sync")
    want_thr = threshold_calls(model_spec(tcfg), exch) * TRAIN_STEPS
    check(launches["train"]["exchange_threshold"] == want_thr,
          f"the exchange launched exchange_threshold {launches['train']['exchange_threshold']} "
          f"times in {TRAIN_STEPS} steps, want groups x filtered leaves x steps = {want_thr}")
    want_apply = apply_calls(model_spec(tcfg), exch) * TRAIN_STEPS
    check(launches["train"]["exchange_apply"] == want_apply,
          f"the exchange launched exchange_apply {launches['train']['exchange_apply']} times "
          f"in {TRAIN_STEPS} steps, want 2 x groups x leaves x steps = {want_apply}")
    check(sum(losses[-3:]) / 3 < losses[0],
          f"the last three losses {losses[-3:]} average below step 0's {losses[0]}")
    del params, opt_state, exch_state, m, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- train_check: the kernel path against the plain forward, one step ----
    # Same width, 2 layers, batch 4 x 512, from the same weights and batch,
    # at two inits: the init rule's weights (those of the training run: the
    # stacked wq, wk are drawn with std 1/sqrt(2), ROADMAP C3, so the scores
    # reach ~2,000 and the softmax is saturated), and "fan_in", the same draw
    # with each stacked (layers, fan_in, fan_out) leaf rescaled to std
    # 1/sqrt(fan_in). Both bf16 paths are also held to a float32 run (the
    # plain forward, float32 weights) to show which differences are bf16
    # rounding. Then the dense exchange (B = K, rho = 1, gamma = 1) against the
    # plain step's gradient.
    cbatch = TokenPipeline(tcfg, CHECK_B, CHECK_SEQ, seed=SEED + 1, device=dev).next_batch()
    cfg32 = dataclasses.replace(tcfg, param_dtype="float32", compute_dtype="float32")
    grouped = {k: v.reshape(K_t, v.shape[0] // K_t, *v.shape[1:]) for k, v in cbatch.items()}
    # Dotted paths sorted are tree_flatten's order ('.' sorts before any key character).
    paths = sorted(path for path, _ in tree_leaves_with_path(model_spec(tcfg)))
    above_attention = ("final_norm.scale", "lm_head.out")

    def rel_l2(a, b):
        return float(torch.linalg.vector_norm((a.float() - b.float()).reshape(-1))
                     / torch.clamp(torch.linalg.vector_norm(b.float().reshape(-1)), min=1e-30))

    def plain_grads(p, cfg_, batch):
        kernel_fwd = ops.flash_attention_fwd
        ops.flash_attention_fwd = lambda q, k, v, **kw: ref.flash_attention_fwd_ref(q, k, v, **kw)
        try:
            out = train_steps.value_and_grad(lambda p_, b: train_loss(p_, b, cfg_), p, batch)
            torch.cuda.synchronize()
        finally:
            ops.flash_attention_fwd = kernel_fwd
        return out

    checks = {}
    for init in ("rule", "fan_in"):
        params = fresh_params()
        if init == "fan_in":
            params = fan_in_params(params, tcfg)
        ops.reset_launch_counts()
        loss_k, grads_k = train_steps.value_and_grad(lambda p, b: train_loss(p, b, tcfg),
                                                     params, cbatch)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["flash_attention_fwd"]
        loss_p, grads_p = plain_grads(params, tcfg, cbatch)
        loss_32, grads_32 = plain_grads(tree_map(lambda t: t.float(), params), cfg32, cbatch)
        g_k, g_p, g_32 = (tree_flatten(g)[0] for g in (grads_k, grads_p, grads_32))
        row = dict(
            loss_kernel=float(loss_k), loss_plain=float(loss_p), loss_float32=float(loss_32),
            loss_rel_diff=abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            kernel_flash_launches=launched,
            kernel_vs_plain={p: rel_l2(a, b) for p, a, b in zip(paths, g_k, g_p)},
            kernel_vs_float32={p: rel_l2(a, b) for p, a, b in zip(paths, g_k, g_32)},
            plain_vs_float32={p: rel_l2(a, b) for p, a, b in zip(paths, g_p, g_32)})
        del grads_p, grads_32, g_p, g_32
        dense_cfg = exch_lib.dense_config(K_t)
        dense_state = exch_lib.init_state(dense_cfg, params)
        ops.reset_launch_counts()
        update, dense_state, dm = exch_lib.exchange_sequential(
            dense_cfg, lambda p, b: train_steps.value_and_grad(
                lambda p_, b_: train_loss(p_, b_, tcfg), p, b)[1],
            params, grouped, dense_state, torch.zeros((), dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        row.update(
            dense_flash_launches=ops.LAUNCHES["flash_attention_fwd"],
            dense_vs_plain={p: rel_l2(u, g) for p, u, g in zip(paths, tree_flatten(update)[0],
                                                                g_k)},
            dense_sent_fraction=float(dm["exchange/sent_fraction"]),
            dense_participating=float(dm["exchange/participating"]),
            dense_residual_zero=all(float(r.abs().max()) == 0.0
                                    for r in tree_flatten(dense_state.residual)[0]))
        del grads_k, g_k, update, dense_state
        gc.collect()
        torch.cuda.empty_cache()
        if init == "fan_in":  # the dense exchange in float32 (the CUDA-core kernel)
            p32 = tree_map(lambda t: t.float(), params)
            del params

            def grad32(p, b):
                return train_steps.value_and_grad(lambda p_, b_: train_loss(p_, b_, cfg32),
                                                  p, b)[1]

            g32 = tree_flatten(grad32(p32, cbatch))[0]
            dense_state = exch_lib.init_state(dense_cfg, p32)
            update, dense_state, _ = exch_lib.exchange_sequential(
                dense_cfg, grad32, p32, grouped, dense_state,
                torch.zeros((), dtype=torch.int32, device=dev))
            row["dense_vs_plain_float32"] = {
                p: rel_l2(u, g) for p, u, g in zip(paths, tree_flatten(update)[0], g32)}
            del p32, g32, update, dense_state
        else:
            del params
        checks[init] = row
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_check", layers=TRAIN_LAYERS, batch=CHECK_B, seq=CHECK_SEQ, dtype="bfloat16",
         loss_rtol=CHECK_LOSS_RTOL, grad_rtol=CHECK_GRAD_RTOL, float32_rtol=CHECK_F32_RTOL,
         checked_at_rule_init=above_attention, **checks)
    for init, row in checks.items():
        check(row["kernel_flash_launches"] == 2 * TRAIN_LAYERS,
              f"{init}: the kernel path's forward and recompute launched the flash kernel "
              "once a layer each")
        check(row["loss_rel_diff"] <= CHECK_LOSS_RTOL,
              f"{init}: kernel loss within {CHECK_LOSS_RTOL} of the plain one")
        check(row["dense_sent_fraction"] == 1.0 and row["dense_participating"] == K_t
              and row["dense_residual_zero"]
              and row["dense_flash_launches"] == 2 * TRAIN_LAYERS * K_t,
              f"{init}: the dense exchange sends everything from every group, keeps no "
              "residual, and launches the kernel twice a layer a group")
        # At the rule's init only the leaves above every attention layer are
        # compared: below one, the saturated softmax's ds = p (dp - delta)
        # cancels at bf16 rounding in both paths (see plain_vs_float32).
        leaves = paths if init == "fan_in" else above_attention
        worst = max(row["kernel_vs_plain"][p] for p in leaves)
        check(worst <= CHECK_GRAD_RTOL,
              f"{init}: kernel gradients within {CHECK_GRAD_RTOL} (relative L2) of the plain "
              f"ones on {len(leaves)} leaves (worst {worst})")
        worst = max(row["dense_vs_plain"][p] for p in leaves)
        check(worst <= CHECK_GRAD_RTOL,
              f"{init}: the dense exchange's update within {CHECK_GRAD_RTOL} of the plain "
              f"gradient on {len(leaves)} leaves (worst {worst})")
    worst = max(checks["fan_in"]["dense_vs_plain_float32"].values())
    check(worst <= CHECK_F32_RTOL, f"in float32 the dense exchange's update is within "
          f"{CHECK_F32_RTOL} of the plain gradient (worst {worst})")
    del grouped

    # -- train_softcap_check: the capped kernel forward and the backward ----
    # At train_check's width, depth and batch with the cap of SOFTCAP: the
    # kernel path (the capped kernel's forward with lse, the PyTorch
    # FlashAttention-2 backward through the cap) against autograd through the
    # plain capped forward swapped in for models.flash.flash_attention (the
    # S^2 scores built and differentiated by PyTorch), at both inits, with
    # train_check's tolerances and leaves.
    from repro_torch.models import attention as attn_mod

    t0 = time.perf_counter()
    ccfg = dataclasses.replace(tcfg, attn_logit_softcap=SOFTCAP)

    def autograd_plain(q, k, v, spec):
        return ref.flash_attention_fwd_ref(q, k, v, causal=spec.causal, sm_scale=1.0,
                                           window=spec.window, softcap=spec.softcap)

    cap_checks = {}
    for init in ("rule", "fan_in"):
        params = fresh_params()
        if init == "fan_in":
            params = fan_in_params(params, tcfg)
        ops.reset_launch_counts()
        loss_k, grads_k = train_steps.value_and_grad(lambda p, b: train_loss(p, b, ccfg),
                                                     params, cbatch)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["flash_attention_fwd"]
        kernel_flash = attn_mod.flash_attention
        attn_mod.flash_attention = autograd_plain
        try:
            loss_p, grads_p = train_steps.value_and_grad(lambda p, b: train_loss(p, b, ccfg),
                                                         params, cbatch)
            torch.cuda.synchronize()
        finally:
            attn_mod.flash_attention = kernel_flash
        cap_checks[init] = dict(
            loss_kernel=float(loss_k), loss_plain_autograd=float(loss_p),
            loss_rel_diff=abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            kernel_flash_launches=launched,
            kernel_vs_plain={p: rel_l2(a, b) for p, a, b in zip(
                paths, tree_flatten(grads_k)[0], tree_flatten(grads_p)[0])})
        del params, grads_k, grads_p
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_softcap_check", arch=ccfg.arch_id, layers=TRAIN_LAYERS, batch=CHECK_B,
         seq=CHECK_SEQ, dtype="bfloat16", softcap=SOFTCAP, loss_rtol=CHECK_LOSS_RTOL,
         grad_rtol=CHECK_GRAD_RTOL, checked_at_rule_init=above_attention,
         seconds=time.perf_counter() - t0, **cap_checks)
    for init, row in cap_checks.items():
        check(row["kernel_flash_launches"] == 2 * TRAIN_LAYERS,
              f"capped {init}: the forward and recompute launched the flash kernel once a "
              "layer each")
        check(row["loss_rel_diff"] <= CHECK_LOSS_RTOL,
              f"capped {init}: kernel loss within {CHECK_LOSS_RTOL} of autograd's")
        leaves = paths if init == "fan_in" else above_attention
        worst = max(row["kernel_vs_plain"][p] for p in leaves)
        check(worst <= CHECK_GRAD_RTOL,
              f"capped {init}: kernel-path gradients within {CHECK_GRAD_RTOL} (relative L2) "
              f"of autograd through the plain forward on {len(leaves)} leaves (worst {worst})")
    del cbatch

    # -- train_resume: the run resumed from its step-6 checkpoint ------------
    # No deterministic-algorithms switch is set: the step's kernels (the
    # flash kernel, cuBLAS, the sort-based index backward, the reductions)
    # repeat bit for bit on one card as they are.
    t0 = time.perf_counter()
    tree, extra = load_checkpoint(ckpt_root, meta_ref, TRAIN_CKPT_AT, device=dev)
    torch.cuda.synchronize()
    ckpt_load_s = time.perf_counter() - t0
    params, opt_state, exch_state = tree["params"], tree["opt"], tree["exch"]
    del tree
    pipe = TokenPipeline(tcfg, TRAIN_B, TRAIN_SEQ, seed=SEED, device=dev)
    pipe.load_state_dict(extra["pipeline"])
    resumed = []
    for step in range(int(extra["step"]), TRAIN_STEPS):
        params, opt_state, exch_state, m = step_fn(params, opt_state, exch_state,
                                                   pipe.next_batch())
        resumed.append(float(m["loss"]))
    torch.cuda.synchronize()
    resumed_prints = [fingerprint(t) for t in state_leaves(params, opt_state, exch_state)]
    differ = [i for i, (a, b) in enumerate(zip(resumed_prints, final_prints)) if a != b]
    ckpt_gb = sum(f.stat().st_size for f in ckpt_root.glob("*.npz")) / 1e9
    shutil.rmtree(ckpt_root)
    emit("train_resume", from_step=int(extra["step"]), to_step=TRAIN_STEPS,
         losses_resumed=resumed, losses_unbroken=losses[TRAIN_CKPT_AT:],
         leaves=len(final_prints), leaves_differing=differ, checkpoint_gb=ckpt_gb,
         save_s=ckpt_save_s, load_s=ckpt_load_s, deterministic_switches="none")
    check(resumed == losses[TRAIN_CKPT_AT:], "the resumed losses equal the unbroken run's")
    check(not differ, f"the resumed state equals the unbroken run's at step {TRAIN_STEPS} "
          f"bit for bit (leaves differing: {differ})")
    del params, opt_state, exch_state, m
    gc.collect()
    torch.cuda.empty_cache()

    # -- main path 8b: train hubert-xlarge at full width and depth ----------
    # The train CLI's ACPD setup (python -m repro_torch.launch.train --arch
    # hubert-xlarge --batch 8 --seq 1024): frame embeddings from the
    # pipeline, every attention layer's forward on the flash kernel at hd 80,
    # not causal, with its log-sum-exp in the groups' gradients.
    t_phase = time.perf_counter()
    args = train_cli.parser().parse_args(
        ["--arch", AUDIO_ARCH, "--steps", str(AUDIO_STEPS), "--batch", str(TRAIN_B),
         "--seq", str(TRAIN_SEQ), "--seed", str(SEED)])
    setup_a = train_cli.setup_from_args(args)
    acfg, aexch = setup_a.cfg, setup_a.exchange
    step_a = train_steps.build_train_step(setup_a, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = tree_materialize(model_spec(acfg), torch.Generator(device=dev).manual_seed(SEED),
                              dev)
    opt_state = opt_init(setup_a.optimizer, params)
    exch_state = exch_lib.init_state(aexch, params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params_a = sum(math.prod(s.shape) for s in tree_flatten(model_spec(acfg))[0])
    pipe = TokenPipeline(acfg, TRAIN_B, TRAIN_SEQ, seed=SEED, device=dev)
    rows = []
    ops.reset_launch_counts()
    for step in range(AUDIO_STEPS):
        batch = pipe.next_batch()
        before = ops.LAUNCHES["flash_attention_fwd"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, exch_state, m = step_a(params, opt_state, exch_state, batch)
        torch.cuda.synchronize()
        row = {k.removeprefix("exchange/"): float(v) for k, v in m.items()}
        row.update(step=step, ms=(time.perf_counter() - t0) * 1e3,
                   flash_launches=ops.LAUNCHES["flash_attention_fwd"] - before)
        rows.append(row)
    launches["train_audio"] = dict(ops.LAUNCHES)
    want_flash = (1 + 2 * aexch.num_groups) * acfg.num_layers
    steady = sorted(r["ms"] for r in rows[2:])
    losses = [r["loss"] for r in rows]
    emit("train_audio", arch=acfg.arch_id, layers=acfg.num_layers, d_model=acfg.d_model,
         heads=acfg.num_heads, head_dim=acfg.resolved_head_dim, causal=acfg.causal,
         frontend=acfg.frontend, dtype=acfg.param_dtype, params=n_params_a, batch=TRAIN_B,
         seq=TRAIN_SEQ, batch_keys=sorted(batch), exchange=dataclasses.asdict(aexch),
         init_s=init_s, steps=rows, median_step_ms_2_5=steady[len(steady) // 2],
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         flash_launches_per_step_rule=want_flash, launches=launches["train_audio"],
         seconds=time.perf_counter() - t_phase)
    check("tokens" not in batch and "frame_embeds" in batch, "the audio batch holds frames")
    want_thr = threshold_calls(model_spec(acfg), aexch) * AUDIO_STEPS
    check(launches["train_audio"]["exchange_threshold"] == want_thr,
          f"hubert's exchange launched exchange_threshold "
          f"{launches['train_audio']['exchange_threshold']} times in {AUDIO_STEPS} steps, "
          f"want groups x filtered leaves x steps = {want_thr}")
    want_apply = apply_calls(model_spec(acfg), aexch) * AUDIO_STEPS
    check(launches["train_audio"]["exchange_apply"] == want_apply,
          f"hubert's exchange launched exchange_apply "
          f"{launches['train_audio']['exchange_apply']} times in {AUDIO_STEPS} steps, "
          f"want 2 x groups x leaves x steps = {want_apply}")
    check(all(math.isfinite(x) for x in losses), "every hubert training loss is finite")
    for r in rows:
        check(r["flash_launches"] == want_flash,
              f"hubert step {r['step']} launched the flash kernel {r['flash_launches']} "
              f"times, want (1 + 2K) x layers = {want_flash}")
    del params, opt_state, exch_state, m, batch
    gc.collect()
    torch.cuda.empty_cache()

    # -- train_audio_check: hubert's gradient on the kernel path against the
    # plain forward, as train_check does for codeqwen: full width, 2 layers,
    # batch 4 x 512 of frames, one value_and_grad at both inits; every leaf at
    # the fan-in init, the leaves above every attention layer at the rule's.
    t0 = time.perf_counter()
    hcfg = dataclasses.replace(acfg, num_layers=TRAIN_LAYERS)
    hbatch = TokenPipeline(hcfg, CHECK_B, CHECK_SEQ, seed=SEED + 1, device=dev).next_batch()
    hpaths = sorted(path for path, _ in tree_leaves_with_path(model_spec(hcfg)))
    audio_checks = {}
    for init in ("rule", "fan_in"):
        params = tree_materialize(model_spec(hcfg),
                                  torch.Generator(device=dev).manual_seed(SEED), dev)
        if init == "fan_in":
            params = fan_in_params(params, hcfg)
        ops.reset_launch_counts()
        loss_k, grads_k = train_steps.value_and_grad(lambda p, b: train_loss(p, b, hcfg),
                                                     params, hbatch)
        torch.cuda.synchronize()
        launched = ops.LAUNCHES["flash_attention_fwd"]
        loss_p, grads_p = plain_grads(params, hcfg, hbatch)
        audio_checks[init] = dict(
            loss_kernel=float(loss_k), loss_plain=float(loss_p),
            loss_rel_diff=abs(float(loss_k) - float(loss_p)) / abs(float(loss_p)),
            kernel_flash_launches=launched,
            kernel_vs_plain={p: rel_l2(a, b) for p, a, b in zip(
                hpaths, tree_flatten(grads_k)[0], tree_flatten(grads_p)[0])})
        del params, grads_k, grads_p
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_audio_check", arch=hcfg.arch_id, layers=TRAIN_LAYERS, batch=CHECK_B,
         seq=CHECK_SEQ, dtype="bfloat16", loss_rtol=CHECK_LOSS_RTOL, grad_rtol=CHECK_GRAD_RTOL,
         checked_at_rule_init=above_attention, seconds=time.perf_counter() - t0,
         **audio_checks)
    for init, row in audio_checks.items():
        check(row["kernel_flash_launches"] == 2 * TRAIN_LAYERS,
              f"hubert {init}: the forward and recompute launched the flash kernel once a "
              "layer each")
        check(row["loss_rel_diff"] <= CHECK_LOSS_RTOL,
              f"hubert {init}: kernel loss within {CHECK_LOSS_RTOL} of the plain one")
        leaves = hpaths if init == "fan_in" else above_attention
        worst = max(row["kernel_vs_plain"][p] for p in leaves)
        check(worst <= CHECK_GRAD_RTOL,
              f"hubert {init}: kernel gradients within {CHECK_GRAD_RTOL} (relative L2) of "
              f"the plain ones on {len(leaves)} leaves (worst {worst})")
    del hbatch

    # -- dryrun: every (architecture x input shape), then the ones that fit --
    dryrun_phase(dev)

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
