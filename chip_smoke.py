"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each one
against its plain PyTorch version at the main path's shapes and times both,
then drives the main paths through the port's entry points at RCV1 width
(d = 47,236): the paper's ACPD loop, the CoCoA+ baseline, and the Table-I
message filter on the workers' updates. Launch counts are zeroed just before
each path and read just after it. Every phase prints one JSON line; any
failure raises and the script exits non-zero. The last line is the device
summary ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository's ``src`` beside it; without
either it fails before printing any result.
"""

from __future__ import annotations

import json
import math
import pathlib
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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32 FLOP/s outside
# the tensor cores, the type both kernels compute in.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


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
    from repro_torch.core import acpd, baselines, filter as msg_filter, sdca
    from repro_torch.core.simulate import ClusterModel
    from repro_torch.kernels import _build, ops, ref, topk_filter as topk_mod

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
    _build.build("sdca_inner", "topk_filter")
    ptxas = {}
    for name in ("sdca_inner", "topk_filter"):
        log = _build.library_path(name).with_suffix(".log")
        ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                       if "registers" in ln or "spill" in ln] if log.exists() else []
    emit("build", seconds=time.perf_counter() - t0, ptxas=ptxas)

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
    gen = torch.Generator(device=dev).manual_seed(SEED)
    idx = torch.randint(0, N_K, (K, H), generator=gen, device=dev, dtype=torch.int32)
    w_eff = 0.01 * torch.randn(K, D, generator=gen, device=dev)
    alpha = 0.01 * torch.randn(K, N_K, generator=gen, device=dev)
    sp = GAMMA * B
    args = (w_eff, alpha, problem.X, problem.y, norms, LAM, n, sp, idx)
    da_k, v_k = ops.sdca_epoch(*args)
    da_r, v_r = ref.sdca_inner_ref(*args)
    torch.cuda.synchronize()
    da_abs, da_rel = errors(da_k, da_r)
    v_abs, v_rel = errors(v_k, v_r)
    da_2, v_2 = ops.sdca_epoch(*args)
    bitwise = bool(torch.equal(da_k, da_2) and torch.equal(v_k, v_2))
    ok = (torch.allclose(da_k, da_r, rtol=1e-4, atol=1e-5)
          and torch.allclose(v_k, v_r, rtol=1e-4, atol=1e-5))
    ms = time_ms(lambda: ops.sdca_epoch(*args), warmup=2, reps=10)
    plain_ms = time_ms(lambda: ref.sdca_inner_ref(*args), warmup=1, reps=3)
    rows = sum(int(torch.unique(idx[k]).numel()) for k in range(K))
    nbytes = (rows * D * 4 + K * D * 4 * 2 + K * N_K * 4 * 4 + K * H * 4)
    flops = 6 * D * H * K  # two dot products and one axpy per step
    bound_ms = max(nbytes / PEAK_BYTES, flops / PEAK_F32) * 1e3
    kernels["sdca_inner"] = dict(
        name="sdca_inner", route="cuda", source="src/repro_torch/csrc/sdca_inner.cu",
        replaces="src/repro/kernels/sdca_inner.py:78", max_abs_err=max(da_abs, v_abs),
        max_rel_err=max(da_rel, v_rel), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if nbytes / PEAK_BYTES >= flops / PEAK_F32 else "operations",
        library_ms=None)
    emit("kernel_sdca_inner", shape=dict(K=K, n_k=N_K, d=D, H=H), dalpha_abs=da_abs,
         dalpha_rel=da_rel, v_abs=v_abs, v_rel=v_rel, rtol=1e-4, atol=1e-5,
         within=ok, repeat_bitwise=bitwise, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
         unique_rows=rows, bound_bytes=nbytes, bound_flops=flops)
    check(ok, "sdca_inner within rtol 1e-4 / atol 1e-5 of sdca_inner_ref")
    check(bitwise, "sdca_inner repeats bit for bit")

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
         library_ms=library_ms, library="torch.topk(|dw|, k)",
         bound_ms=kernels["topk_filter"]["bound_ms"], bound_bytes=nbytes)
    del inputs, worker_dw, da_r, v_r, da_2, v_2, args

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
    wall = time.perf_counter() - t0
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
    wall = time.perf_counter() - t0
    launches["cocoa_plus"] = dict(ops.LAUNCHES)
    gaps_c = [r.gap for r in res_c.records]
    emit("cocoa_plus", rounds=len(gaps_c), gap_first=gaps_c[0], gap_last=gaps_c[-1],
         gaps=gaps_c, bytes_up=res_c.records[-1].bytes_up,
         sim_time=res_c.records[-1].sim_time, wall_s=wall, launches=launches["cocoa_plus"])
    check(launches["cocoa_plus"]["sdca_inner"] == COCOA_ROUNDS,
          f"CoCoA+ launched sdca_inner {launches['cocoa_plus']['sdca_inner']} times")
    check(all(math.isfinite(g) for g in gaps_c) and gaps_c[-1] < gaps_c[0],
          "CoCoA+ gaps are finite and fall")

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
