#!/usr/bin/env python
"""Where the time goes when the port serves a model on one CUDA card.

Builds a serve path of ``chip_smoke.py`` (``--arch``, default qwen3-14b; also
qwen3-moe-30b-a3b or mamba2-780m: full width and depth, bfloat16, random
weights from the same seed; batch 4, a 2048-token prompt, 16 tokens), runs
it once to warm up, then profiles one prefill and
the 15 decode steps under ``torch.profiler`` as two windows. It prints one
JSON object: for each window the wall time, the device's busy time (the sum
of kernel times; the path runs on one stream), the idle share, and the
kernels by device time. ``--trace PREFIX`` also writes the Chrome traces
``PREFIX.prefill.json`` and ``PREFIX.decode.json``.

Run from the repo root on a machine with a card:

    python3 scripts/profile_torch_serve.py [--arch ARCH] [--trace PREFIX]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _device_us(evt) -> float:
    """Self device time of a profiler average, in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _window(prof, wall_s: float) -> dict:
    rows = [(e.key, e.count, _device_us(e)) for e in prof.key_averages()]
    kernels = sorted((r for r in rows if r[2] > 0 and not r[0].startswith("aten::")
                      and not r[0].startswith("cuda")), key=lambda r: -r[2])
    busy_ms = sum(r[2] for r in kernels) / 1e3
    return {"wall_ms_profiled": wall_s * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall_s * 1e3),
            "kernel_launches": sum(r[1] for r in kernels),
            "kernels": [{"name": n[:120], "count": c, "device_ms": us / 1e3}
                        for n, c, us in kernels[:20]]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--arch", default="qwen3-14b")
    parser.add_argument("--trace", type=str, default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.models import decode_step, model_spec, prefill
    from repro_torch.models.param import tree_materialize

    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    B, plen, gen = smoke.SERVE_B, smoke.SERVE_PLEN, smoke.SERVE_GEN
    params = tree_materialize(model_spec(cfg),
                              torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    tokens = torch.as_tensor(make_token_dataset(B * plen, cfg.vocab_size, 0),
                             device=dev).long().reshape(B, plen)

    def do_prefill():
        logits, caches, _ = prefill(params, {"tokens": tokens}, cfg, max_seq=plen + gen)
        torch.cuda.synchronize()
        return torch.argmax(logits, -1), caches

    def do_decode(tok, caches):
        for i in range(gen - 1):
            logits, caches = decode_step(params, tok, caches, plen + 1 + i, cfg)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()

    do_decode(*do_prefill())  # warm-up: kernel build and load, allocator, cuBLAS
    t0 = time.perf_counter()
    tok, caches = do_prefill()
    wall_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    do_decode(tok, caches)
    wall_decode = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    out = {"card": torch.cuda.get_device_name(0), "nvidia_smi": smoke.nvidia_smi(),
           "arch": cfg.arch_id, "layers": cfg.num_layers, "batch": B, "prompt_len": plen,
           "decode_steps": gen - 1, "prefill_wall_ms": wall_prefill * 1e3,
           "decode_wall_ms": wall_decode * 1e3}
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        tok, caches = do_prefill()
        wall = time.perf_counter() - t0
    out["prefill"] = _window(prof, wall)
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}.prefill.json")
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        do_decode(tok, caches)
        wall = time.perf_counter() - t0
    out["decode"] = _window(prof, wall)
    if args.trace:
        prof.export_chrome_trace(f"{args.trace}.decode.json")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
