#!/usr/bin/env python
"""Time the flash kernel of this checkout against another revision's, on one card.

Each side is launched through its own revision's wrapper
(``repro_torch/kernels/flash_attn.py`` under the ``src`` directory given by
``--base`` or ``--change``), which builds that revision's
``csrc/flash_attn.cu`` into that tree's ``_build/`` and declares its launch
signature, so the script holds no copy of either ABI. The two sides are
launched in turns (base, change, change, base, ...) on the same bfloat16
inputs at the main paths' shapes, with each shape's own arguments (all of
them ones that both revisions' wrappers take): qwen3-14b's causal prefill
(B 4, S 2,048, KV 8, G 5, hd 128), qwen3-moe-30b-a3b's (KV 4, G 8),
gemma3-27b's windowed layer (KV 16, G 2, window 1,024) and hubert-xlarge's
per-group training forward (B 2, S 1,024, KV 16, G 1, hd 80, not causal).
Each turn is the mean of ``--reps`` launches by CUDA events. The two
outputs are compared bit for bit. Prints one JSON object: the card, and
per shape each side's median ms, the ratio of the medians and the count of
turns the change won.

    mkdir -p .proof/base && git archive HEAD~1 src | tar -x -C .proof/base
    python3 scripts/flash_ab.py --base .proof/base/src
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
# label: ((B, S, KV, G, hd), launch arguments)
SHAPES = {"qwen3_14b": ((4, 2048, 8, 5, 128), dict(causal=True)),
          "qwen3_moe": ((4, 2048, 4, 8, 128), dict(causal=True)),
          "gemma3_local": ((4, 2048, 16, 2, 128), dict(causal=True, window=1024)),
          "hubert_group": ((2, 1024, 16, 1, 80), dict(causal=False))}


def _is_port(name: str) -> bool:
    return name == "repro_torch" or name.startswith("repro_torch.")


def _wrapper(src: pathlib.Path):
    """``repro_torch.kernels.flash_attn`` imported from the tree ``src``, apart
    from any other copy: the port's modules are swapped out of ``sys.modules``
    while it imports and swapped back after, so each side keeps its own
    ``_build`` (sources, build directory, loaded library)."""
    saved = {n: m for n, m in sys.modules.items() if _is_port(n)}
    for n in saved:
        del sys.modules[n]
    sys.path.insert(0, str(src))
    try:
        return importlib.import_module("repro_torch.kernels.flash_attn")
    finally:
        sys.path.remove(str(src))
        for n in [n for n in sys.modules if _is_port(n)]:
            del sys.modules[n]
        sys.modules.update(saved)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="the other revision's src directory")
    ap.add_argument("--change", default=str(ROOT / "src"))
    ap.add_argument("--turns", type=int, default=10)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    sides = {"base": _wrapper(pathlib.Path(args.base).resolve()),
             "change": _wrapper(pathlib.Path(args.change).resolve())}
    out = {"base": args.base, "change": args.change,
           "card": torch.cuda.get_device_name(0), "nvidia_smi": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()}
    gen = torch.Generator(device=dev).manual_seed(7)
    for label, ((B, S, KV, G, hd), kw) in SHAPES.items():
        q = torch.randn(B, S, KV, G, hd, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).bfloat16()
        outs = {}

        def turn(side) -> float:
            launch = sides[side].flash_attention_fwd_cuda
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.reps):
                outs[side] = launch(q, k, v, **kw)
            stop.record()
            torch.cuda.synchronize()
            return start.elapsed_time(stop) / args.reps

        for side in sides:  # warm-up, and the first call builds the side's source
            turn(side)
        ms = {"base": [], "change": []}
        for t in range(args.turns):
            order = ("base", "change") if t % 2 == 0 else ("change", "base")
            for side in order:
                ms[side].append(turn(side))
        med = {side: statistics.median(v) for side, v in ms.items()}
        out[label] = dict(shape=dict(B=B, S=S, KV=KV, G=G, hd=hd), args=kw, ms=ms,
                          median_ms=med, change_over_base=med["change"] / med["base"],
                          change_wins=sum(c < b for b, c in zip(ms["base"], ms["change"])),
                          bitwise_equal=bool(torch.equal(outs["base"], outs["change"])))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
