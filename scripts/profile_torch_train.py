#!/usr/bin/env python
"""Where the time goes in one ACPD-exchange train step on one card.

Builds the training path of ``chip_smoke.py`` (by default codeqwen1.5-7b at
full width, 2 layers; ``--arch hubert-xlarge --layers 0`` its audio path at
full depth; bfloat16, random weights from the same seed; the CLI's ACPD
exchange, K = 4, B = 2, T = 10, rho = 1/64; AdamW; batch 8 x 1,024), runs
three steps to warm up, then times the step's parts one after the other,
each between two ``torch.cuda.synchronize()``: the monitored forward of the
whole batch, one group's forward and backward (``value_and_grad``), the
sequential exchange of all K groups (their gradients included), the
exchange alone (its gradients replaced by zeros of their shapes: residual
add, threshold, split, accumulation), and the AdamW update; and whole steps,
a sparse one and a dense sync. Then it profiles one sparse step under
``torch.profiler``. It prints one JSON object: each part's median ms over
``--reps`` repetitions, the profiled step's wall, device busy time, idle
share and kernels by device time. ``--trace PATH`` also writes the Chrome
trace. Like a step, the parts update the state in place; what they cost
does not depend on its values.

Run from the repo root on a machine with a card:

    python3 scripts/profile_torch_train.py [--reps 3] [--trace PATH]
    python3 scripts/profile_torch_train.py --arch hubert-xlarge --layers 0
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import statistics
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _timed(fn, reps: int) -> float:
    """Median wall ms of ``fn()`` between two synchronizes."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--trace", type=str, default=None)
    parser.add_argument("--arch", default=None, help="default: chip_smoke.py's TRAIN_ARCH")
    parser.add_argument("--layers", type=int, default=None,
                        help="depth (default: chip_smoke.py's TRAIN_LAYERS; 0: the config's)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from profile_torch_serve import _window
    from repro_torch.core import exchange as exch_lib
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_cli
    from repro_torch.models import model_spec, train_loss
    from repro_torch.models.param import tree_map, tree_materialize
    from repro_torch.optim import optimizers

    dev = torch.device("cuda")
    cli = train_cli.parser().parse_args(
        ["--arch", args.arch or smoke.TRAIN_ARCH, "--steps", str(smoke.TRAIN_STEPS), "--batch",
         str(smoke.TRAIN_B), "--seq", str(smoke.TRAIN_SEQ), "--seed", str(smoke.SEED)])
    setup = train_cli.setup_from_args(cli)
    layers = smoke.TRAIN_LAYERS if args.layers is None else args.layers
    cfg = dataclasses.replace(setup.cfg, num_layers=layers or setup.cfg.num_layers)
    setup = dataclasses.replace(setup, cfg=cfg)
    exch = setup.exchange
    step_fn = steps.build_train_step(setup, dev)
    params = tree_materialize(model_spec(cfg),
                              torch.Generator(device=dev).manual_seed(smoke.SEED), dev)
    opt_state = optimizers.init_state(setup.optimizer, params)
    exch_state = exch_lib.init_state(exch, params)
    pipe = TokenPipeline(cfg, smoke.TRAIN_B, smoke.TRAIN_SEQ, seed=smoke.SEED, device=dev)
    for _ in range(3):  # warm-up: kernel build and load, allocator, cuBLAS
        params, opt_state, exch_state, _ = step_fn(params, opt_state, exch_state,
                                                   pipe.next_batch())
    batch = pipe.next_batch()
    K = exch.num_groups
    grouped = {k: v.reshape(K, v.shape[0] // K, *v.shape[1:]) for k, v in batch.items()}
    group0 = {k: v[0] for k, v in grouped.items()}

    def loss_fn(p, b):
        return train_loss(p, b, cfg)

    def grad_fn(p, b):
        return steps.value_and_grad(loss_fn, p, b)[1]

    zeros = tree_map(torch.zeros_like, params)
    step = torch.tensor(1, dtype=torch.int32, device=dev)  # a sparse step
    parts = {}
    with torch.no_grad():
        parts["monitored_forward"] = _timed(lambda: loss_fn(params, batch), args.reps)
    parts["group_value_and_grad"] = _timed(lambda: grad_fn(params, group0), args.reps)
    parts["exchange_with_grads"] = _timed(lambda: exch_lib.exchange_sequential(
        exch, grad_fn, params, grouped, exch_state, step), args.reps)
    parts["exchange_without_grads"] = _timed(lambda: exch_lib.exchange_sequential(
        exch, lambda p, b: zeros, params, grouped, exch_state, step), args.reps)
    del zeros
    update = tree_map(lambda p: torch.full(p.shape, 1e-6, device=dev), params)
    parts["adamw_update"] = _timed(lambda: optimizers.apply_update(
        setup.optimizer, tree_map(torch.clone, params), update, opt_state), args.reps)
    del update
    whole = {}
    for name, at in (("sparse", 1), ("dense", exch.sync_period - 1)):
        opt_at = opt_state._replace(step=torch.tensor(at, dtype=torch.int32, device=dev))
        whole[name] = _timed(lambda: step_fn(params, opt_at, exch_state, batch), args.reps)

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    opt_at = opt_state._replace(step=step)
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt_at, exch_state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        prof.export_chrome_trace(args.trace)
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "nvidia_smi": smoke.nvidia_smi(),
        "arch": cfg.arch_id, "layers": cfg.num_layers, "batch": smoke.TRAIN_B,
        "seq": smoke.TRAIN_SEQ, "exchange": dataclasses.asdict(exch), "reps": args.reps,
        "parts_ms": parts, "step_ms": whole, "profiled_step": _window(prof, wall),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
