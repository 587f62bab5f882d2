"""End-to-end training driver, with the ACPD exchange or the plain baseline.

PyTorch counterpart of ``repro.launch.train``, with its flags and log
lines, on one card (or the CPU with ``--device cpu``):

  PYTHONPATH=src python -m repro_torch.launch.train --arch codeqwen1.5-7b --reduced \\
      --steps 50 --batch 8 --seq 128 --exchange acpd

Every registered config trains, the VLM and audio ones on the pipeline's
patch and frame embeddings (``--arch pixtral-12b``, ``--arch hubert-xlarge``).
Checkpoints (params + opt + exchange residuals + data cursor) every
--ckpt-every steps; resumes with --resume. Without ``--device`` it runs on
the card and raises when there is none. ``--production-mesh`` raises: the
mesh is not ported (ROADMAP A7).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.core import exchange as exch_lib
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainSetup, build_train_step
from repro_torch.models import model_spec
from repro_torch.models.param import tree_materialize
from repro_torch.optim.optimizers import OptimizerConfig, init_state


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the architecture")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--exchange", default="acpd",
                    choices=["acpd", "dense", "plain"])
    ap.add_argument("--groups", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=2)
    ap.add_argument("--sync-period", type=int, default=10)
    ap.add_argument("--rho", type=float, default=1 / 64)
    ap.add_argument("--gamma", type=float, default=0.9)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--production-mesh", action="store_true",
                    help="not ported: raises (ROADMAP A7)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run on the host)")
    return ap


def setup_from_args(args) -> TrainSetup:
    """The CLI's ``TrainSetup``: JAX's choices of exchange and schedule."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.exchange == "plain":
        exch = None
    elif args.exchange == "dense":
        exch = exch_lib.dense_config(args.groups)
    else:
        exch = exch_lib.ExchangeConfig(
            num_groups=args.groups, group_size=args.group_size,
            sync_period=args.sync_period, rho=args.rho, gamma=args.gamma)
    opt_cfg = OptimizerConfig(name=args.optimizer, learning_rate=args.lr,
                              warmup_steps=min(20, args.steps // 5 + 1),
                              total_steps=args.steps)
    return TrainSetup(cfg=cfg, optimizer=opt_cfg, exchange=exch)


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    if args.production_mesh:
        raise NotImplementedError("--production-mesh: the mesh is not ported yet "
                                  "(ROADMAP A7: launch/mesh)")
    dev = resolve_device(args.device)
    setup = setup_from_args(args)
    cfg, opt_cfg, exch = setup.cfg, setup.optimizer, setup.exchange
    step_fn = build_train_step(setup, dev)

    params = tree_materialize(model_spec(cfg),
                              torch.Generator(device=dev).manual_seed(args.seed), dev)
    opt_state = init_state(opt_cfg, params)
    exch_state = exch_lib.init_state(exch, params) if exch is not None else None
    pipe = TokenPipeline(cfg, args.batch, args.seq, seed=args.seed, device=dev)

    start = 0
    if args.resume and args.ckpt_dir:
        tree = {"params": params, "opt": opt_state, "exch": exch_state}
        tree, extra = load_checkpoint(args.ckpt_dir, tree, device=dev)
        params, opt_state, exch_state = tree["params"], tree["opt"], tree["exch"]
        pipe.load_state_dict(extra["pipeline"])
        start = int(extra["step"])
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        batch = pipe.next_batch()
        params, opt_state, exch_state, metrics = step_fn(
            params, opt_state, exch_state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            sent = m.get("exchange/sent_fraction")
            print(f"step {step:5d} loss={m['loss']:.4f} "
                  f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}"
                  + (f" sent={sent:.4f}" if sent is not None else ""),
                  flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1,
                            {"params": params, "opt": opt_state,
                             "exch": exch_state},
                            extra={"step": step + 1,
                                   "pipeline": pipe.state_dict()})
    dt = time.time() - t0
    print(f"done: {args.steps - start} steps in {dt:.1f}s "
          f"({dt / max(args.steps - start, 1):.2f}s/step)")


if __name__ == "__main__":
    main()
