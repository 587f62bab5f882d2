"""Dry-run of every (architecture x input shape) on one card: FLOPs, bytes, fit.

PyTorch counterpart of ``repro.launch.dryrun``. The JAX module lowers and
compiles each step for a 256- or 512-chip mesh and reads its roofline from
the compiled artifact; the port runs on one H100 and has no compiler
artifact, so for each combination it records, without a device:

* ``skipped`` with the JAX package's reason (``configs.shape_supported``),
  or the step's FLOPs counted on ``meta`` tensors
  (``hlo_analysis.count_step_flops``), ``model_flops`` and the useful ratio;
* the modeled HBM bytes and ``memory_s`` per device (``launch/analytic.py``)
  on the mesh shape of ``--mesh``, ``compute_s`` at the H100's peak for the
  model's compute dtype (the step's FLOPs split evenly over the mesh), and
  the dominant term;
* the resident bytes, from the ``meta`` tensors: parameters, the optimizer
  state and (with ``--exchange acpd``) the exchange residuals of a train
  step, caches, inputs; for a train step also the period inputs that remat
  keeps across the step (periods x B x S x d_model in the compute dtype,
  from the shapes). Other activations are not counted, so this is a lower
  bound of the step's peak;
* whether that fits one card: ``torch.cuda.mem_get_info``'s total, or 80 GB
  (the H100's) with ``--device cpu``.

``--run`` then runs each combination that fits once at its full shape on
the device (random weights from ``--seed``) and records its wall time and
its peak memory (``max_memory_allocated`` less what the process held
before) beside the estimate, or that it ran out of memory.
``--mesh`` (``single``: one card; ``production``: 16 x 16; ``multi``: 2 x 16
x 16) changes only the analytic arithmetic: what runs is always one card's
step at the global batch. ``--exchange acpd`` takes as many ACPD groups as
the mesh has data slices (1 on one card), as the JAX dry-run does.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mamba2-780m --shape all --run

Each record is printed as one JSON line; ``--out`` also writes them all to a
JSON file. The abstract part needs no device; ``--run`` needs a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import time

import torch

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape, get_config, input_specs,
                                 shape_supported)
from repro_torch.core import exchange as exch_lib
from repro_torch.device import resolve_device
from repro_torch.launch import hlo_analysis
from repro_torch.launch.analytic import hbm_bytes
from repro_torch.launch.flops import model_flops
from repro_torch.launch.mesh import MESH_SHAPES, batch_divisor, num_devices
from repro_torch.models import init_caches, model_spec
from repro_torch.models.config import ModelConfig
from repro_torch.optim.optimizers import OptimizerConfig, init_state

CPU_CAPACITY = 80e9  # bytes: one H100's memory, the verdict's limit without a card


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _exchange_config(groups: int) -> exch_lib.ExchangeConfig:
    return exch_lib.ExchangeConfig(num_groups=groups, group_size=max(1, groups // 2),
                                   sync_period=20, rho=1.0 / 256.0, gamma=0.9)


def resident_bytes(cfg: ModelConfig, shape: InputShape, *,
                   groups: int | None = None) -> dict[str, int]:
    """Bytes that stay on the card through one step (see the module
    docstring), by part, and their ``total``."""
    params = hlo_analysis.abstract_params(cfg)
    specs = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    out = {"params": _nbytes(params)}
    if shape.kind == "train":
        out["optimizer"] = _nbytes(init_state(OptimizerConfig(), params))
        if groups is not None:
            out["exchange"] = _nbytes(exch_lib.init_state(_exchange_config(groups), params))
        periods = sum(p for _, p in cfg.stages())
        out["checkpoints"] = periods * B * S * cfg.d_model * cfg.cdtype.itemsize
        out["inputs"] = _nbytes(specs["batch"])
    elif shape.kind == "prefill":
        out["caches"] = _nbytes(init_caches(cfg, B, S, cfg.cdtype, "meta"))
        out["inputs"] = _nbytes(specs["batch"])
    else:
        out["caches"] = _nbytes(specs["caches"])
        out["inputs"] = _nbytes(specs["token"])
    out["total"] = sum(out.values())
    return out


def _materialize(tree, cfg: ModelConfig, gen: torch.Generator, dev: torch.device):
    """Real inputs on ``dev`` for abstract ones: token ids below the vocab,
    standard normal embeddings, zero caches."""
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.int64:
            return torch.randint(0, cfg.vocab_size, tree.shape, generator=gen, device=dev)
        return torch.randn(tree.shape, generator=gen, device=dev).to(tree.dtype)
    if isinstance(tree, dict):
        return {k: _materialize(v, cfg, gen, dev) for k, v in tree.items()}
    return tree


def run_step(cfg: ModelConfig, shape: InputShape, dev: torch.device, *,
             groups: int | None = None, exploit_window: bool = True,
             seed: int = 0) -> dict:
    """Run one step of ``shape.kind`` at its full shape on ``dev``: the train
    step of ``launch/steps.py`` (plain, or ACPD with ``groups`` groups),
    ``prefill`` or one ``decode_step`` over zero caches. Returns its wall
    seconds and, on a card, ``peak_bytes``: ``max_memory_allocated`` from
    before the weights were drawn, less what was allocated then (the
    caller's own tensors); ``status`` is ``out_of_memory`` if the card ran
    out."""
    from repro_torch.launch.steps import TrainSetup, build_train_step
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.param import tree_materialize

    cuda = dev.type == "cuda"
    before = 0
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    try:
        params = tree_materialize(model_spec(cfg), gen, dev)
        specs = input_specs(cfg, shape)
        if shape.kind == "train":
            exch = None if groups is None else _exchange_config(groups)
            setup = TrainSetup(cfg=cfg, optimizer=OptimizerConfig(), exchange=exch,
                               exploit_window=exploit_window)
            opt_state = init_state(setup.optimizer, params)
            exch_state = None if exch is None else exch_lib.init_state(exch, params)
            batch = _materialize(specs["batch"], cfg, gen, dev)
            step = build_train_step(setup, dev)
            start = time.perf_counter()
            out = step(params, opt_state, exch_state, batch)[3]["loss"]
        elif shape.kind == "prefill":
            batch = _materialize(specs["batch"], cfg, gen, dev)
            start = time.perf_counter()
            out = prefill(params, batch, cfg, max_seq=shape.seq_len,
                          exploit_window=exploit_window)[0]
        else:
            caches = init_caches(cfg, shape.global_batch, shape.seq_len, cfg.cdtype, dev)
            token = _materialize(specs["token"], cfg, gen, dev)
            start = time.perf_counter()
            out = decode_step(params, token, caches, specs["cache_len"], cfg)[0]
        if cuda:
            torch.cuda.synchronize(dev)
        rec = dict(status="ran", step_s=time.perf_counter() - start,
                   finite=bool(torch.isfinite(out).all()))
    except torch.cuda.OutOfMemoryError as e:
        rec = dict(status="out_of_memory", error=str(e).splitlines()[0])
    rec["wall_s"] = time.perf_counter() - t0
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - before if cuda else None
    rec["allocated_before"] = before if cuda else None
    params = batch = caches = out = None
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
    return rec


def run_one(arch: str, shape: str | InputShape, mesh_kind: str = "single",
            exchange: str = "plain", *, exploit_window: bool = True,
            cfg: ModelConfig | None = None, run: bool = False,
            device: torch.device | None = None, capacity: float | None = None,
            seed: int = 0) -> dict:
    """The record of one combination (see the module docstring). ``cfg``
    replaces ``get_config(arch)`` and ``shape`` may be an ``InputShape``
    (smaller ones for tests); ``run`` runs the step on ``device`` if it fits
    ``capacity`` bytes."""
    cfg = get_config(arch) if cfg is None else cfg
    shape = INPUT_SHAPES[shape] if isinstance(shape, str) else shape
    rec: dict = {"arch": arch, "shape": shape.name, "mesh": mesh_kind, "exchange": exchange,
                 "exploit_window": exploit_window}
    ok, why = shape_supported(cfg, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
        return rec
    mesh_shape = MESH_SHAPES[mesh_kind]
    n_dev = num_devices(mesh_shape)
    groups = None
    if exchange == "acpd" and shape.kind == "train":
        groups = batch_divisor(mesh_shape)
    counted = hlo_analysis.count_step_flops(cfg, shape, groups=groups,
                                            exploit_window=exploit_window)
    mf = model_flops(cfg, shape)
    peak = hlo_analysis.PEAK_BF16 if cfg.cdtype == torch.bfloat16 else hlo_analysis.PEAK_F32
    flops_dev = counted["flops"] / n_dev
    hbm = hbm_bytes(cfg, shape, mesh_shape, exchange=exchange == "acpd")
    one_card = n_dev == 1
    terms = {"compute": flops_dev / peak, "memory": hbm / hlo_analysis.HBM_BW}
    if one_card:
        terms["collective"] = 0.0
    resident = resident_bytes(cfg, shape, groups=groups)
    roof = hlo_analysis.Roofline(
        flops_per_device=flops_dev, hbm_bytes_per_device=hbm,
        wire_bytes_per_device=0.0 if one_card else None,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms.get("collective"), dominant=max(terms, key=terms.get),
        memory_stats=resident,
        collectives={} if one_card else {"note": "not modeled: the port has no collective "
                                                  "schedule (it runs one card)"},
        model_flops=mf / n_dev, useful_ratio=mf / counted["flops"])
    if capacity is None:
        capacity = (torch.cuda.mem_get_info(device)[1]
                    if device is not None and device.type == "cuda" else CPU_CAPACITY)
    rec.update(status="ok", num_devices=n_dev, mesh_shape=mesh_shape, groups=groups,
               counted=counted, model_flops_global=mf, roofline=roof.as_dict(),
               resident_bytes=resident["total"], capacity_bytes=capacity,
               fits=resident["total"] <= capacity)
    if run and rec["fits"]:
        rec["run"] = run_step(cfg, shape, device, groups=groups,
                              exploit_window=exploit_window, seed=seed)
    return rec


def summary(rec: dict) -> dict:
    """The record without its nested detail: one line of the CLI's output."""
    if rec["status"] != "ok":
        return rec
    r = rec["roofline"]
    out = {k: rec[k] for k in ("arch", "shape", "mesh", "exchange", "exploit_window",
                               "status", "num_devices", "resident_bytes", "fits")}
    out.update(flops=rec["counted"]["flops"], flash_flops=rec["counted"]["flash_flops"],
               model_flops=rec["model_flops_global"], useful_ratio=r["useful_ratio"],
               hbm_bytes=r["hbm_bytes_per_device"], compute_s=r["compute_s"],
               memory_s=r["memory_s"], dominant=r["dominant"],
               count_s=rec["counted"]["seconds"])
    if "run" in rec:
        out["run"] = rec["run"]
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=sorted(MESH_SHAPES))
    ap.add_argument("--exchange", default="plain", choices=["plain", "acpd"])
    ap.add_argument("--no-exploit-window", action="store_true")
    ap.add_argument("--run", action="store_true",
                    help="run each combination that fits once on the device")
    ap.add_argument("--device", default=None,
                    help="where --run runs and whose memory the verdict reads "
                         "(the card unless given)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write every record to this JSON file")
    args = ap.parse_args(argv)
    if args.device is None and not args.run and not torch.cuda.is_available():
        device = None  # the abstract part needs no device: the verdict reads 80 GB
    else:
        device = resolve_device(args.device)
    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    records = []
    for arch in archs:
        for shape in shapes:
            rec = run_one(arch, shape, args.mesh, args.exchange,
                          exploit_window=not args.no_exploit_window, run=args.run,
                          device=device, seed=args.seed)
            records.append(rec)
            print(json.dumps(summary(rec)), flush=True)
    if args.out:
        path = pathlib.Path(args.out)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(records, indent=1, default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
