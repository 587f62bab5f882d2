"""Readings that the Qwen3-MoE cell's limits are set from, at the cell's own size.

    python3 perfbench/calibrate_moe.py --workload qwen3-moe-30b-a3b.acpd-exchange \
        --seeds 9 --control-seeds 3 [--faults] [--out PATH]

``calibrate.py``'s method for a cell of the ``moe_steps`` driver: for each
of ``--seeds`` seeds the program's compared steps against the plain
reference (``reference/qwen3_moe.py``), with the count of the first step's
(token, choice) pairs that the two route to different experts; for each of
``--control-seeds`` seeds the reference with float8 e4m3 products against
the float32 one (and its flipped routes) and, with ``--faults``, the
program with each fault of :data:`FAULTS` planted underneath. One JSON line
a reading, as ``calibrate.py`` prints them. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import contextlib
import dataclasses
import pathlib
import sys
import time

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

from perfbench import calibrate, harness  # noqa: E402

# calibrate.py's faults, and one of the layer's: the top-k weights left
# unnormalised. Left out of the load-balance term (its coefficient is 0.001)
# moves no compared number past its limit: the CPU tests hold its formula
# instead (tests/test_torch_qwen3_moe.py).
FAULTS = ("state_unchanged", "half_batch", "exchange_left_out", "top_k_unnormalised")


@contextlib.contextmanager
def planted(fault: str):
    """A fault of :data:`FAULTS` planted in the program underneath the step."""
    from repro_torch.models import moe

    if fault in ("state_unchanged", "half_batch", "exchange_left_out"):
        with calibrate.planted(fault, True):
            yield
        return
    if fault == "top_k_unnormalised":
        name, orig = "moe_held", moe.moe_held

        def fn(params, x, cfg):
            return orig(params, x, dataclasses.replace(cfg, norm_topk_probs=False))
    else:
        raise ValueError(fault)
    saved = getattr(moe, name)
    setattr(moe, name, fn)
    try:
        yield
    finally:
        setattr(moe, name, saved)


def readings(cell, seeds, control_seeds, faults, device, fh) -> None:
    import gc

    import torch

    from perfbench.drivers import moe_steps, train_steps
    from perfbench.reference import qwen3_moe as reference

    steps_n = cell.traffic["check_steps"]

    def program(s, fault=None):
        with planted(fault) if fault else contextlib.nullcontext():
            work = moe_steps.MoeWork(cell.config, cell.traffic, s, device, cell.limits)
        read = work.read
        work.free()
        del work
        gc.collect()
        torch.cuda.empty_cache() if device.type == "cuda" else None
        return read

    def emit_compared(kind, s, got, want, j, **extra):
        by_leaf = {p: d / r if r else d for p, d, r in
                   zip(want["paths"], want["grad_dist"][j], want["grad_ref"])}
        calibrate.emit(fh, cell=cell.name, kind=kind, seed=s, **extra,
                       **train_steps.compare(got, want, want["grad_dist"][j]),
                       grad_rel_by_leaf=by_leaf)

    def reference_of(s, judges, **kw):
        return reference.train(cell.config, cell.traffic, harness.derive_seed(s, 10),
                               harness.derive_seed(s, 11), device, steps=steps_n,
                               judges=judges, **kw)

    for s in seeds:
        t0 = time.perf_counter()
        got = program(s)
        want = reference_of(s, [got.pop("values")], routes=got.pop("routes"))
        emit_compared("program", s, got, want, 0, seconds=time.perf_counter() - t0,
                      flipped=want["flipped"], pairs=want["pairs"],
                      loss=got["loss"], ref_loss=want["loss"])
    for s in control_seeds:
        ctrl = reference_of(s, [], precision="fp8", keep_values=True)
        got = {"loss": ctrl["loss"], "bytes": ctrl["bytes"]}
        for k in ("grad", "change", "residual"):
            if ctrl[k] is not None:
                got[k] = dict(zip(ctrl["paths"], ctrl[k]))
        runs = [("control", got, ctrl["values"])]
        del ctrl
        ctrl_routes = _first_routes(cell, s, device, "fp8")
        for fault in faults:
            read = program(s, fault)
            read.pop("routes")
            runs.append((fault, read, read.pop("values")))
        want = reference_of(s, [v for _, _, v in runs], routes=ctrl_routes)
        for j, (kind, read, _) in enumerate(runs):
            extra = {"flipped": want["flipped"], "pairs": want["pairs"]} if j == 0 else {}
            emit_compared(kind, s, read, want, j, **extra)
        del runs


def _first_routes(cell, s, device, precision):
    """The reference's top-k expert ids of each layer in the first step's
    monitored forward, at ``precision``."""
    import torch

    from perfbench.inputs import moe_weights
    from perfbench.inputs.tokens import TokenStream
    from perfbench.reference import qwen3_moe as reference
    from perfbench.reference.numerics import ieee_float32

    config, traffic = cell.config, cell.traffic
    P = {p: t.float() for p, t in moe_weights.leaves(config, harness.derive_seed(s, 10), device)}
    batch = TokenStream(moe_weights.held(config)[2], traffic["batch"], traffic["seq"],
                        traffic["token_zipf"], harness.derive_seed(s, 11), device).next_batch()
    routes: list = []
    with torch.no_grad(), ieee_float32():
        reference.loss(P, batch["tokens"], batch["labels"], config, precision, routes=routes)
    return routes


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="qwen3-moe-30b-a3b.acpd-exchange")
    ap.add_argument("--seeds", type=int, default=9)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_007)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args(argv)
    harness.set_cache_dirs()
    harness.import_program()
    import torch

    cell = harness.find_cell(harness.load_bench(), args.workload)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    control = [args.first_seed + 104729 * (i + 1) for i in range(args.control_seeds)]
    fh = None
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        fh = args.out.open("a")
    readings(cell, seeds, control, FAULTS if args.faults else (), torch.device(args.device), fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
