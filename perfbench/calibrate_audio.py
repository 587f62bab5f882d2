"""Readings that the HuBERT cell's limits are set from, at the cell's own size.

    python3 perfbench/calibrate_audio.py --workload hubert-xlarge.acpd-exchange \
        --seeds 12 --control-seeds 3 [--faults] [--out PATH]

``calibrate.py``'s method for a cell of the ``audio_steps`` driver: for each
of ``--seeds`` seeds the program's compared steps against the plain
reference (``reference/hubert.py``); for each of ``--control-seeds`` seeds
the reference in float8 against the float32 one and, with ``--faults``, the
program with each fault of :data:`FAULTS` planted underneath. One JSON line
a reading, as ``calibrate.py`` prints them. The benchmark's own runs never
run this.
"""

from __future__ import annotations

import contextlib
import pathlib
import sys
import time

_HERE = pathlib.Path(__file__).resolve().parent
sys.path[:] = [p for p in sys.path if pathlib.Path(p or ".").resolve() != _HERE]
sys.path.insert(0, str(_HERE.parent))

from perfbench import calibrate, harness  # noqa: E402

# calibrate.py's faults, and two of the model's: the positional conv left
# out, and the cross-entropy taken over every frame rather than the masked.
FAULTS = ("half_batch", "exchange_left_out", "posconv_left_out", "loss_over_all_frames")


@contextlib.contextmanager
def planted(fault: str):
    """A fault of :data:`FAULTS` planted in the program underneath the step."""
    import torch

    from repro_torch.models import audio

    if fault in ("half_batch", "exchange_left_out"):
        with calibrate.planted(fault, True):
            yield
        return
    if fault == "posconv_left_out":  # its weights still given (zero) gradients
        orig = audio.pos_conv

        def fn(params, x, cfg):
            return x + 0.0 * (orig(params, x, cfg) - x)
        name = "pos_conv"
    elif fault == "loss_over_all_frames":
        orig = audio.head_loss

        def fn(params, h, labels, mask, penalty, cfg):
            return orig(params, h, labels, torch.ones_like(mask), penalty, cfg)
        name = "head_loss"
    else:
        raise ValueError(fault)
    saved = getattr(audio, name)
    setattr(audio, name, fn)
    try:
        yield
    finally:
        setattr(audio, name, saved)


def readings(cell, seeds, control_seeds, faults, device, fh) -> None:
    import gc

    import torch

    from perfbench.drivers import audio_steps, train_steps
    from perfbench.reference import hubert as reference

    steps_n = cell.traffic["check_steps"]

    def program(s, fault=None):
        with planted(fault) if fault else contextlib.nullcontext():
            work = audio_steps.AudioWork(cell.config, cell.traffic, s, device, cell.limits)
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
        want = reference_of(s, [got.pop("values")])
        emit_compared("program", s, got, want, 0, seconds=time.perf_counter() - t0,
                      loss=got["loss"], ref_loss=want["loss"])
    for s in control_seeds:
        ctrl = reference_of(s, [], precision="fp8", keep_values=True)
        got = {"loss": ctrl["loss"], "bytes": ctrl["bytes"]}
        for k in ("grad", "change", "residual"):
            if ctrl[k] is not None:
                got[k] = dict(zip(ctrl["paths"], ctrl[k]))
        runs = [("control", got, ctrl["values"])]
        for fault in faults:
            read = program(s, fault)
            runs.append((fault, read, read.pop("values")))
        want = reference_of(s, [v for _, _, v in runs])
        for j, (kind, read, _) in enumerate(runs):
            emit_compared(kind, s, read, want, j)
        del runs, ctrl


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="hubert-xlarge.acpd-exchange")
    ap.add_argument("--seeds", type=int, default=12)
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
