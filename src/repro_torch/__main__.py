"""``python -m repro_torch``: the experiment CLI of the port.

Subcommands:

* ``run <spec.json>``  -- execute an :class:`repro_torch.api.ExperimentSpec`
  file, streaming session events (round/sync/eval/stop) to stdout; early
  stop on the spec's ``target_gap`` / ``time_budget``. ``--out`` writes the
  records + provenance (torch, the device) as JSON. ``--device`` names
  where it runs: CUDA unless given, and an error without a card.
* ``spec <preset>``    -- print a preset spec as JSON: the text
  ``python -m repro spec <preset>`` prints.
* ``serve``            -- the multi-tenant experiment service over HTTP, or
  with ``--replica-of <cluster-dir>`` one replica of the replicated cluster
  (:func:`repro_torch.serve.http.main`; ``--device cpu`` for the host).
* ``analyze``          -- the static analyzer (AST lint + run contracts,
  :func:`repro_torch.analysis.cli.main`; ``--device cpu`` runs the
  contracts on the host).
* ``bench``            -- not ported yet; exits nonzero naming the ROADMAP
  item that ports it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# Subcommands of ``python -m repro`` that the port does not have yet, with
# the ROADMAP item that ports each.
NOT_PORTED = {"bench": "A9 (benchmarks)"}


def _cmd_run(args) -> int:
    import torch

    from repro_torch import api
    from repro_torch.device import resolve_device

    spec = api.ExperimentSpec.load(args.spec)
    if args.target_gap is not None:
        spec = dataclasses.replace(spec, target_gap=args.target_gap)
    if args.time_budget is not None:
        spec = dataclasses.replace(spec, time_budget=args.time_budget)
    if args.checkpoint_every is not None:
        spec = dataclasses.replace(spec, checkpoint_every=args.checkpoint_every)
    if spec.checkpoint_every is not None and args.checkpoint_dir is None:
        print("error: spec sets checkpoint_every; pass --checkpoint-dir for "
              "the snapshots", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    print(f"# spec {spec.name!r}: {len(spec.methods)} method(s), "
          f"problem={spec.problem.kind}, K={spec.cluster.num_workers}, "
          f"target_gap={spec.target_gap}, time_budget={spec.time_budget}, "
          f"device={device}"
          + (f", checkpoint_every={spec.checkpoint_every}"
             if spec.checkpoint_every is not None else ""))
    exp = api.Experiment(spec, checkpoint_dir=args.checkpoint_dir, device=device)
    results = {}
    for entry in spec.methods:
        name = entry.config.name
        session = exp.session(entry)
        print(f"== {name} (protocol={entry.config.protocol}, "
              f"num_outer={entry.num_outer}, executor={session.executor}) ==")
        for ev in session:
            if isinstance(ev, api.EvalEvent):
                print(f"  eval  it={ev.iteration:5d} t={ev.sim_time:9.4f}s "
                      f"gap={ev.gap:.3e} up={ev.bytes_up / 1e6:.2f}MB "
                      f"down={ev.bytes_down / 1e6:.2f}MB")
            elif isinstance(ev, api.SyncEvent):
                if args.verbose:
                    print(f"  sync  it={ev.iteration:5d} t={ev.sim_time:9.4f}s")
            elif isinstance(ev, api.RoundEvent):
                if args.verbose:
                    print(f"  round it={ev.iteration:5d} t={ev.sim_time:9.4f}s "
                          f"arrivals={ev.arrivals}")
            elif isinstance(ev, api.StopEvent):
                print(f"  stop  reason={ev.reason} it={ev.iteration} "
                      f"t={ev.sim_time:.4f}s")
        results[name] = session.result()

    for name, res in results.items():
        last = res.records[-1]
        t = res.time_to_gap(spec.target_gap) if spec.target_gap else None
        extra = (f" time_to_gap({spec.target_gap:g})="
                 f"{t:.4f}s" if t is not None else "")
        print(f"{name:12s} rounds={last.iteration:5d} gap={last.gap:.3e}"
              f" sim_t={last.sim_time:.4f}s{extra}")

    if args.out:
        payload = {
            "spec": spec.to_dict(),
            "provenance": {"torch_version": torch.__version__,
                           "device": str(device),
                           "device_name": (torch.cuda.get_device_name(device)
                                           if device.type == "cuda" else "cpu"),
                           "seed": spec.seed},
            "results": {name: res.as_dict() for name, res in results.items()},
        }
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"# wrote {args.out}")
    return 0


def _cmd_spec(args) -> int:
    from repro_torch import api

    kwargs = {"quick": args.quick} if args.quick else {}
    spec = api.build_preset(args.preset, **kwargs)
    print(spec.to_json())
    return 0


def _not_ported(name: str) -> int:
    print(f"error: `{name}` is not ported to repro_torch yet (ROADMAP "
          f"{NOT_PORTED[name]}); `python -m repro {name}` runs the JAX package's",
          file=sys.stderr)
    return 2


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="repro_torch", description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="execute an ExperimentSpec JSON file")
    p_run.add_argument("spec", help="path to a spec JSON "
                       "(see `python -m repro_torch spec <preset>`)")
    p_run.add_argument("--out", default=None,
                       help="write records + provenance JSON here")
    p_run.add_argument("--target-gap", type=float, default=None,
                       help="override the spec's early-stop duality gap")
    p_run.add_argument("--time-budget", type=float, default=None,
                       help="override the spec's simulated-time budget (s)")
    p_run.add_argument("--device", default=None,
                       help="where to run (default: the CUDA device; 'cpu' for the "
                            "host)")
    p_run.add_argument("--verbose", action="store_true",
                       help="also stream per-round and sync events")
    p_run.add_argument("--checkpoint-every", type=int, default=None,
                       help="snapshot the run state every N rounds "
                            "(resumable; overrides the spec's checkpoint_every)")
    p_run.add_argument("--checkpoint-dir", default=None,
                       help="where checkpoint snapshots live; re-running "
                            "the same spec resumes from the latest one")
    p_run.set_defaults(fn=_cmd_run)

    p_spec = sub.add_parser("spec", help="print a preset spec as JSON")
    from repro_torch.api.presets import PRESETS

    p_spec.add_argument("preset", choices=sorted(PRESETS))
    p_spec.add_argument("--quick", action="store_true",
                        help="smoke-scale variant")
    p_spec.set_defaults(fn=_cmd_spec)

    for name, item in NOT_PORTED.items():
        sub.add_parser(name, add_help=False,
                       help=f"not ported yet (ROADMAP {item})").set_defaults(fn=None)
    # `analyze` and `serve` own their flag surfaces; the raw remainder is
    # forwarded to them.
    sub.add_parser("analyze", add_help=False,
                   help="static analysis: project lint + run contracts").set_defaults(fn=None)
    sub.add_parser("serve", add_help=False,
                   help="multi-tenant experiment service over HTTP").set_defaults(fn=None)

    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in NOT_PORTED:
        return _not_ported(argv[0])
    if argv and argv[0] == "analyze":
        from repro_torch.analysis.cli import main as analyze_main

        return analyze_main(argv[1:])
    if argv and argv[0] == "serve":
        from repro_torch.serve.http import main as serve_main

        serve_main(argv[1:])
        return 0
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
