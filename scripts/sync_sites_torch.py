"""The host syncs of one unit of a benchmark cell on the card, site by site.

    python scripts/sync_sites_torch.py --workload rcv1-k8.acpd [--seed N] [--units 1]

Sets the cell up as ``perfbench/run.py`` does (its driver, inputs made from
the seed, warm-up), then runs ``--units`` runs or steps under
``torch.cuda.set_sync_debug_mode("warn")`` with ``torch.profiler``
recording, so that the program's spans (``repro_torch.tracing``) are on.
Each synchronizing call is charged to the innermost frame of this
repository on its stack: inside the program (``src/repro_torch``) or in the
benchmark. Prints one line per site: its count, and the innermost open span.
Exits 1 when a sync inside the program lies outside a ``sync.*`` span, or
when the syncs that the tracer's ``sync.*`` spans count differ from those
the debug mode reported inside the program.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import sys
import traceback
import warnings

ROOT = pathlib.Path(__file__).resolve().parents[1]
PROGRAM = str(ROOT / "src" / "repro_torch")
TRACER = str(ROOT / "src" / "repro_torch" / "tracing.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 977)
    ap.add_argument("--units", type=int, default=1)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from perfbench import harness
    from repro_torch import tracing

    harness.set_cache_dirs()
    cell = harness.find_cell(harness.load_bench(), args.workload)
    driver = __import__(f"perfbench.drivers.{cell.traffic['driver']}", fromlist=["setup"])
    work = driver.setup(cell.config, cell.traffic, args.seed, torch.device("cuda"), cell.limits)
    torch.cuda.synchronize()

    sites: collections.Counter = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" not in str(message):
            print(f"warning: {message}", file=sys.stderr)
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if f.filename.startswith(str(ROOT)) and f.filename != TRACER
                  and not f.filename.endswith(pathlib.Path(__file__).name)]
        where = frames[-1] if frames else None
        inside = where is not None and where.filename.startswith(PROGRAM)
        stack = tracing._local.spans
        span = stack[-1].name if stack else "-"
        site = (f"{pathlib.Path(where.filename).relative_to(ROOT)}:{where.lineno}"
                if where else "outside the repository")
        sites[(inside, site, where.name if where else "", span)] += 1

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(args.units):
                work.unit()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    prof.stop()
    counted = sum(s["syncs"] for n, s in tracing.summary()["spans"].items()
                  if n.startswith("sync."))
    card = torch.cuda.get_device_name(0)
    print(f"{args.workload} seed {args.seed}, {args.units} unit(s) on {card}")
    bad = 0
    for (inside, site, fn, span), n in sorted(sites.items(), key=lambda kv: (not kv[0][0], kv[0][1])):
        ok = not inside or span.startswith("sync.")
        bad += not ok
        print(f"  {'program' if inside else 'benchmark'} {site} {fn}: {n} in span {span}"
              f"{'' if ok else '  <- outside a sync.* span'}")
    reported = sum(n for (inside, *_), n in sites.items() if inside)
    print(f"syncs inside the program: {reported}; counted by sync.* spans: {counted}")
    return 1 if bad or reported != counted else 0


if __name__ == "__main__":
    sys.exit(main())
