"""``python -m repro_torch analyze``: run the lint + run contracts against the
checked-in baseline.

PyTorch counterpart of ``repro.analysis.cli``, with its flags and one more,
``--device``. Exit status is the CI contract: 0 when every finding is
baseline-accepted and every run contract holds; 1 on any NEW finding or
failed contract. Typical loops::

    python -m repro_torch analyze                    # full check, on the card
    python -m repro_torch analyze --device cpu       # contracts on the host
    python -m repro_torch analyze --no-contracts     # AST lint only (fast)
    python -m repro_torch analyze --paths src/repro_torch/core
    python -m repro_torch analyze --update-baseline  # accept current findings
    python -m repro_torch analyze --json             # machine-readable report

The lint covers ``src/repro_torch`` (the JAX package is linted by ``python
-m repro analyze``), and the baseline lives at
``ANALYSIS_BASELINE_TORCH.json`` (see :mod:`repro_torch.analysis.findings`
for the fingerprint contract). A finding in the port is fixed in the port,
so the baseline starts empty; a false positive gets a pragma with its
reason. The README's port section lists the rules and the contracts.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from repro_torch.analysis import contracts as contracts_lib
from repro_torch.analysis import lint as lint_lib
from repro_torch.analysis.findings import Baseline

DEFAULT_PATHS = ("src/repro_torch",)
BASELINE_NAME = "ANALYSIS_BASELINE_TORCH.json"


def _repo_root() -> pathlib.Path:
    """The repo root: nearest ancestor of this file holding the baseline /
    Makefile, else the cwd (analyze runs from checkouts, not installs)."""
    here = pathlib.Path(__file__).resolve()
    for parent in here.parents:
        if (parent / "Makefile").exists() or (parent / BASELINE_NAME).exists():
            return parent
    return pathlib.Path.cwd()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="repro_torch analyze",
        description="project lint + run-contract analyzer of the port")
    ap.add_argument("--paths", nargs="*", default=None,
                    help="files/directories to lint (default: src/repro_torch/)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: <repo>/{BASELINE_NAME})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept current findings")
    ap.add_argument("--no-contracts", action="store_true",
                    help="skip the run contracts (lint only)")
    ap.add_argument("--device", default=None,
                    help="where the contracts run (default: the CUDA device; "
                         "'cpu' for the host)")
    ap.add_argument("--rules", nargs="*", default=None,
                    help="run only these lint rules")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule registry and exit")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit a JSON report instead of text")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    root = _repo_root()

    if args.list_rules:
        for name in lint_lib.available_rules():
            print(f"{name}: {lint_lib.get_rule(name).description}")
        return 0

    paths = [root / p for p in (args.paths or DEFAULT_PATHS)]
    findings = lint_lib.lint_paths(paths, root=root, rules=args.rules)

    baseline_path = pathlib.Path(args.baseline or root / BASELINE_NAME)
    if args.update_baseline:
        Baseline.write(baseline_path, findings)
        print(f"baseline updated: {baseline_path} "
              f"({len(findings)} accepted finding(s))")
        return 0

    baseline = Baseline.load(baseline_path)
    new, accepted, stale = baseline.split(findings)

    results = []
    if not args.no_contracts:
        results = contracts_lib.run_contracts(device=args.device)
    failed = [r for r in results if not r.ok]

    if args.as_json:
        print(json.dumps({
            "new": [f.as_dict() for f in new],
            "accepted": [f.as_dict() for f in accepted],
            "stale_fingerprints": sorted(stale),
            "contracts": [r.as_dict() for r in results],
        }, indent=1))
    else:
        for f in new:
            print(f.format())
        for r in results:
            print(r.format())
        summary = (f"{len(new)} new finding(s), {len(accepted)} "
                   f"baseline-accepted, {len(stale)} stale baseline "
                   f"entr(ies)")
        if results:
            summary += (f"; contracts: {len(results) - len(failed)}/"
                        f"{len(results)} ok")
        print(summary)
        if new:
            print("fix the new findings, suppress with a pragma "
                  "(# analysis: host-ok / ignore[rule]) or accept with "
                  "--update-baseline")
        if stale:
            print("stale baseline entries are fixed findings: re-run with "
                  "--update-baseline to shrink the baseline")

    return 1 if (new or failed) else 0


if __name__ == "__main__":
    sys.exit(main())
