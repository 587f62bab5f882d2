"""Findings + the checked-in baseline: the analyzer's regression contract.

PyTorch counterpart of ``repro.analysis.findings``, unchanged but for the
baseline's file and command. A :class:`Finding` is one rule violation at
one source location. Findings are compared against a checked-in *baseline
file* (``ANALYSIS_BASELINE_TORCH.json`` at the repo root) the same way
type-checker baselines work: pre-existing accepted findings are recorded
there and do not fail CI, while any finding NOT in the baseline is a
regression and exits nonzero. Fingerprints are content-based -- ``rule |
path | enclosing-def | stripped source line`` -- so unrelated edits that
shift line numbers never invalidate the baseline, while moving a violating
line to a new file or function (or editing it) re-surfaces it for review.

Shrinking the baseline (fixing an accepted finding) never fails the check;
``stale`` entries are reported so the file can be re-generated with
``python -m repro_torch analyze --update-baseline``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str  # registry name of the rule that fired
    path: str  # repo-relative posix path of the file
    line: int  # 1-based line number
    message: str  # human explanation, actionable
    context: str = ""  # enclosing def/class qualname ("" at module level)
    snippet: str = ""  # the stripped source line (fingerprint component)

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used for baseline matching."""
        return "|".join((self.rule, self.path, self.context, self.snippet))

    def format(self) -> str:
        ctx = f" [{self.context}]" if self.context else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{ctx}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def sort_findings(findings) -> list[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


class Baseline:
    """The accepted-findings ledger (see module docstring)."""

    def __init__(self, fingerprints=(), *, path: pathlib.Path | None = None):
        self.fingerprints = set(fingerprints)
        self.path = path

    @classmethod
    def load(cls, path) -> "Baseline":
        path = pathlib.Path(path)
        if not path.exists():
            return cls(path=path)
        doc = json.loads(path.read_text())
        return cls((e["fingerprint"] for e in doc.get("findings", [])),
                   path=path)

    @staticmethod
    def write(path, findings) -> None:
        """Rewrite the baseline to accept exactly ``findings``."""
        findings = sort_findings(findings)
        doc = {
            "_comment": ("Accepted pre-existing findings of `python -m "
                         "repro_torch analyze` (see the README's port "
                         "section). New findings not listed here fail CI; "
                         "regenerate with --update-baseline after review."),
            "findings": [{"fingerprint": f.fingerprint, "rule": f.rule,
                          "path": f.path, "message": f.message}
                         for f in findings],
        }
        pathlib.Path(path).write_text(json.dumps(doc, indent=1) + "\n")

    def split(self, findings) -> tuple[list[Finding], list[Finding], set]:
        """Partition into (new, accepted) findings + stale fingerprints."""
        new, accepted, seen = [], [], set()
        for f in sort_findings(findings):
            if f.fingerprint in self.fingerprints:
                accepted.append(f)
                seen.add(f.fingerprint)
            else:
                new.append(f)
        return new, accepted, self.fingerprints - seen
