"""Static analysis for the port: AST lint + run contracts.

PyTorch counterpart of ``repro.analysis``. Two layers behind one CLI
(``python -m repro_torch analyze``):

* :mod:`repro_torch.analysis.lint` -- rule registry + AST lint enforcing
  the no-host-sync-in-a-capture / registry / mesh / serve-error invariants
  on source.
* :mod:`repro_torch.analysis.contracts` -- runs the whole-run executor's
  entry points on a tiny problem and asserts the one-capture-per-signature /
  no-host-sync / in-place-carry / bucket-cache contracts from what the
  executor records (on the card: the captured CUDA graphs).
* :mod:`repro_torch.analysis.findings` -- findings + the checked-in
  baseline (``ANALYSIS_BASELINE_TORCH.json``) that separates accepted debt
  from regressions.
"""

from repro_torch.analysis.findings import Baseline, Finding, sort_findings
from repro_torch.analysis.lint import (Rule, available_rules, default_rules,
                                       get_rule, lint_paths, lint_project,
                                       lint_source, parse_project, register_rule)

__all__ = [
    "Baseline", "Finding", "Rule", "available_rules", "default_rules",
    "get_rule", "lint_paths", "lint_project", "lint_source",
    "parse_project", "register_rule", "sort_findings",
]
