"""Static and runtime guardrails of the port's serving stack (the JAX
package's ``repro.analysis``).

* the **linter** (``rules``, ``linter``, ``baseline``, ``findings``,
  ``context``) is pure stdlib ``ast`` and never imports torch;
  ``python -m repro_torch.launch.lint`` is its CLI and
  ``lint_baseline.json`` beside this file its (empty) baseline;
* the **steady-state guard** (``guards``) holds a warmed engine to no
  unsanctioned host sync and no kernel build.  It imports torch, so it is
  exported lazily: importing ``repro_torch.analysis`` alone stays light.
"""

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.findings import Finding, build_report
from repro_torch.analysis.linter import (LintResult, iter_python_files,
                                         lint_paths, lint_source,
                                         select_rules)
from repro_torch.analysis.rules import ALL_RULES, NOT_PORTED, RULES_BY_NAME

_LAZY = ("SteadyStateMonitor", "SteadyStateViolation", "sanctioned",
         "steady_state", "warmup_then_guard")


def __getattr__(name):
    if name in _LAZY:
        from repro_torch.analysis import guards
        return getattr(guards, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ALL_RULES", "Baseline", "Finding", "LintResult", "NOT_PORTED",
           "RULES_BY_NAME", "build_report", "iter_python_files",
           "lint_paths", "lint_source", "select_rules", *_LAZY]
