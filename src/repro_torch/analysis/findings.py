"""Structured lint findings and the JSON report schema (the JAX package's
``repro/analysis/findings.py``, the same schema).

A ``Finding`` is one rule violation at one source location.  Its identity
for baseline matching is ``key()`` -- (file, rule, stripped source line) --
free of line numbers, so edits above a baselined violation do not churn the
baseline file.  Identical lines in one file are matched by count (see
``baseline.Baseline``).

The JSON report (``build_report``) is the machine-readable artifact; its
schema is pinned by ``REPORT_VERSION`` and is the JAX linter's, key for key
(``tests/test_torch_lint.py`` compares the two).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

REPORT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: where, which rule, why."""

    file: str         # repo-relative posix path (or the path as given)
    line: int         # 1-based
    col: int          # 0-based
    rule: str         # rule name, e.g. "torch-module-constant"
    message: str      # human explanation with the repo-specific fix
    snippet: str      # the offending source line, stripped

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: stable across line-number drift."""
        return (self.file, self.rule, self.snippet)

    def to_dict(self, baselined: bool = False) -> Dict:
        return {"file": self.file, "line": self.line, "col": self.col,
                "rule": self.rule, "message": self.message,
                "snippet": self.snippet, "baselined": baselined}

    def __str__(self) -> str:
        return f"{self.file}:{self.line}:{self.col}: [{self.rule}] " \
               f"{self.message}"


def build_report(findings: Sequence[Finding], baselined: Sequence[Finding],
                 expired: Sequence[Tuple[str, str, str]],
                 files_scanned: int, rules: Sequence[str]) -> Dict:
    """The JSON report: new findings gate, baselined ones ride along for
    visibility, expired baseline entries ask for a baseline refresh."""
    return {
        "version": REPORT_VERSION,
        "files_scanned": files_scanned,
        "rules": sorted(rules),
        "new": len(findings),
        "baselined": len(baselined),
        "expired_baseline": [list(k) for k in expired],
        "findings": ([f.to_dict(False) for f in findings]
                     + [f.to_dict(True) for f in baselined]),
    }


def format_findings(findings: Sequence[Finding]) -> List[str]:
    return [str(f) for f in sorted(findings,
                                   key=lambda f: (f.file, f.line, f.rule))]
