"""Drive the rules over files and fold in the baseline (the JAX package's
``repro/analysis/linter.py``).

``lint_paths`` is the whole API the CLI and the tests need: collect ``.py``
files, run every (selected) rule through one shared ``ModuleContext`` per
file, drop ``# lint: allow[rule]``-suppressed findings, then split against
the checked-in baseline.  Pure stdlib: importing this never imports torch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.baseline import Baseline
from repro_torch.analysis.context import ModuleContext
from repro_torch.analysis.findings import Finding, build_report
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_NAME, Rule


@dataclasses.dataclass
class LintResult:
    new: List[Finding]
    baselined: List[Finding]
    expired: List[Tuple[str, str, str]]
    files_scanned: int
    rules: List[str]

    @property
    def all_findings(self) -> List[Finding]:
        return self.new + self.baselined

    def report(self) -> Dict:
        return build_report(self.new, self.baselined, self.expired,
                            self.files_scanned, self.rules)

    def failed(self, fail_on_expired: bool = False) -> bool:
        return bool(self.new) or (fail_on_expired and bool(self.expired))


def iter_python_files(paths: Sequence[str]) -> Iterable[str]:
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        else:
            raise FileNotFoundError(path)


def select_rules(names: Optional[Sequence[str]] = None) -> List[Rule]:
    if not names:
        return list(ALL_RULES)
    unknown = [n for n in names if n not in RULES_BY_NAME]
    if unknown:
        raise KeyError(f"unknown lint rule(s): {', '.join(unknown)}; "
                       f"known: {', '.join(sorted(RULES_BY_NAME))}")
    return [RULES_BY_NAME[n] for n in names]


def lint_source(source: str, path: str,
                rules: Optional[Sequence[Rule]] = None) -> List[Finding]:
    """Lint one in-memory module (the fixture-test entry point)."""
    ctx = ModuleContext(source, path)
    out: List[Finding] = []
    for rule in rules if rules is not None else ALL_RULES:
        if not rule.applies(ctx):
            continue
        out.extend(f for f in rule.check(ctx)
                   if not ctx.allowed(f.line, rule.name))
    return sorted(out, key=lambda f: (f.file, f.line, f.col, f.rule))


def lint_paths(paths: Sequence[str], baseline: Optional[Baseline] = None,
               rules: Optional[Sequence[Rule]] = None,
               root: Optional[str] = None) -> LintResult:
    """Lint files/dirs; paths in findings are made relative to ``root``
    (default: cwd) so baseline keys are machine-independent."""
    rules = list(rules) if rules is not None else list(ALL_RULES)
    root = os.path.abspath(root or os.getcwd())
    findings: List[Finding] = []
    n_files = 0
    for fpath in iter_python_files(paths):
        n_files += 1
        with open(fpath, encoding="utf-8") as fh:
            source = fh.read()
        rel = os.path.relpath(os.path.abspath(fpath), root)
        rel = rel.replace(os.sep, "/")
        findings.extend(lint_source(source, rel, rules))
    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    baseline = baseline or Baseline()
    new, matched, expired = baseline.apply(findings)
    return LintResult(new=new, baselined=matched, expired=expired,
                      files_scanned=n_files,
                      rules=[r.name for r in rules])
