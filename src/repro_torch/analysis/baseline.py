"""Checked-in lint baseline: accepted pre-existing violations (the JAX
package's ``repro/analysis/baseline.py``, the same file format).

The baseline file (``src/repro_torch/analysis/lint_baseline.json``) maps
finding keys -- ``file::rule::snippet`` -- to an accepted COUNT, so
accepted violations do not fail the lint while every NEW one does:

  * **match** -- a current finding whose key has remaining count is
    "baselined" (reported, not fatal); the count decrements, so two
    identical offending lines need an accepted count of 2.
  * **add** -- ``python -m repro_torch.launch.lint --update-baseline``
    rewrites the file from the CURRENT findings (the only way entries get
    in).
  * **expire** -- accepted entries that no longer fire are returned as
    ``expired``: the violation was fixed, so the baseline should shrink.
    ``--update-baseline`` drops them; ``--fail-on-expired`` makes a stale
    baseline a failure, so it can never mask a regression at the same key
    later.

The shipped baseline is EMPTY: every finding in ``src/repro_torch`` was
fixed or annotated where it is deliberate.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1
_SEP = "::"


def _key_str(key: Tuple[str, str, str]) -> str:
    return _SEP.join(key)


def _key_tuple(s: str) -> Tuple[str, str, str]:
    parts = s.split(_SEP, 2)
    if len(parts) != 3:
        raise ValueError(f"malformed baseline key {s!r}")
    return (parts[0], parts[1], parts[2])


class Baseline:
    """Accepted-finding counts keyed by ``Finding.key()``."""

    def __init__(self, entries: Dict[str, int] | None = None):
        self.entries: Dict[str, int] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        """Load a baseline file; a missing file is an empty baseline."""
        if not os.path.exists(path):
            return cls()
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        if data.get("version") != BASELINE_VERSION:
            raise ValueError(
                f"{path}: baseline version {data.get('version')!r} != "
                f"{BASELINE_VERSION}")
        entries = data.get("entries", {})
        if not all(isinstance(v, int) and v > 0 for v in entries.values()):
            raise ValueError(f"{path}: baseline counts must be positive ints")
        return cls(entries)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": BASELINE_VERSION,
                       "entries": dict(sorted(self.entries.items()))},
                      fh, indent=2, sort_keys=False)
            fh.write("\n")

    @classmethod
    def from_findings(cls, findings: Sequence[Finding]) -> "Baseline":
        entries: Dict[str, int] = {}
        for f in findings:
            k = _key_str(f.key())
            entries[k] = entries.get(k, 0) + 1
        return cls(entries)

    def apply(self, findings: Sequence[Finding]
              ) -> Tuple[List[Finding], List[Finding],
                         List[Tuple[str, str, str]]]:
        """Split ``findings`` into (new, baselined) and report expired
        entries (accepted keys/counts no current finding consumed)."""
        remaining = dict(self.entries)
        new: List[Finding] = []
        matched: List[Finding] = []
        for f in findings:
            k = _key_str(f.key())
            if remaining.get(k, 0) > 0:
                remaining[k] -= 1
                matched.append(f)
            else:
                new.append(f)
        expired = [_key_tuple(k) for k, n in sorted(remaining.items())
                   for _ in range(n) if n > 0]
        return new, matched, expired
