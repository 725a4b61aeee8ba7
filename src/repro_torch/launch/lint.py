"""The port's linter (the JAX package's ``scripts/lint_repro.py``, with its
flags): the ``repro_torch.analysis`` AST rules -- module-level tensors,
host branches on tensors, fp8 seam violations, unbucketed step shapes,
hidden host syncs, index dtype drift, and the port's ground rules (device
switches, kernel fallbacks, host-scalar division in ``core/quant.py``,
scalar writes through index tensors) -- over the given files and
directories, failing on findings the checked-in baseline does not accept.

Usage:
    python -m repro_torch.launch.lint src/repro_torch
    python -m repro_torch.launch.lint src/repro_torch --json report.json
    python -m repro_torch.launch.lint src/repro_torch --update-baseline
    python -m repro_torch.launch.lint --list-rules

Exit status: 0 clean (or baselined only), 1 on new findings (and, with
``--fail-on-expired``, on stale baseline entries).  Imports neither torch
nor numpy, so it runs before either is installed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch import analysis
from repro_torch.analysis import (ALL_RULES, NOT_PORTED, Baseline,
                                  lint_paths, select_rules)

DEFAULT_BASELINE = os.path.join(os.path.dirname(analysis.__file__),
                                "lint_baseline.json")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE,
                        help="baseline JSON of accepted findings")
    parser.add_argument("--update-baseline", action="store_true",
                        help="rewrite the baseline from current findings")
    parser.add_argument("--fail-on-expired", action="store_true",
                        help="fail when baseline entries no longer fire")
    parser.add_argument("--json", default=None, metavar="PATH",
                        help="write the machine-readable report here")
    parser.add_argument("--rules", default=None,
                        help="comma-separated subset of rules to run")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.name:24s} {rule.description}")
        for name, why in NOT_PORTED.items():
            print(f"{'(' + name + ')':24s} not ported: {why}")
        return 0
    if not args.paths:
        parser.error("no paths given (try: src/repro_torch)")

    rules = select_rules(args.rules.split(",") if args.rules else None)
    baseline = Baseline.load(args.baseline)
    result = lint_paths(args.paths, baseline=baseline, rules=rules)

    if args.update_baseline:
        Baseline.from_findings(result.all_findings).save(args.baseline)
        print(f"baseline updated: {len(result.all_findings)} accepted "
              f"finding(s) -> {args.baseline}")
        return 0

    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as fh:
            json.dump(result.report(), fh, indent=2)
            fh.write("\n")

    for f in result.baselined:
        print(f"{f}  [baselined]")
    for f in result.new:
        print(f)
    for key in result.expired:
        print(f"expired baseline entry (violation fixed -- refresh with "
              f"--update-baseline): {'::'.join(key)}")

    status = "FAILED" if result.failed(args.fail_on_expired) else "ok"
    print(f"lint: {result.files_scanned} file(s), {len(result.new)} new, "
          f"{len(result.baselined)} baselined, {len(result.expired)} "
          f"expired -- {status}")
    return 1 if result.failed(args.fail_on_expired) else 0


if __name__ == "__main__":
    sys.exit(main())
