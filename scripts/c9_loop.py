"""Serve ``chip_smoke.py`` phase 3's ``paged`` case in many fresh processes
on the card and report which runs differ from the first, by field and
request or step (ROADMAP.md C9; the case and the comparison are
``tests/test_torch_cuda.py``'s ``_PAGED_CASE`` and
``paged_case_difference``).  Every record is written under ``--out``.

Usage (from the repo root, on a machine with the card):
  python3 scripts/c9_loop.py --runs 30 --out build/c9_loop
"""

import argparse
import collections
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=30)
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "c9_loop"))
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from test_torch_cuda import paged_case_difference, run_paged_case
    os.makedirs(args.out, exist_ok=True)
    runs, t0 = [], time.perf_counter()
    for i in range(args.runs):
        runs.append(run_paged_case(ROOT))
        with open(os.path.join(args.out, f"run{i}.json"), "w") as f:
            json.dump(runs[-1], f)
    diffs = {i: paged_case_difference(runs[0], r)
             for i, r in enumerate(runs[1:], 1)}
    bad = {i: d for i, d in diffs.items() if d}
    kinds = collections.Counter(json.dumps(r, sort_keys=True) for r in runs)
    print(f"[c9] {args.runs} fresh processes in "
          f"{time.perf_counter() - t0:.1f} s: {len(kinds)} distinct "
          f"record(s); {len(bad)} differ from run 0")
    for i, d in sorted(bad.items()):
        print(f"[c9] run {i}: {d}")
    print(json.dumps({"runs": args.runs, "distinct": len(kinds),
                      "differ": {str(i): d for i, d in bad.items()}}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
