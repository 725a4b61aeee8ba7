"""Mixed-precision auto-tuner launcher: search a per-group quantization
policy per zoo config and write the deployable artifact (the JAX package's
``repro/launch/autotune.py``, on the card unless ``--device cpu``).

  PYTHONPATH=src python -m repro_torch.launch.autotune \\
      [--arch onerec-v2 --arch deepseek-moe-16b --arch din] \\
      [--target 0.6] [--max-steps 16] [--topk 8] [--seed 0] \\
      [--no-int8] [--no-expand] [--no-static-acts] [--out results] \\
      [--device cpu]

Each arch gets the greedy accuracy-aware search of
``repro_torch.core.autotune`` on its reduced config.  Artifacts land at
``<out>/quant_policy_<arch>.json`` (the JAX package's format) beside
``<out>/autotune_summary.json``, and deploy through
``repro_torch.launch.serve --quant-policy PATH``.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.core.autotune import autotune, make_eval_task

DEFAULT_ARCHS = ("onerec-v2", "deepseek-moe-16b", "din")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None,
                    help="zoo config to tune (repeatable; default: "
                         f"{', '.join(DEFAULT_ARCHS)})")
    ap.add_argument("--target", type=float, default=0.6,
                    help="teacher-forced top-K overlap the tuned policy "
                         "must hold (the parity-suite threshold)")
    ap.add_argument("--max-steps", type=int, default=16,
                    help="max candidate evaluations per arch")
    ap.add_argument("--topk", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-int8", dest="int8", action="store_false",
                    default=True, help="skip the W8A8 frontier phase")
    ap.add_argument("--no-expand", dest="expand", action="store_false",
                    default=True,
                    help="skip quantizing default-excluded groups")
    ap.add_argument("--no-static-acts", dest="static_acts",
                    action="store_false", default=True,
                    help="skip static activation-scale calibration")
    ap.add_argument("--out", default="results",
                    help="artifact directory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)

    archs = args.arch or list(DEFAULT_ARCHS)
    summary = {}
    for arch in archs:
        print(f"== autotune {arch} (target overlap {args.target}) ==")
        task = make_eval_task(arch, seed=args.seed, topk=args.topk,
                              device=args.device)
        result = autotune(task, target=args.target,
                          max_steps=args.max_steps,
                          try_expand=args.expand, try_int8=args.int8,
                          try_static_acts=args.static_acts, log=print)
        path = os.path.join(args.out, f"quant_policy_{arch}.json")
        result.save(path, config=arch)
        gain = result.bytes_quantized - result.uniform["bytes_quantized"]
        print(f"  -> {path}: overlap {result.overlap:.3f} "
              f"(uniform {result.uniform['overlap']:.3f}), "
              f"bytes {result.bytes_quantized} "
              f"({'+' if gain >= 0 else ''}{gain} vs uniform), "
              f"{len(result.policy.overrides)} overrides, "
              f"static_acts={result.policy.static_acts}")
        summary[arch] = dict(
            overlap=result.overlap, target=args.target,
            bytes_quantized=result.bytes_quantized,
            uniform=result.uniform, artifact=path,
            overrides=[list(o) for o in result.policy.overrides],
            static_acts=result.policy.static_acts)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "autotune_summary.json"), "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    print(f"summary -> {os.path.join(args.out, 'autotune_summary.json')}")
    return summary


if __name__ == "__main__":
    main()
