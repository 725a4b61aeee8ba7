"""Serving launcher of the port: OneRec-V2 generation with FP8 weights, on
the card.

  PYTHONPATH=src python -m repro_torch.launch.serve [--paged] [--kv-fp8] \
      [--fused-decode off|auto] [--mode continuous|fixed] \
      [--n-candidates 1] [--reduced] [--requests 64] [--batch 32] \
      [--slots 32] [--ragged] [--no-fp8] [--page-size 32] [--pages 0] \
      [--rate 8.0] [--max-queue 64] [--hold-k 4] [--hold-ms 25] \
      [--prefix-cache [--prefix-rows 32] [--second-sight]] \
      [--prefill-chunk 32] [--preemption] [--quant-policy PATH] [--seed 0] \
      [--device cuda|cpu]

The flags are the JAX launcher's (``repro/launch/serve.py``) that the port
covers, with its layouts: ``--paged`` serves the paged KV pool, decoding
through kernel ``paged_decode`` (``--fused-decode auto``, the default
there) or through the gathered view (``off``); without it the contiguous
slot pool serves with ``fused_decode="off"`` (``--fused-decode auto`` is
then an error).  With ``--rate`` requests are submitted at wall-clock
Poisson arrivals (``run_open_loop``, shedding on a full ``--max-queue``);
without it the closed-batch ``serve_requests`` serves everything queued up
front.  ``--mode fixed`` serves lock-step fixed batches (the contiguous
layout only); ``--n-candidates K`` asks every request for a ranked set of
K items, decoded as a tree (continuous mode).  The kernels
``batch_attention`` and ``radix_topk`` are reached through the model
config's ``use_attention_kernel`` and
``EngineConfig.use_radix_topk``, as in the JAX package, not through flags.
``--quant-policy`` deploys a policy artifact (``core.policy.
save_policy_artifact``: per-group fp8 / bf16 / int8 decisions and
calibrated static activation scales) instead of the all-or-nothing
``--no-fp8`` switch.  ``--device cpu`` runs every kernel's plain PyTorch
version on the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import onerec_v2
from repro_torch.models import onerec as onerec_model
from repro_torch.serving import EngineConfig, ServingEngine, run_open_loop
from repro_torch.serving.requests import build_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--no-fp8", dest="fp8", action="store_false",
                    default=True)
    ap.add_argument("--mode", choices=("continuous", "fixed"),
                    default="continuous",
                    help="continuous batching, or the fixed-batch reference "
                         "(lock-step batches; contiguous layout only)")
    ap.add_argument("--kv-fp8", action="store_true",
                    help="store K/V in fp8 (e4m3) with per-(position, head) "
                         "scales; the decode kernel dequantizes in "
                         "registers")
    ap.add_argument("--slots", type=int, default=0,
                    help="KV-slot pool size (0 => batch size)")
    ap.add_argument("--ragged", action="store_true",
                    help="mixed history lengths")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s: submit "
                         "each request at its wall-clock arrival (0 = "
                         "closed-batch serve_requests)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission-queue bound (0 = unbounded); open-loop "
                         "mode sheds the rejected requests")
    ap.add_argument("--hold-k", type=int, default=0,
                    help="admission hold window: defer the join round "
                         "until K arrived requests accumulated")
    ap.add_argument("--hold-ms", type=float, default=0.0,
                    help="max milliseconds the hold window may defer the "
                         "oldest arrived request")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="content-addressed prefix reuse across requests")
    ap.add_argument("--prefix-rows", type=int, default=0,
                    help="prefix-store entries (0 => 2x slots)")
    ap.add_argument("--second-sight", action="store_true",
                    help="store a prefix only when it is offered the "
                         "second time (requires --prefix-cache)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="max history tokens per prefill program (0 = "
                         "monolithic)")
    ap.add_argument("--preemption", action="store_true",
                    help="free the worst decoding slot for a strictly "
                         "higher-priority arrival")
    ap.add_argument("--n-candidates", type=int, default=1,
                    help="candidate items decoded per request: one "
                         "tree-decode step advances all K branches of every "
                         "slot over its shared prefix K/V (continuous mode; "
                         "completions carry the ranked candidate set)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV layout (default: the contiguous slot "
                         "pool)")
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = one full row per slot)")
    ap.add_argument("--fused-decode", choices=("off", "auto"),
                    default=None,
                    help="under --paged, decode attention through kernel "
                         "paged_decode ('auto', the default) or the "
                         "gathered view ('off'); without --paged only "
                         "'off'")
    ap.add_argument("--quant-policy", default=None, metavar="PATH",
                    help="load a tuned mixed-precision policy artifact "
                         "instead of the all-or-nothing --no-fp8 switch: "
                         "per-group fp8/bf16/int8 assignment plus "
                         "calibrated static activation scales deploy as "
                         "data")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params AND the synthetic workload")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(plain PyTorch versions of every kernel)")
    args = ap.parse_args(argv)
    if not args.paged and args.fused_decode == "auto":
        ap.error("--fused-decode auto needs --paged: the contiguous layout "
                 "has no fused decode")
    fused = args.fused_decode or ("auto" if args.paged else "off")

    cfg = onerec_v2.reduced_config() if args.reduced else onerec_v2.CONFIG
    batch = args.batch or cfg.serve_batch
    params = onerec_model.init_onerec(args.seed, cfg, device=args.device)
    engine = ServingEngine(params, cfg, EngineConfig(
        batch_size=batch, use_fp8=args.fp8, mode=args.mode,
        max_candidates=args.n_candidates,
        kv_dtype="float8_e4m3fn" if args.kv_fp8 else "bfloat16",
        n_slots=args.slots, max_queue=args.max_queue, hold_k=args.hold_k,
        hold_ms=args.hold_ms, prefix_cache=args.prefix_cache,
        prefix_rows=args.prefix_rows,
        store_on_first_sight=not args.second_sight,
        prefill_chunk=args.prefill_chunk, preemption=args.preemption,
        paged=args.paged, page_size=args.page_size, n_pages=args.pages,
        fused_decode=fused, quant_policy=args.quant_policy),
        device=args.device)
    del params       # the engine holds the quantized tree
    requests = build_requests(cfg, args.requests, batch, args.seed,
                              args.ragged, n_candidates=args.n_candidates)
    if args.rate > 0:
        # arrival-driven open loop: wall-clock Poisson submission
        rng = np.random.default_rng(args.seed)
        offsets = np.cumsum(rng.exponential(1.0 / args.rate,
                                            size=len(requests)))
        timed = [dict(r, arrival_s=float(t))
                 for r, t in zip(requests, offsets)]
        outs, stats = run_open_loop(engine, timed,
                                    drop_on_full=bool(args.max_queue))
        print(f"[serve] open loop @ {args.rate:.1f} req/s offered: served "
              f"{sum(o is not None for o in outs)}/{len(requests)} "
              f"(rejected {int(stats['rejected'])}), hold rounds "
              f"{int(stats['hold_rounds'])}, prefill programs "
              f"{int(stats['prefill_calls'])}")
    else:
        outs, stats = engine.serve_requests(requests)

    if args.quant_policy:
        pol = engine.executor.quant_policy
        print(f"[serve] quant policy: {args.quant_policy} "
              f"({len(pol.overrides)} overrides, "
              f"static_acts={pol.static_acts})")
    print(f"[serve] mode={stats['mode']} fp8={args.fp8} "
          f"kv={stats['kv_dtype']} "
          f"({int(stats['kv_row_bytes'])} B/row, "
          f"{int(stats['kv_bytes'])} B total) "
          f"requests={len(requests)} slots={int(stats['n_slots'])} "
          f"occupancy={stats['slot_occupancy']:.2f}")
    if args.paged:
        print(f"[serve] paged KV: {int(stats['pages_total'])} pages x "
              f"{int(stats['page_size'])} positions "
              f"({int(stats['pages_free'])} free, "
              f"{int(stats['kv_bytes_pinned'])} B pinned after drain) | "
              f"prefix hits: {int(stats['prefix_row_copies'])} full-row "
              f"copies, {int(stats['cow_copies'])} COW page copies")
    if fused != "off":
        print(f"[serve] fused decode: mode={stats['fused_decode_mode']} | "
              f"{int(stats['fused_decode_steps'])}/"
              f"{int(stats['decode_steps'])} decode steps fused | "
              f"{int(stats['fused_select_hits'])} select dispatches "
              f"folded into the decode step")
    if args.prefix_cache:
        print(f"[serve] prefix cache: hit-rate "
              f"{stats['prefix_hit_rate']:.2f} "
              f"({int(stats['prefix_hits'])}/"
              f"{int(stats['prefix_admissions'])}), "
              f"saved {int(stats['prefix_tokens_saved'])} prefill tokens, "
              f"{int(stats['prefix_entries'])} entries / "
              f"{int(stats['prefix_store_bytes'])} B stored, "
              f"peak pinned {int(stats['prefix_bytes_pinned'])} B, "
              f"{int(stats['prefix_evictions'])} evictions"
              + (f", {int(stats['prefix_first_sights'])} first-sight "
                 f"record-only offers" if args.second_sight else ""))
    print(f"[serve] per-request latency: "
          f"mean={stats['mean_latency_s']*1e3:.1f}ms "
          f"p50={stats['p50_latency_s']*1e3:.1f}ms "
          f"p99={stats['p99_latency_s']*1e3:.1f}ms | "
          f"throughput={stats['throughput_rps']:.1f} req/s")
    print(f"[serve] join steps: {int(stats['join_steps'])} "
          f"(p50={stats['join_p50_s']*1e3:.1f}ms "
          f"p99={stats['join_p99_s']*1e3:.1f}ms, "
          f"decode-stall {100*stats['decode_stall_frac']:.0f}% of wall) | "
          f"preemptions={int(stats['preemptions'])} "
          f"resumes={int(stats['resume_calls'])}")
    if args.n_candidates > 1:
        print(f"[serve] multi-candidate: K={args.n_candidates} | "
              f"tree-decode steps {int(stats['decode_multi_steps'])}/"
              f"{int(stats['decode_steps'])} decode steps | "
              f"{stats['branches_per_decode_step']:.1f} branches/step")
    return outs, stats


if __name__ == "__main__":
    main()
