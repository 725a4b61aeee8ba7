"""Serving launcher of the port: OneRec-V2 generation with FP8 weights and
the paged KV pool with fused decode, on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --paged --kv-fp8 \
      --fused-decode auto [--reduced] [--requests 64] [--batch 32] \
      [--slots 32] [--ragged] [--no-fp8] [--page-size 32] [--pages 0] \
      [--seed 0] [--device cuda|cpu]

The flags are the JAX launcher's (``repro/launch/serve.py``) that this
slice covers; the layout is always paged with fused decode, so ``--paged``
and ``--fused-decode auto`` only restate it.  ``--device cpu`` runs every
kernel's plain PyTorch version on the CPU.
"""

from __future__ import annotations

import argparse

from repro_torch.configs import onerec_v2
from repro_torch.models import onerec as onerec_model
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.requests import build_requests


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--no-fp8", dest="fp8", action="store_false",
                    default=True)
    ap.add_argument("--kv-fp8", action="store_true",
                    help="store K/V in fp8 (e4m3) with per-(position, head) "
                         "scales; the decode kernel dequantizes in "
                         "registers")
    ap.add_argument("--slots", type=int, default=0,
                    help="KV-slot pool size (0 => batch size)")
    ap.add_argument("--ragged", action="store_true",
                    help="mixed history lengths")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV layout (the only layout of the port)")
    ap.add_argument("--page-size", type=int, default=32)
    ap.add_argument("--pages", type=int, default=0,
                    help="page-pool size (0 = one full row per slot)")
    ap.add_argument("--fused-decode", choices=("off", "auto"),
                    default="auto",
                    help="decode attention through kernel paged_decode "
                         "(the only decode path of the port; 'off' is not "
                         "ported)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seeds the params AND the synthetic workload")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "(plain PyTorch versions of every kernel)")
    args = ap.parse_args(argv)

    cfg = onerec_v2.reduced_config() if args.reduced else onerec_v2.CONFIG
    batch = args.batch or cfg.serve_batch
    params = onerec_model.init_onerec(args.seed, cfg, device=args.device)
    engine = ServingEngine(params, cfg, EngineConfig(
        batch_size=batch, use_fp8=args.fp8,
        kv_dtype="float8_e4m3fn" if args.kv_fp8 else "bfloat16",
        n_slots=args.slots, page_size=args.page_size, n_pages=args.pages,
        fused_decode=args.fused_decode), device=args.device)
    del params       # the engine holds the quantized tree
    requests = build_requests(cfg, args.requests, batch, args.seed,
                              args.ragged)
    outs, stats = engine.serve_requests(requests)

    print(f"[serve] mode={stats['mode']} fp8={args.fp8} "
          f"kv={stats['kv_dtype']} "
          f"({int(stats['kv_row_bytes'])} B/row, "
          f"{int(stats['kv_bytes'])} B total) "
          f"requests={len(requests)} slots={int(stats['n_slots'])} "
          f"occupancy={stats['slot_occupancy']:.2f}")
    print(f"[serve] paged KV: {int(stats['pages_total'])} pages x "
          f"{int(stats['page_size'])} positions "
          f"({int(stats['pages_free'])} free, "
          f"{int(stats['kv_bytes_pinned'])} B pinned after drain)")
    print(f"[serve] fused decode: mode={stats['fused_decode_mode']} | "
          f"{int(stats['fused_decode_steps'])}/"
          f"{int(stats['decode_steps'])} decode steps fused | "
          f"{int(stats['fused_select_hits'])} select dispatches "
          f"folded into the decode step")
    print(f"[serve] per-request latency: "
          f"mean={stats['mean_latency_s']*1e3:.1f}ms "
          f"p50={stats['p50_latency_s']*1e3:.1f}ms "
          f"p99={stats['p99_latency_s']*1e3:.1f}ms | "
          f"throughput={stats['throughput_rps']:.1f} req/s")
    print(f"[serve] join steps: {int(stats['join_steps'])} "
          f"(p50={stats['join_p50_s']*1e3:.1f}ms "
          f"p99={stats['join_p99_s']*1e3:.1f}ms, "
          f"decode-stall {100*stats['decode_stall_frac']:.0f}% of wall)")
    return outs, stats


if __name__ == "__main__":
    main()
