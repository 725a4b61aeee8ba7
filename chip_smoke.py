#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which fails the run:

1. Setup: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. Kernel checks: each kernel against its plain PyTorch version on the card
   at the full-width OneRec-V2 shapes of the serving path, plus adversarial
   page layouts for ``paged_decode``; max |diff| against the stated
   tolerance, kernel / plain / library time, and the roofline bound.
3. Card against CPU: the same ragged requests on a small 128-aligned
   config through the engine on the card and on the CPU (plain versions):
   first tokens and teacher-forced top-8 overlap against thresholds.
4. Full width: ``repro_torch.launch.serve --paged --kv-fp8 --fused-decode
   auto`` serves 64 ragged requests at 32 slots with FP8 weights, with
   every kernel's launch count zeroed before and read after; the counts
   must match the layer arithmetic.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP8_OPS_PER_S = 1979e12          # dense fp8 tensor-core peak
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak

# 1 bf16 ulp relative to the largest plain output: the fp8 payloads and
# scales are bit-identical, only f32 summation order (and, for attention,
# online vs dense softmax) differs, which flips a bf16 rounding now and then
TOL = 2.0 ** -7
CPU_FIRST_TOKEN_AGREE = 0.9      # card vs CPU, share of requests
CPU_TOP8_OVERLAP = 0.85          # card vs CPU, teacher-forced mean overlap


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_fp8_gemm(dev, records):
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_gemm import ops
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    # (M, K, N): decode q/o, decode k/v, a 32-request prefill's q/o
    for m, k, n in ((32, 2048, 2048), (32, 2048, 512), (12320, 2048, 2048)):
        x = torch.randn(1, m, k, device=dev, generator=g).to(torch.bfloat16)
        # a pool of weights larger than L2, rotated so every launch streams
        # its weight from HBM as a decode step does
        n_w = -(-(100 << 20) // (k * n))
        ws = [quant.quantize_per_channel(
            torch.randn(1, k, n, device=dev, generator=g) / math.sqrt(k))
            for _ in range(n_w)]
        sws = [w.scale.reshape(1, n).contiguous() for w in ws]
        out = ops.fp8_gemm(x, ws[0].data, sws[0])
        ref = ops.fp8_gemm_plain(x, ws[0].data, sws[0])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL * ref.float().abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            fail(f"fp8_gemm {m}x{k}x{n}: max |diff| {err} > {tol}")
        it = [0]

        def kern():
            i = it[0] = (it[0] + 1) % n_w
            ops.fp8_gemm(x, ws[i].data, sws[i])

        def plain():
            i = it[0] = (it[0] + 1) % n_w
            ops.fp8_gemm_plain(x, ws[i].data, sws[i])

        # library yardstick: rowwise-scaled cuBLASLt fp8 GEMM on operands
        # already quantized (excludes the row quantization the kernel does)
        xq = quant.quantize_per_token(x[0])
        wcs = [w.data[0].t().contiguous().t() for w in ws]

        def library():
            i = it[0] = (it[0] + 1) % n_w
            torch._scaled_mm(xq.data, wcs[i], scale_a=xq.scale,
                             scale_b=sws[i], out_dtype=torch.bfloat16)

        iters = 5 if m > 1024 else 50
        ms, plain_ms, lib_ms = (time_ms(kern, iters), time_ms(plain, iters),
                                time_ms(library, iters))
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                           2.0 * m * n * k, FP8_OPS_PER_S)
        print(f"[kernel] fp8_gemm M={m} K={k} N={n}: max|diff|={err:.3g} "
              f"(tol {tol:.3g}) kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, torch._scaled_mm {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        records.setdefault("fp8_gemm", dict(
            shape=f"M={m} K={k} N={n}", ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    records["fp8_gemm"]["max_abs_err"] = worst


def check_fp8_grouped_gemm(dev, records):
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_grouped_gemm import ops
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    # (E, C, K, N): decode gate/up, decode down, a 32-request prefill's gate
    for e, c, k, n in ((16, 8, 2048, 4096), (16, 8, 4096, 2048),
                       (16, 3080, 2048, 4096)):
        x = torch.randn(e, c, k, device=dev, generator=g).to(torch.bfloat16)
        w = quant.quantize_blockwise(
            torch.randn(e, k, n, device=dev, generator=g) / math.sqrt(k))
        out = ops.fp8_grouped_gemm(x, w.data, w.scale)
        ref = ops.fp8_grouped_gemm_plain(x, w.data, w.scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL * ref.float().abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            fail(f"fp8_grouped_gemm {e}x{c}x{k}x{n}: max |diff| {err} > "
                 f"{tol}")
        iters = 3 if c > 1024 else 20
        ms = time_ms(lambda: ops.fp8_grouped_gemm(x, w.data, w.scale), iters)
        plain_ms = time_ms(
            lambda: ops.fp8_grouped_gemm_plain(x, w.data, w.scale), iters)
        b_ms, b_by = bound(e * c * k * 2 + e * k * n
                           + e * (k // 128) * (n // 128) * 4 + e * c * n * 2,
                           2.0 * e * c * n * k, FP8_OPS_PER_S)
        print(f"[kernel] fp8_grouped_gemm E={e} C={c} K={k} N={n}: "
              f"max|diff|={err:.3g} (tol {tol:.3g}) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, library none, bound {b_ms:.4f} ms "
              f"({b_by})")
        records.setdefault("fp8_grouped_gemm", dict(
            shape=f"E={e} C={c} K={k} N={n}", ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    records["fp8_grouped_gemm"]["max_abs_err"] = worst


def _decode_pool(dev, lengths, *, quantized, ps, kv, hd, n_p, seed):
    """One layer of a paged pool holding ``lengths`` (one slot per entry)
    on shuffled pages; unmapped entries at the sentinel page."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(lengths)
    need = [0 if ln == 0 else ln // ps + 1 for ln in lengths]
    n_pages = sum(need) + 3                   # a few never-mapped pages
    n_pos = (n_pages + 1) * ps                # + the sentinel page
    perm = torch.randperm(n_pages, generator=g).tolist()
    tables = torch.full((b, n_p), n_pages, dtype=torch.int32)
    pos = torch.full((n_pos,), -1, dtype=torch.int32)
    nxt = 0
    for i, ln in enumerate(lengths):
        for e in range(need[i]):
            page = perm[nxt]
            nxt += 1
            tables[i, e] = page
            for o in range(ps):
                if e * ps + o <= ln:
                    pos[page * ps + o] = e * ps + o
    k = torch.randn(n_pos, kv, hd, generator=g)
    v = torch.randn(n_pos, kv, hd, generator=g)
    cache = {"pos": pos}
    if quantized:
        cache["k"], cache["k_scale"] = quant.quantize_kv(k)
        cache["v"], cache["v_scale"] = quant.quantize_kv(v)
    else:
        cache["k"], cache["v"] = k.to(torch.bfloat16), v.to(torch.bfloat16)
    cache = {n: t.to(dev) for n, t in cache.items()}
    return cache, tables.to(dev), torch.tensor(lengths, dtype=torch.int32,
                                               device=dev)


def check_paged_decode(dev, records):
    import torch
    from repro_torch.kernels.paged_decode import ops
    kv, g_heads, hd, ps, n_p, b = 4, 4, 128, 32, 13, 32
    gen = torch.Generator(device="cpu").manual_seed(3)
    serving = [int(x) for x in torch.randint(7, 388, (b,), generator=gen)]
    cases = [
        ("serving", serving),
        # empty rows, one-position rows, page-boundary lengths, a full row
        ("adversarial", [0, 1, 31, 32, 33, 63, 64, 0, 95, 96, 387, 0, 5,
                         127, 128, 129] * 2),
    ]
    worst = 0.0
    for quantized in (True, False):
        for name, lengths in cases:
            cache, tables, lens = _decode_pool(
                dev, lengths, quantized=quantized, ps=ps, kv=kv, hd=hd,
                n_p=n_p, seed=len(name) + quantized)
            q = torch.randn(len(lengths), 1, kv * g_heads, hd, generator=gen
                            ).to(torch.bfloat16).to(dev)

            def run(cache=cache, tables=tables, lens=lens, q=q):
                return ops.paged_decode_attention(q, cache, tables, lens,
                                                  page_size=ps)
            out = run()
            cpu = {n: t.cpu() for n, t in cache.items()}
            ref = ops.paged_decode_attention(q.cpu(), cpu, tables.cpu(),
                                             lens.cpu(), page_size=ps)
            plain_dev = ops.paged_decode_plain
            err = (out.float().cpu() - ref.float()).abs().max().item()
            tol = TOL * ref.float().abs().max().item()
            worst = max(worst, err)
            kind = "fp8" if quantized else "bf16"
            if not err <= tol:
                fail(f"paged_decode {name} {kind} KV: max |diff| {err} > "
                     f"{tol}")
            zero_rows = [i for i, ln in enumerate(lengths) if ln == 0]
            if bool(out[zero_rows].any()):
                fail(f"paged_decode {name} {kind} KV: an empty row is not 0")
            print(f"[kernel] paged_decode {name} {kind} KV B={len(lengths)}"
                  f": max|diff|={err:.3g} (tol {tol:.3g})")
            if name != "serving" or not quantized:
                continue
            # timing at the serving shape with fp8 KV
            qk = (q.reshape(b, 1, kv, g_heads, hd).permute(0, 2, 1, 3, 4)
                  .reshape(b, kv, g_heads, hd).contiguous())
            starts = torch.full((b,), ops.FAR_START, dtype=torch.int32,
                                device=dev)
            args = (qk, cache["k"], cache["v"], cache["pos"],
                    cache["k_scale"], cache["v_scale"], tables, lens, starts)
            kw = dict(page_size=ps, group=g_heads, branch_stride=1,
                      scale=1.0 / math.sqrt(hd))
            ms = time_ms(lambda: ops.paged_decode(*args, **kw), 50)
            plain_ms = time_ms(lambda: plain_dev(*args, **kw), 20)
            keys = sum(ln + 1 for ln in lengths)       # valid keys read
            n_bytes = (keys * (kv * (2 * hd + 2 * 4) + 4)  # k, v, scales, pos
                       + b * n_p * 4 + 2 * b * 4          # tables, lengths
                       + 2 * b * kv * g_heads * hd * 2)   # q in, out
            n_ops = 4.0 * keys * kv * g_heads * hd       # QK^T and PV
            b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
            print(f"[kernel] paged_decode B={b} Kv={kv} G={g_heads} hd={hd}"
                  f" ps={ps} P={n_p} fp8 KV: kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library none, bound {b_ms:.5f} ms "
                  f"({b_by}, {keys} keys)")
            records["paged_decode"] = dict(
                shape=f"B={b} Kv={kv} G={g_heads} hd={hd} ps={ps} P={n_p}",
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    records["paged_decode"]["max_abs_err"] = worst


# ---------------------------------------------------------------------------
# Phase 3: card against CPU on a small 128-aligned config
# ---------------------------------------------------------------------------


def card_vs_cpu(dev):
    import numpy as np
    import torch
    from repro_torch.configs.base import OneRecConfig, TransformerConfig
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.executor import PhaseExecutor
    from repro_torch.serving.requests import build_requests
    cfg = OneRecConfig(
        name="onerec-smoke-aligned", history_len=16,
        transformer=TransformerConfig(
            name="onerec-smoke-aligned-backbone", n_layers=2, d_model=256,
            n_heads=8, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=576,
            moe=True, n_experts=6, top_k=2, d_expert=256,
            capacity_factor=1.5, ep_degree=4, max_seq_len=128))
    params = init_onerec(0, cfg, device="cpu")
    reqs = build_requests(cfg, 24, 8, seed=1, ragged=True)
    ecfg = dict(batch_size=8, kv_dtype="float8_e4m3fn", page_size=32)
    outs = {}
    for d in ("cpu", dev):
        engine = ServingEngine(params, cfg, EngineConfig(**ecfg), device=d)
        outs[str(d)], stats = engine.serve_requests(reqs)
        if stats["n_requests"] != len(reqs):
            fail(f"card-vs-CPU serve on {d} completed "
                 f"{stats['n_requests']} of {len(reqs)}")
    first = np.mean([a[0] == b[0] for a, b in zip(outs["cpu"],
                                                   outs[str(dev)])])
    items = np.mean([np.array_equal(a, b) for a, b in zip(outs["cpu"],
                                                          outs[str(dev)])])
    # teacher-forced: the same prefill and decode inputs on both devices
    exs = [PhaseExecutor(params, cfg, n_slots=8, device=torch.device(d),
                         kv_dtype="float8_e4m3fn", page_size=32,
                         n_pages=8 * 2) for d in ("cpu", dev)]
    hists = [np.asarray(r["tokens"]) for r in reqs[:8]]
    profs = [np.asarray(r["profile"]) for r in reqs[:8]]
    for ex in exs:
        for s, h in enumerate(hists):
            if not ex.grant_slot(s, len(h) + 3):
                fail("card-vs-CPU page grant failed")
    logits = [ex.prefill_insert(hists, profs, list(range(8))).float().cpu()
              .numpy() for ex in exs]
    lengths = np.asarray([len(h) + 1 for h in hists], np.int32)
    overlaps = []
    for step in range(cfg.decode_len):
        top = [np.argsort(-lg, -1)[:, :8] for lg in logits]
        overlaps.append(np.mean([len(set(a) & set(b)) / 8
                                 for a, b in zip(*top)]))
        if step == cfg.decode_len - 1:
            break
        toks = np.argmax(logits[0], -1).astype(np.int32)[:, None]
        logits = [ex.decode(toks, lengths).float().cpu().numpy()
                  for ex in exs]
        lengths = lengths + 1
    print(f"[card-vs-cpu] {cfg.name}: first tokens agree on "
          f"{first:.3f} of requests (>= {CPU_FIRST_TOKEN_AGREE}), whole "
          f"items {items:.3f}; teacher-forced top-8 overlap per step "
          f"{[round(float(o), 3) for o in overlaps]} (>= "
          f"{CPU_TOP8_OVERLAP})")
    if first < CPU_FIRST_TOKEN_AGREE or min(overlaps) < CPU_TOP8_OVERLAP:
        fail("card and CPU disagree beyond the stated thresholds")


# ---------------------------------------------------------------------------
# Phase 4: full width through the launcher
# ---------------------------------------------------------------------------


def full_width(dev, extra_args=()):
    import torch
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.kernels.fp8_gemm import ops as gemm_ops
    from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
    from repro_torch.kernels.paged_decode import ops as decode_ops
    from repro_torch.launch import serve
    wrappers = {"fp8_gemm": gemm_ops.fp8_gemm,
                "fp8_grouped_gemm": grouped_ops.fp8_grouped_gemm,
                "paged_decode": decode_ops.paged_decode}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs, stats = serve.main(["--paged", "--kv-fp8", "--fused-decode",
                              "auto", "--requests", "64", "--batch", "32",
                              "--ragged", "--seed", "0",
                              "--device", str(dev), *extra_args])
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    n_layers = CONFIG.transformer.n_layers
    forwards = int(stats["prefill_calls"] + stats["decode_steps"])
    print(f"[full-width] {CONFIG.name}: {len(outs)} requests, "
          f"{int(stats['prefill_calls'])} prefills + "
          f"{int(stats['decode_steps'])} decode steps in {wall:.1f} s "
          f"(init + PTQ + serve); serve p50 "
          f"{stats['p50_latency_s'] * 1e3:.1f} ms, p99 "
          f"{stats['p99_latency_s'] * 1e3:.1f} ms, "
          f"{stats['throughput_rps']:.2f} req/s, join p50 "
          f"{stats['join_p50_s'] * 1e3:.1f} ms; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    if len(outs) != 64 or stats["n_requests"] != 64:
        fail(f"full width completed {stats['n_requests']} of 64 requests")
    for item in outs:
        if item.shape != (CONFIG.decode_len,) or not (
                (item >= 0) & (item < CONFIG.vocab_size)).all():
            fail(f"out-of-vocabulary or short item {item}")
    expect = {"paged_decode": int(stats["decode_steps"]) * n_layers,
              "fp8_gemm": forwards * 4 * n_layers,          # q, k, v, o
              "fp8_grouped_gemm": forwards * 3 * n_layers}  # gate, up, down
    if launches != expect or not all(launches.values()):
        fail(f"launch counts {launches} != layer arithmetic {expect}")
    return launches, stats


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"{SRC}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, SRC)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    dev = resolve_device("cuda")
    card = card_line()
    print(f"[setup] card: {card}; torch {torch.__version__} CUDA "
          f"{torch.version.cuda}")
    secs = build.build_all()
    print(f"[setup] built {len(build.SOURCES)} kernels in {secs:.1f} s")
    for name, log in build.BUILD_LOG.items():
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"[setup] ptxas {name}: " + " | ".join(regs))

    records = {}
    check_fp8_gemm(dev, records)
    check_fp8_grouped_gemm(dev, records)
    check_paged_decode(dev, records)
    card_vs_cpu(dev)
    launches, _ = full_width(dev)

    replaces = {"fp8_gemm": "src/repro/kernels/fp8_gemm/kernel.py:27",
                "fp8_grouped_gemm":
                    "src/repro/kernels/fp8_grouped_gemm/kernel.py:27",
                "paged_decode": "src/repro/kernels/paged_decode/kernel.py:43"}
    kernels = []
    for name in ("fp8_gemm", "fp8_grouped_gemm", "paged_decode"):
        r = records[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{build.SOURCES[name]}",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
