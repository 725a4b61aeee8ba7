#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

from the root of a checkout.  Phases, each of which fails the run:

1. Setup: the card's name and power limit; build every CUDA kernel from
   ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel).
2. Kernel checks: each kernel against its plain PyTorch version on the card
   at the full-width OneRec-V2 shapes of the serving path and at the LM
   zoo's (``fp8_gemm`` at llama3-8b's gate and down, N and K = 10944 and
   gemma3's N = 256, decode and prefill rows; ``fp8_grouped_gemm`` at 64
   experts; ``batch_attention`` at S = 4112, hd 256 over a wrapped
   512-slot ring, G = 1, 4 and 7), plus adversarial
   page layouts and tree-decode cases at 16, 32 and 64 query rows a KV
   head (fp8 and bf16 pools, dummy branches) for ``paged_decode``, rows of
   ties
   and +-0.0 and a case for each path of ``radix_topk`` (k = 1024 and
   k = V, equal values, odd and unaligned rows, pad columns, tiles, 1 and
   128 rows, and a W = 8 beam step's 32 rows of 66048) and prefill-shaped
   and windowed calls for
   ``batch_attention``; max |diff| against the stated tolerance (identical
   values and indices for ``radix_topk``), kernel / plain / library time,
   and the roofline bound; for ``radix_topk`` also an empty kernel of its
   launch shape (the floor of a launch).  Kernels are
   timed as device time (the calls captured in a CUDA graph) and as eager
   calls, against their library call in turns where there is one;
   ``fp8_gemm`` and ``fp8_grouped_gemm`` at every timed shape (decode and
   prefill), their quantization pass and
   GEMM also apart, their library calls with and without the activation
   quantization (the grouped GEMM's block-scaled library calls are
   recorded with the build's refusal where it refuses them), the grouped
   GEMM's two paths against each other around their threshold; and the
   contiguous decode's fp8 -> bf16 dequantization beside
   ``batch_attention``.  Both GEMM kernels fail the run if more than
   ``OFF_EXACT_MAX`` of their outputs differ from the bf16 rounding of the
   same function summed in float64 (the f32 sums of the Pallas kernels),
   ``fp8_gemm``'s static mode (one calibrated activation scale) too.
   ``fp8_gemm`` also runs at the recsys family's 13 quantized (K, N) (K =
   180, 200, 270 and N = 1, 80, 200 among them: ROADMAP C5), each at the
   rows ``serve_p99`` and the most phase 4 (i) gives it, held to both
   bounds, beside ``torch._scaled_mm`` or its refusal.  The int8 product
   (``quant.int8_linear``) must equal its CPU result bit for bit; it is
   timed.  The raw (unquantized) bf16 products (ROADMAP C6: cuBLAS on the
   tensor cores through ``quant.raw_matmul``) at OneRec-V2's lm_head and
   router, llama3-8b's lm_head, two-tower's user tower and DIN's attention
   MLP at 262144 rows, a raw expert product and the plain attention's
   scores and PV at the zoo prefill's chunk, each held to
   ``OFF_EXACT_MAX`` and timed against the f32 product it replaced.
3. Card against CPU: the same ragged requests on a small 128-aligned
   config through the engine on the card and on the CPU (plain versions),
   in nine cases, each held to both bars: the paged layout; the paged
   layout decoding unfused (``fused_decode="off"``); the paged layout
   with the prefix store, chunked prefill and preemption, on the requests
   split into two priority classes and on first and return visits, each
   on one schedule; the paged layout through a policy artifact (static
   activation scales calibrated on the CPU, int8 k projections); the
   contiguous layout with ``use_attention_kernel`` and
   ``use_radix_topk``, and the same in fixed mode; tree decode on the
   paged layout (``max_candidates=8``, widths 1, 3, 4, 8: branch seeds
   and ranked items); ``generate_items`` and ``beam_generate`` over the
   batch-shared cache with ``topk_fn=radix_topk``; and two small LM
   configs (``lm-gemma``: windows, a global layer every third, QK-norm,
   sandwich and zero-centred norms, tied and scaled embeddings, GeGLU,
   head_dim 256; ``lm-moe``: a leading dense layer, 16 experts top-4 with
   shared experts and their gate, MHA) through ``lm_bundle``'s prefill and
   8 greedy decode steps with ``use_attention_kernel``: first tokens and
   teacher-forced top-8 overlap against thresholds; and the four recsys
   ``reduced_config()``s on bf16-compute and fp8 weights (``recsys-*``):
   scores of 512 users within relative L2 1e-2, top-10 overlap of one
   user's retrieval over 4096 candidates >= 0.9.
4. Full width, ten main paths, each kernel's launch count (and the int8
   product's) zeroed before and read after each; the counts must match
   the layer arithmetic:
   (a) ``repro_torch.launch.serve --paged --kv-fp8 --fused-decode auto``
   serves 64 ragged requests at 32 slots with FP8 weights (kernels
   ``fp8_gemm``, ``fp8_grouped_gemm``, ``paged_decode``);
   (b) ``ServingEngine`` serves the same requests over the contiguous FP8
   slot pool with ``use_attention_kernel`` and ``use_radix_topk`` (kernels
   ``fp8_gemm``, ``fp8_grouped_gemm``, ``batch_attention``,
   ``radix_topk``);
   (c) ``ServingEngine`` on the paged FP8 pool with the prefix store,
   chunked prefill (128 tokens) and preemption serves 32 first visits at
   priority 1, then 32 return visits at priority 0 (each a first visit's
   profile and history plus one item) through ``submit`` / ``step`` /
   ``drain`` (kernels ``fp8_gemm``, ``fp8_grouped_gemm``,
   ``paged_decode``); resumes, prefix hits, copy-on-write pages and
   preemptions must each occur.  The same visits are then served with
   the three knobs off, for information;
   (d) ``ServingEngine`` on (a)'s paged pool through a policy artifact
   whose static scales are calibrated on the card, the k projections in
   int8 (``fp8_gemm`` in its static mode, the int8 product,
   ``fp8_grouped_gemm``, ``paged_decode``), serving (a)'s requests;
   (e) ``ServingEngine`` on (a)'s paged pool with ``max_candidates=8``
   serves (a)'s requests asking for 8, 4, 3, 1 candidates in turn
   (``paged_decode`` in tree mode): tree steps, branch tokens and fused
   selects occur, every completion holds its distinct ranked items;
   (f) ``ServingEngine(mode="fixed")`` on (b)'s contiguous pool serves the
   requests in two lock-step batches (``batch_attention``,
   ``radix_topk``), its latency beside (b)'s;
   (g) ``generate_items`` and ``beam_generate(beam_width=8)`` on 32 full
   histories over the batch-shared cache with ``use_attention_kernel``
   and ``topk_fn=radix_topk`` (``batch_attention``, ``radix_topk``);
   beams sorted, a beam of one equal to the greedy items;
   (h) ``lm-zoo``: llama3-8b, gemma3-1b, qwen2-moe-a2.7b, deepseek-moe-16b
   and deepseek-coder-33b at their published widths and depth, FP8 PTQ
   layer by layer at init, a prefill of 4 prompts of 4096 tokens from
   ``SyntheticLMStream``, then 16 ``decode_fused`` steps over a shared
   bf16 cache of 4112 positions with ``use_attention_kernel``
   (``fp8_gemm``, ``fp8_grouped_gemm``, ``batch_attention``); finite
   logits, counts held to the layer arithmetic for the prefill and the
   decode apart;
   (i) ``recsys``: two-tower, MIND, DIN and DIEN at published widths and
   full tables (10 M item rows), bf16-compute and fp8 weights, inputs
   from ``SyntheticInteractions``: ``serve_p99`` (512 users),
   ``serve_bulk`` (262144) and ``retrieval_cand`` (one user against 1 M
   candidates, fed in chunks): ``fp8_gemm`` 6 / 1 / 3 / 3 a call (a
   chunk), p50 ms, rows a second, peak memory, fp8 against bf16, and the
   embedding gathers beside their byte bound;
   (j) ``egnn`` at its published width (4 layers, d 64) on
   ``full_graph_sm``, ``minibatch_lg`` (one ``NeighborSampler`` batch) and
   ``molecule``: ms, peak memory, E(3) equivariance error on the card;
   two forwards of each bit-identical (ROADMAP C7), and in (i) two
   ``embedding_bag`` ``sum`` / ``mean`` calls at two-tower's
   ``serve_bulk`` shape; ``segment_sum`` timed against ``index_add_``.
   (a)'s decode steps after the first run under
   ``analysis.guards.steady_state()``: no unsanctioned host sync, no
   kernel build (N10a).
5. The paper's distribution analysis and auto-tuner (N9a): the Fig.-1
   report of the full-width OneRec-V2 params and of one 32-request
   forward's activation taps, the same for DIN at published widths, each
   with ``feasibility_verdict``, time and peak memory; one reduced DIN
   search whose artifact is deployed.
6. Training (N9b), every kernel's launch count zeroed before and read
   after (a train step runs raw cuBLAS products: all stay 0):
   (k) OneRec-V2 at full width and ``TRAIN_LAYERS`` of its 12 layers (f32
   params, gradients and AdamW's f32 moments hold 16 bytes a parameter,
   ~79.9 GB at 12 layers), the ``train_b512`` bundle at 32 of its 512 rows
   of 384 tokens, 3 steps: step, device and host times, loss, global norm,
   peak memory against 16 bytes a parameter; a second run from the same
   seed bit-identical; (l) the Table-1 analogue, ``tests/test_system.py``'s
   config, schedule and bounds: OneRec-mini trained 120 steps, its Fig.-1
   report, BF16 and FP8 hit rates through the engine, PTQ coverage; (m)
   DIN (reduced) trained until its loss falls below ``DIN_LOSS_DROP`` of
   its start, then the FP8 against BF16 score deviation of the trained and
   the initial params; (n) one gradient of reduced OneRec-V2 and of a
   reduced MoE LM with the load-balance loss on the card against the CPU,
   and one AdamW step on equal gradients.
7. The training runner and its checkpoints (N9c), every kernel's launch
   count zeroed before each case and read after:
   (o) OneRec-V2 at full width and ``CKPT_LAYERS`` layer through
   ``launch.train``'s ``training_for``, ``FaultTolerantRunner`` and
   ``AsyncCheckpointer`` (checkpoints in the JAX format under
   ``build/phase7``): a run with injected faults and a clean run, bitwise
   equal at the end with exactly the injected restarts, every checkpoint
   verified, no second state in device memory (peak within
   ``CKPT_PEAK_SLACK``); checkpoint bytes, the time ``save`` holds the
   training thread, the writer's GB/s, restore and step times, and what a
   6- and a 12-layer checkpoint would cost at those rates; launches 0;
   (p) the FP8 deployment checkpoint: (a)'s params PTQ'd with the paper's
   policy, saved, loaded into a fresh tree (K-major payloads laid out
   again, bytes and hash equal) and served as (a) serves: (a)'s items and
   launch counts exactly;
   (q) ``launch.train``'s ``main`` on reduced OneRec-V2 (compressed
   gradients) and DIN: the loss falls, a second run resumes the last
   step and takes none; ``ef_compress`` on the card against the CPU,
   0 ulps.
8. Distribution (N9d): ``fp8_grouped_gemm`` on each 4-expert slice of 16
   against the E = 16 call's rows, bit for bit; then ``EP_WORLD`` ranks
   spawned after the kernels are built (gloo over a ``FileStore``, every
   rank on card 0, none running ``nvcc``), against the parent's world-1
   runs:
   (r) full-width 12-layer OneRec-V2 served expert-parallel on (1, 4) and
   (2, 2) meshes (each rank makes the params from seed 0 layer by layer,
   PTQ'd and cut to its experts): the ``prefill_b32`` step's logits and
   ``generate_items`` bit-identical to world 1 (per data shard on (2,
   2)), launch counts a forward, prefill ms, ``all_reduce`` bytes and ms,
   peak memory a rank;
   (s) ``compressed_psum`` of ~27 M f32 a rank over ``model`` and over
   ``data``, against the float64 sum of the ranks' ``ef_compress``
   outputs; residuals and a rerun bit for bit;
   (t) a 2-layer FP8 checkpoint restored onto (1, 4) under
   ``INFER_RULES`` and (2, 2) under ``TRAIN_RULES`` from ``meta``
   templates: local shards bit-equal to global slices, placements
   ``param_sharding``'s, K-major payloads, ``fp8_gemm`` on q_proj shards
   within 1 bf16 ulp of the full product's slice.
   Phase 2 also holds (u) ``fp8_gemm``'s given-scale mode (the row scales
   of whole rows, read, not reduced: the row-parallel products of tensor
   parallelism) on each of 4 K-slices of o_proj at the prefill and decode
   rows, f32 out: against its plain version and ``OFF_EXACT_MAX``, each
   slice's quantized payload the K-slice of one rank's bit for bit; timed
   beside the dynamic mode and ``torch._scaled_mm``.
9. Tensor parallelism (N9e.1): ``EP_WORLD`` ranks spawned as in phase 8,
   against the same world-1 runs (phase 8's, which also keep the first
   layer's output and the logits with the GEMMs' plain versions):
   (v) full-width 12-layer OneRec-V2 served tensor and expert parallel on
   (1, 4) and (2, 2): each rank makes the params from seed 0 (the
   prefill_b32 bundle's, PTQ'd layer by layer) and lays them out by the
   JAX rules (``steps.shard_args``); layer 0's q/k/v and o_proj products
   within ``TP_GAP_ULPS`` of world 1's, its output on the prefill's input
   within relative L2 ``TP_REL_L2``; the prefill step's logits and the
   serve_b32 step's (``use_attention_kernel`` off and on) and a decode
   step over the cache the prefill filled (off and on) within
   ``TP_LOGITS_REL_L2`` / ``TP_DECODE_REL_L2`` of world 1's (a change of
   f32 summation order alone, world 1's GEMM kernels against their plain
   versions, puts 3.5e-2 / 1.9e-2 between its own), top-8 overlap at
   least ``CPU_TOP8_OVERLAP``; reruns bit-identical; ``generate_items``
   with ``radix_topk``, its items equal to world 1's on at least
   ``TP_ITEMS_EQUAL`` of the rows; launch counts a prefill, a decode step
   and a generation; params and peak memory a rank, prefill and decode
   ms, each collective's bytes and ms.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
FP8_OPS_PER_S = 1979e12          # dense fp8 tensor-core peak
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
FP32_OPS_PER_S = 67e12           # float32 outside the tensor cores

# 1 bf16 ulp relative to the largest plain output: the fp8 payloads and
# scales are bit-identical, only f32 summation order (and, for attention,
# online vs dense softmax) differs, which flips a bf16 rounding now and then
TOL = 2.0 ** -7
# the GEMM kernels sum exact products in f32, as the Pallas kernels do: at
# most this share of their outputs may differ from the bf16 rounding of the
# same function summed in float64 (their plain versions: <= 0.0121%, but
# one output of 1024 at gemma3-1b's decode k/v shape)
OFF_EXACT_MAX = 1e-3
CPU_FIRST_TOKEN_AGREE = 0.9      # card vs CPU, share of requests
CPU_TOP8_OVERLAP = 0.85          # card vs CPU, teacher-forced mean overlap
DEADLINE_S = 10.0                # phase 4 (c)'s deadline, for its count


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


def time_graph_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in one CUDA graph
    and replayed, so no host work sits between the launches (what a decode
    step's kernels cost the card when the host runs ahead of it)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(n_bytes: float, n_ops: float, ops_per_s: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def time_turns(fns, iters: int, timer=time_graph_ms):
    """Mean ms of each named function, timed in turns within one call:
    the order given, then the reverse (kernel, library, library, kernel).
    ``timer`` is ``time_graph_ms`` (device time) or ``time_ms`` (eager
    calls back to back, host work included)."""
    order = list(fns) + list(reversed(fns))
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(timer(fns[name], iters))
    return {name: sum(t) / len(t) for name, t in times.items()}


def off_exact(name, shape, out, ref, exact):
    """Shares of the kernel's and the plain version's outputs that differ
    from the function computed with float64 sums and rounded once to bf16
    (through f32): where the f32 sums of the two part ways.  The kernel's
    share must be at most ``OFF_EXACT_MAX``."""
    import torch
    e = exact.float().to(torch.bfloat16)
    shares = [(t != e).float().mean().item() for t in (out, ref)]
    print(f"[kernel] {name} {shape}: outputs off the float64 result's bf16 "
          f"rounding: kernel {shares[0]:.4%}, plain {shares[1]:.4%} "
          f"(bound {OFF_EXACT_MAX:.2%})")
    if not shares[0] <= OFF_EXACT_MAX:
        fail(f"{name} {shape}: {shares[0]:.4%} of outputs off the float64 "
             f"result's bf16 rounding > {OFF_EXACT_MAX:.2%}")
    return dict(off_exact_kernel=shares[0], off_exact_plain=shares[1])


# (model, (M, K, N)): OneRec-V2's decode q/o, decode k/v and a 32-request
# prefill's q/o; the LM zoo's at phase 4 (h) (4 decode rows, 4 x 4096
# prefill rows): llama3-8b's gate and down, deepseek-moe-16b's dense gate
# (N = 10944, not a multiple of 128) and down (K = 10944), gemma3-1b's k/v
# (one KV head of 256)
GEMM_SHAPES = (
    ("onerec-v2", (32, 2048, 2048)), ("onerec-v2", (32, 2048, 512)),
    ("onerec-v2", (12320, 2048, 2048)),
    ("llama3-8b gate", (4, 4096, 14336)),
    ("llama3-8b gate", (16384, 4096, 14336)),
    ("llama3-8b down", (4, 14336, 4096)),
    ("llama3-8b down", (16384, 14336, 4096)),
    ("deepseek-moe-16b dense gate", (4, 2048, 10944)),
    ("deepseek-moe-16b dense gate", (16384, 2048, 10944)),
    ("deepseek-moe-16b dense down", (4, 10944, 2048)),
    ("deepseek-moe-16b dense down", (16384, 10944, 2048)),
    ("gemma3-1b k/v", (4, 1152, 256)), ("gemma3-1b k/v", (16384, 1152, 256)))
# (model, (E, C, K, N)): OneRec-V2's decode (C = 8 rows per expert) and
# 32-request prefill (C = 3080) gate/up and down, at 16 experts and at the
# 4 a rank of phase 8's (1, 4) mesh holds; the zoo's 64 experts
# (qwen2-moe's 60 padded by ep_degree 16, deepseek-moe's 64) at decode
# (C = 8) and at the 16384-token prefill (C = 1368 qwen2, 1920 deepseek)
GROUPED_SHAPES = (
    ("onerec-v2", (16, 8, 2048, 4096)), ("onerec-v2", (16, 8, 4096, 2048)),
    ("onerec-v2", (16, 3080, 2048, 4096)),
    ("onerec-v2", (16, 3080, 4096, 2048)),
    ("onerec-v2 EP rank of (1, 4)", (4, 8, 2048, 4096)),
    ("onerec-v2 EP rank of (1, 4)", (4, 8, 4096, 2048)),
    ("onerec-v2 EP rank of (1, 4)", (4, 3080, 2048, 4096)),
    ("onerec-v2 EP rank of (1, 4)", (4, 3080, 4096, 2048)),
    ("qwen2 / deepseek-moe", (64, 8, 2048, 1408)),
    ("qwen2 / deepseek-moe", (64, 8, 1408, 2048)),
    ("qwen2-moe-a2.7b", (64, 1368, 2048, 1408)),
    ("qwen2-moe-a2.7b", (64, 1368, 1408, 2048)),
    ("deepseek-moe-16b", (64, 1920, 2048, 1408)),
    ("deepseek-moe-16b", (64, 1920, 1408, 2048)))


def check_fp8_gemm(dev, records):
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_gemm import ops
    g = torch.Generator(device=dev).manual_seed(1)
    worst = 0.0
    shapes = []
    for model, (m, k, n) in GEMM_SHAPES:
        x = torch.randn(1, m, k, device=dev, generator=g).to(torch.bfloat16)
        # a pool of weights larger than L2, rotated so every launch streams
        # its weight from HBM as a decode step does; K-major, as PTQ lays
        # them out
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
        xq64 = quant.quantize_per_token(x)
        exact = (xq64.data.float().double() @ ws[0].data.float().double()
                 ) * xq64.scale.double() * sws[0].double()[:, None, :]
        shares = off_exact("fp8_gemm", f"M={m} K={k} N={n}", out, ref, exact)
        # static mode: one calibrated scale for every row (here the
        # tensor's amax / 448, as calibration over this input would give)
        s_act = (x.float().abs().max() / 448.0).reshape(1, 1)
        out_s = ops.fp8_gemm(x, ws[0].data, sws[0], act_scale=s_act)
        ref_s = ops.fp8_gemm_plain(x, ws[0].data, sws[0], act_scale=s_act)
        torch.cuda.synchronize()
        err_s = (out_s.float() - ref_s.float()).abs().max().item()
        tol_s = TOL * ref_s.float().abs().max().item()
        worst = max(worst, err_s)
        if not err_s <= tol_s:
            fail(f"fp8_gemm static {m}x{k}x{n}: max |diff| {err_s} > "
                 f"{tol_s}")
        xs64 = quant.cast_to_fp8(x, s_act.reshape(1, 1, 1))
        exact_s = (xs64.float().double() @ ws[0].data.float().double()
                   ) * s_act.double() * sws[0].double()[:, None, :]
        shares_s = off_exact("fp8_gemm static", f"M={m} K={k} N={n}", out_s,
                             ref_s, exact_s)
        del xs64, exact_s
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % n_w
            return it[0]

        # the two passes apart: the quantization pass, and the GEMM on the
        # xh, sx it made (its split-K counters start at zero)
        splits, cps, xh, sx, part, counters = ops.scratch(x, ws[0].data)
        counters.zero_()
        ops.quantize_pass(x, xh, sx)
        gout = torch.empty_like(out)
        ops.gemm_pass(xh, sx, ws[0].data, sws[0], gout, splits, cps, part,
                      counters)
        torch.cuda.synchronize()
        if not torch.equal(gout, out):
            fail(f"fp8_gemm {m}x{k}x{n}: the GEMM pass alone differs from "
                 f"the wrapper's call")
        del xq64, exact
        # library yardstick: rowwise-scaled cuBLASLt fp8 GEMM on operands
        # already quantized, and with the per-token quantization before it
        lq = quant.quantize_per_token(x[0])

        def kern():
            i = nxt()
            ops.fp8_gemm(x, ws[i].data, sws[i])

        def kern_static():
            i = nxt()
            ops.fp8_gemm(x, ws[i].data, sws[i], act_scale=s_act)

        def quant_pass():
            ops.quantize_pass(x, xh, sx)

        def quant_static():
            ops.quantize_pass(x, xh, sx, s_act)

        def gemm_alone():
            i = nxt()
            ops.gemm_pass(xh, sx, ws[i].data, sws[i], gout, splits, cps,
                          part, counters)

        def library():
            i = nxt()
            torch._scaled_mm(lq.data, ws[i].data[0], scale_a=lq.scale,
                             scale_b=sws[i], out_dtype=torch.bfloat16)

        def library_quant():
            i = nxt()
            q = quant.quantize_per_token(x[0])
            torch._scaled_mm(q.data, ws[i].data[0], scale_a=q.scale,
                             scale_b=sws[i], out_dtype=torch.bfloat16)

        def plain():
            i = nxt()
            ops.fp8_gemm_plain(x, ws[i].data, sws[i])

        iters = 5 if m > 1024 else 50
        t = time_turns(dict(kernel=kern, gemm=gemm_alone, quant=quant_pass,
                            static=kern_static, quant_static=quant_static,
                            library=library,
                            library_quant=library_quant), iters)
        eager = time_turns(dict(kernel=kern, library=library), iters,
                           timer=time_ms)
        plain_ms = time_ms(plain, iters)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                           2.0 * m * n * k, FP8_OPS_PER_S)
        path = "prefill" if splits == 0 else f"decode, {splits} splits"
        print(f"[kernel] fp8_gemm {model} M={m} K={k} N={n} ({path}): "
              f"max|diff|={err:.3g}, static {err_s:.3g} (tol {tol:.3g}) "
              f"kernel {t['kernel']:.4f} ms = quantization {t['quant']:.4f} "
              f"+ GEMM {t['gemm']:.4f} ms; static mode {t['static']:.4f} ms "
              f"(quantization {t['quant_static']:.4f} ms); plain "
              f"{plain_ms:.4f} ms; torch._scaled_mm "
              f"{t['library']:.4f} ms, quantize_per_token + _scaled_mm "
              f"{t['library_quant']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
              f"{2.0 * m * n * k / t['gemm'] / 1e9:.1f} TFLOP/s in the GEMM "
              f"(device times, CUDA graphs); eager calls back to back: "
              f"kernel {eager['kernel']:.4f} ms, torch._scaled_mm "
              f"{eager['library']:.4f} ms")
        shapes.append(dict(
            shape=f"M={m} K={k} N={n}", model=model, path=path,
            timer="cuda_graph",
            ms=t["kernel"],
            quant_ms=t["quant"], gemm_ms=t["gemm"], plain_ms=plain_ms,
            static_ms=t["static"], static_quant_ms=t["quant_static"],
            bound_ms=b_ms, bound_by=b_by, library_ms=t["library"],
            library_with_quant_ms=t["library_quant"],
            eager_ms=eager["kernel"], library_eager_ms=eager["library"],
            max_abs_err=err, max_abs_err_static=err_s, **shares,
            off_exact_static=shares_s["off_exact_kernel"]))
    records["fp8_gemm"] = dict(shapes[0], max_abs_err=worst, shapes=shapes)


def _library_scale_b(sw):
    """The weight's 128 x 128 scales in the layout ``scaled_mm`` takes for
    BlockWise128x128 (per expert (L4, N/128) with strides (1, L4), K/128
    padded to L4, a multiple of 4), laid out once as PTQ would."""
    import torch
    e, kb, nb = sw.shape
    l4 = -(-kb // 4) * 4
    sbt = torch.zeros(e, nb, l4, dtype=torch.float32, device=sw.device)
    sbt[:, :, :kb] = sw.transpose(1, 2)
    return sbt


def _grouped_library(xq, sx, wq, sbt):
    """The library calls that compute ``fp8_grouped_gemm``'s GEMM on
    operands quantized beforehand (xq (E, C, K) e4m3, sx (E, K/128, C) f32
    as the kernel's quantization pass lays them out, wq K-major, sbt from
    ``_library_scale_b``): ``scaled_grouped_mm`` over the experts (one call,
    ``offs``) and ``scaled_mm`` with BlockWise1x128 x BlockWise128x128
    scales, in a loop over the experts (not one call)."""
    import torch
    import torch.nn.functional as F
    e, c, k = xq.shape
    offs = torch.arange(1, e + 1, dtype=torch.int32, device=xq.device) * c

    def recipes():     # looked up at the call: a build may lack them
        return F.ScalingType.BlockWise1x128, F.ScalingType.BlockWise128x128

    return {
        "scaled_grouped_mm": lambda: F.scaled_grouped_mm(
            xq.reshape(e * c, k), wq,
            sx.transpose(1, 2).reshape(e * c, k // 128), recipes()[0],
            sbt.transpose(1, 2), recipes()[1], offs=offs,
            output_dtype=torch.bfloat16),
        "scaled_mm per-expert loop": lambda: [F.scaled_mm(
            xq[i], wq[i], sx[i].t(), recipes()[0], sbt[i].t(), recipes()[1],
            output_dtype=torch.bfloat16) for i in range(e)],
    }


def _refusals(calls):
    """Run each library call once: {name: None if it ran, else the error
    text of the build's refusal}."""
    import torch
    found = {}
    for name, fn in calls.items():
        try:                   # a library yardstick, not a path of the port
            fn()
            torch.cuda.synchronize()
            found[name] = None
        except Exception as exc:          # noqa: BLE001 -- recorded
            found[name] = (f"{type(exc).__name__}: "
                           f"{str(exc).strip().splitlines()[0][:300]}")
    return found


def check_fp8_grouped_gemm(dev, records):
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_grouped_gemm import ops
    g = torch.Generator(device=dev).manual_seed(2)
    worst = 0.0
    shapes = []
    # each weight is 128 MiB (OneRec) or 176 MiB (the zoo) of e4m3, beyond
    # the 50 MB L2, so every launch streams it
    for model, (e, c, k, n) in GROUPED_SHAPES:
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
        xq64 = quant.quantize_blockwise(x, act=True)
        xd = xq64.data.float().double().reshape(e, c, k // 128, 128)
        wd = w.data.float().double().reshape(e, k // 128, 128, n)
        swn = w.scale.double().repeat_interleave(128, dim=-1)
        exact = torch.zeros((e, c, n), dtype=torch.float64, device=dev)
        for kb in range(k // 128):
            exact += (xd[:, :, kb] @ wd[:, kb]) \
                * xq64.scale[:, :, kb, None].double() * swn[:, None, kb]
        shares = off_exact("fp8_grouped_gemm", f"E={e} C={c} K={k} N={n}",
                           out, ref, exact)
        del xd, wd, swn
        # the two passes apart: the 1 x 128 quantization, and the GEMM on
        # the xh, sx it made
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        p = ops.plan(e, c, n, sms)
        xh, sx = ops.scratch(x)
        ops.quantize_pass(x, xh, sx)
        gout = torch.empty_like(out)
        ops.gemm_pass(xh, sx, w.data, w.scale, gout, p)
        torch.cuda.synchronize()
        if not torch.equal(gout, out):
            fail(f"fp8_grouped_gemm {e}x{c}x{k}x{n}: the GEMM pass alone "
                 f"differs from the wrapper's call")
        # the library's operands: the same e4m3 values, and the scales laid
        # out (E, K/128, Cp) as the kernel's pass writes them
        x8 = xq64.data.contiguous()
        sx8 = torch.zeros(e, k // 128, -(-c // 4) * 4, device=dev)
        sx8[:, :, :c] = xq64.scale.transpose(1, 2)
        sx8 = sx8[:, :, :c]
        del xq64, exact
        sbt = _library_scale_b(w.scale)
        lib = _grouped_library(x8, sx8, w.data, sbt)
        refused = _refusals(lib)
        fns = dict(
            kernel=lambda: ops.fp8_grouped_gemm(x, w.data, w.scale),
            gemm=lambda: ops.gemm_pass(xh, sx, w.data, w.scale, gout, p),
            quant=lambda: ops.quantize_pass(x, xh, sx))
        fns.update({name: fn for name, fn in lib.items()
                    if refused[name] is None})
        iters = 3 if c > 1024 else 20
        t = time_turns(fns, iters)
        eager = time_turns(dict(kernel=fns["kernel"]), iters, timer=time_ms)
        plain_ms = time_ms(
            lambda: ops.fp8_grouped_gemm_plain(x, w.data, w.scale), iters)
        # the library with the 1 x 128 quantization (plain torch) before it
        lib_q = {}
        for name in lib:
            if refused[name] is None:

                def with_quant(name=name):
                    q = quant.quantize_blockwise(x, act=True)
                    _grouped_library(
                        q.data, q.scale.transpose(1, 2).contiguous(), w.data,
                        sbt)[name]()

                lib_q[name] = time_ms(with_quant, iters)
        b_ms, b_by = bound(e * c * k * 2 + e * k * n
                           + e * (k // 128) * (n // 128) * 4 + e * c * n * 2,
                           2.0 * e * c * n * k, FP8_OPS_PER_S)
        path = "prefill" if p.bc == 0 else f"decode, {p.bc}-row tiles"
        lib_txt = "; ".join(
            f"{name} {t[name]:.4f} ms (with quantize_blockwise "
            f"{lib_q[name]:.4f} ms eager)" if why is None
            else f"{name} refused: {why}" for name, why in refused.items())
        print(f"[kernel] fp8_grouped_gemm {model} E={e} C={c} K={k} N={n} "
              f"({path}):"
              f" max|diff|={err:.3g} (tol {tol:.3g}) kernel {t['kernel']:.4f}"
              f" ms = quantization {t['quant']:.4f} + GEMM {t['gemm']:.4f} "
              f"ms ({2.0 * e * c * n * k / t['gemm'] / 1e9:.1f} TFLOP/s, "
              f"{e * k * n / t['gemm'] / 1e9:.3f} TB/s of weight in the "
              f"GEMM; device times, CUDA graphs); eager {eager['kernel']:.4f}"
              f" ms; plain {plain_ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
              f"library: {lib_txt}")
        one_call = refused["scaled_grouped_mm"] is None
        shapes.append(dict(
            shape=f"E={e} C={c} K={k} N={n}", model=model, path=path,
            timer="cuda_graph",
            ms=t["kernel"], quant_ms=t["quant"], gemm_ms=t["gemm"],
            eager_ms=eager["kernel"], plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by,
            library_ms=t["scaled_grouped_mm"] if one_call else None,
            library={name: (dict(ms=t[name], with_quant_eager_ms=lib_q[name])
                            if why is None else dict(refused=why))
                     for name, why in refused.items()},
            max_abs_err=err, **shares))
    records["fp8_grouped_gemm"] = dict(shapes[0], max_abs_err=worst,
                                       shapes=shapes)
    grouped_threshold(dev, records)


def grouped_threshold(dev, records):
    """The decode path (swapped operands, the expert's rows as wgmma's N)
    against the prefill path (128 x 128 tiles) on the same GEMM, at C rows
    per expert around the path threshold (``ops.DECODE_MAX_C``): device
    time of the GEMM pass alone, the two paths in turns."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_grouped_gemm import ops
    g = torch.Generator(device=dev).manual_seed(6)
    e, k, n = 16, 2048, 4096
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = quant.quantize_blockwise(
        torch.randn(e, k, n, device=dev, generator=g) / math.sqrt(k))
    rows = []
    for c in (8, 16, 32, 48, 64, 128):
        x = torch.randn(e, c, k, device=dev, generator=g).to(torch.bfloat16)
        xq, sx = ops.scratch(x)
        ops.quantize_pass(x, xq, sx)
        out = torch.empty(e, c, n, dtype=torch.bfloat16, device=dev)
        bc = next((t for t in ops.DECODE_TILES_C if t >= c), 32)
        plans = dict(decode=ops.decode_plan(e, c, n, bc),
                     prefill=ops.prefill_plan(e, c, n, sms))
        t = time_turns({name: (lambda p=p: ops.gemm_pass(
            xq, sx, w.data, w.scale, out, p)) for name, p in plans.items()},
            20)
        rows.append(dict(C=c, decode_ms=t["decode"],
                         prefill_ms=t["prefill"],
                         chosen="prefill" if ops.plan(e, c, n, sms).bc == 0
                         else "decode"))
    print("[kernel] fp8_grouped_gemm path threshold, E=16 K=2048 N=4096, "
          "GEMM pass device ms (decode / prefill path; the plan's choice): "
          + "; ".join(f"C={r['C']} {r['decode_ms']:.4f} / "
                      f"{r['prefill_ms']:.4f} ({r['chosen']})" for r in rows))
    records["fp8_grouped_gemm"]["threshold"] = rows


def check_int8_product(dev, records):
    """The W8A8 product ``quant.int8_linear`` (per-token int8 activations,
    ``torch._int_mm``, the dequant epilogue) on the card against its CPU
    result, bit for bit, at a 2048-wide linear's decode and prefill rows;
    timed with the product alone.  It is no kernel of the port: the JAX
    package computes it with an XLA int32 dot, outside any Pallas kernel."""
    import dataclasses
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for m, k, n in ((32, 2048, 2048), (12320, 2048, 2048)):
        x = torch.randn(1, m, k, device=dev, generator=g).to(torch.bfloat16)
        w = quant.quantize_per_channel_int8(
            torch.randn(k, n, device=dev, generator=g) / math.sqrt(k))
        out = quant.int8_linear(x, w)
        ref = quant.int8_linear(x.cpu(), dataclasses.replace(
            w, data=w.data.cpu(), scale=w.scale.cpu()))
        if not torch.equal(out.cpu().view(torch.int16),
                           ref.view(torch.int16)):
            bad = (out.cpu() != ref).float().mean().item()
            fail(f"int8_linear M={m} K={k} N={n}: the card's result differs "
                 f"from the CPU's on {bad:.4%} of outputs")
        xq = quant.quantize_per_token_int8(x.reshape(m, k))
        t = time_turns(dict(
            linear=lambda: quant.int8_linear(x, w),
            product=lambda: quant.int8_matmul(xq.data, w.data)),
            5 if m > 1024 else 50)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                           2.0 * m * n * k, FP8_OPS_PER_S)
        print(f"[int8] int8_linear M={m} K={k} N={n}: card equals CPU bit for "
              f"bit; {t['linear']:.4f} ms, of which torch._int_mm "
              f"{t['product']:.4f} ms (device times, CUDA graphs); bound "
              f"{b_ms:.4f} ms ({b_by}, int8 peak)")
        rows.append(dict(shape=f"M={m} K={k} N={n}", ms=t["linear"],
                         int_mm_ms=t["product"], bound_ms=b_ms,
                         bound_by=b_by))
    records["int8_product"] = rows


# (name, M, K, N, f32 output): the raw (unquantized) products of the main
# paths, ROADMAP C6: OneRec-V2's lm_head at a decode step and a 32-request
# prefill and its router, llama3-8b's lm_head at the zoo's 4 decode rows,
# two-tower's user tower and DIN's attention MLP at serve_bulk's 262144 rows
RAW_SHAPES = (
    ("onerec-v2 lm_head", 32, 2048, 8256, True),
    ("onerec-v2 lm_head", 12320, 2048, 8256, True),
    ("onerec-v2 router", 12320, 2048, 16, True),
    ("llama3-8b lm_head", 4, 4096, 128256, True),
    ("two-tower user tower", 262144, 2304, 1024, False),
    ("din attn_mlp 0", 262144, 72, 80, False),
    ("din attn_mlp 1", 262144, 80, 40, False),
)
# the zoo prefill's plain attention, llama3-8b: one q chunk of 1024 against
# the prompt's 4096 keys, 4 prompts, 8 KV heads of 4 query heads, hd 128
RAW_ATTENTION = (4, 1024, 4096, 8, 4, 128)


def _raw_check(name, shape, fns, exact, b_ms, b_by, iters):
    """One raw product: ``fns`` holds ``new`` (the port's), ``old`` (the
    f32 product of the same bf16 values that it replaced) and ``one`` (one
    cuBLAS call over the whole K with an f32 result, which the port does
    not use).  The port's share off the float64 product's bf16 rounding is
    held to ``OFF_EXACT_MAX``; the three are timed in turns."""
    import torch
    bf = torch.bfloat16
    shares = off_exact(name, shape, fns["new"]().to(bf),
                       fns["old"]().to(bf), exact)
    e = exact.float().to(bf)
    shares["off_exact_one_call"] = (fns["one"]().to(bf) != e).float(
        ).mean().item()
    del e
    t = time_turns(fns, iters)
    print(f"[raw] {name} {shape}: {t['new']:.4f} ms on the tensor cores "
          f"against {t['old']:.4f} ms for the f32 product it replaces "
          f"({t['old'] / t['new']:.1f}x); one cuBLAS call over the whole K "
          f"{t['one']:.4f} ms with {shares['off_exact_one_call']:.4%} of "
          f"outputs off (device times, CUDA graphs, in turns); bound "
          f"{b_ms:.4f} ms ({b_by}, bf16 peak)")
    return dict(name=name, shape=shape, ms=t["new"], f32_ms=t["old"],
                one_call_ms=t["one"], bound_ms=b_ms, bound_by=b_by, **shares)


def check_raw_products(dev, records):
    """Phase 2, ROADMAP C6: the raw products of bf16 operands through
    ``quant.raw_matmul`` (cuBLAS on the tensor cores, each
    ``RAW_K_CHUNK``-deep chunk's product added into an f32 result) at
    ``RAW_SHAPES``, one raw expert
    product (``moe._grouped_matmul``, E = 16, a prefill's 3080 rows an
    expert) and the plain attention's scores and PV at ``RAW_ATTENTION``:
    each held to ``OFF_EXACT_MAX`` of outputs off the bf16 rounding of the
    float64-summed product, and timed against the f32 product of the same
    bf16 values that it replaces (the port's code before C6) and against
    one cuBLAS call over the whole K.  No kernel of the port: the JAX
    package's are XLA dots."""
    import torch
    from repro_torch.core import quant
    from repro_torch.layers import attention, moe
    g = torch.Generator(device=dev).manual_seed(11)
    bf, f32 = torch.bfloat16, torch.float32
    rows = []

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, device=dev, generator=g) * scale).to(bf)

    for name, m, k, n, f32_out in RAW_SHAPES:
        out_dtype = f32 if f32_out else bf
        x, w = randn(m, k), randn(k, n, scale=k ** -0.5)
        if quant.matmul_any(x, w, out_dtype=out_dtype).dtype != out_dtype:
            fail(f"raw {name}: output not {out_dtype}")
        b_ms, b_by = bound(2 * (m * k + k * n) + m * n * (4 if f32_out
                                                           else 2),
                           2.0 * m * k * n, BF16_OPS_PER_S)
        rows.append(_raw_check(
            f"raw {name}", f"M={m} K={k} N={n}", dict(
                new=lambda: quant.matmul_any(x, w, out_dtype=out_dtype),
                old=lambda: torch.matmul(x.float(), w.float()).to(
                    out_dtype),
                one=lambda: torch.mm(x, w, out_dtype=f32)),
            x.double() @ w.double(), b_ms, b_by, 3 if m * n > 1e8 else 20))
        del x, w
    e, c, k, n = 16, 3080, 2048, 4096
    x, w = randn(e, c, k), randn(e, k, n, scale=k ** -0.5)
    b_ms, b_by = bound(2 * (e * c * k + e * k * n + e * c * n),
                       2.0 * e * c * k * n, BF16_OPS_PER_S)
    rows.append(_raw_check(
        "raw expert", f"E={e} C={c} K={k} N={n}", dict(
            new=lambda: moe._grouped_matmul(x, w),
            old=lambda: torch.matmul(x.float(), w.float()).to(bf),
            one=lambda: torch.bmm(x, w, out_dtype=f32)),
        torch.bmm(x.double(), w.double()), b_ms, b_by, 3))
    del x, w
    b, tq, s, kv, grp, hd = RAW_ATTENTION
    q, kk, v = randn(b, tq, kv, grp, hd), randn(b, s, kv, hd), \
        randn(b, s, kv, hd)
    scale = hd ** -0.5
    shape = f"B={b} T={tq} S={s} Kv={kv} G={grp} hd={hd}"
    n_ops = 2.0 * b * kv * grp * tq * s * hd
    n_scores = b * kv * grp * tq * s
    b_ms, b_by = bound(2 * (q.numel() + kk.numel()) + 4 * n_scores, n_ops,
                       BF16_OPS_PER_S)
    qm = q.permute(0, 2, 3, 1, 4).reshape(b * kv, grp * tq, hd)
    km = kk.permute(0, 2, 3, 1).reshape(b * kv, hd, s)
    rows.append(_raw_check(
        "raw attention scores", shape, dict(
            new=lambda: attention._gqa_scores(q, kk, scale),
            old=lambda: torch.einsum("btkgh,bskh->bkgts", q.float(),
                                     kk.float()) * scale,
            one=lambda: (torch.bmm(qm, km, out_dtype=f32) * scale).view(
                b, kv, grp, tq, s)),
        torch.einsum("btkgh,bskh->bkgts", q.double(), kk.double()) * scale,
        b_ms, b_by, 3))
    probs = torch.softmax(attention._gqa_scores(q, kk, scale), dim=-1).to(bf)
    pm = probs.reshape(b * kv, grp * tq, s)
    vm = v.permute(0, 2, 1, 3).reshape(b * kv, s, hd)
    b_ms, b_by = bound(2 * (probs.numel() + v.numel() + q.numel()), n_ops,
                       BF16_OPS_PER_S)
    rows.append(_raw_check(
        "raw attention PV", shape, dict(
            new=lambda: attention._gqa_combine(probs, v),
            old=lambda: torch.einsum("bkgts,bskh->btkgh", probs.float(),
                                     v.float()).to(bf),
            one=lambda: torch.bmm(pm, vm, out_dtype=f32).view(
                b, kv, grp, tq, hd).permute(0, 3, 1, 2, 4)),
        torch.einsum("bkgts,bskh->btkgh", probs.double(), v.double()),
        b_ms, b_by, 3))
    records["raw_products"] = rows


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
            ms = time_graph_ms(lambda: ops.paged_decode(*args, **kw), 50)
            eager_ms = time_ms(lambda: ops.paged_decode(*args, **kw), 50)
            plain_ms = time_ms(lambda: ops.paged_decode_plain(*args, **kw),
                               20)
            keys = sum(ln + 1 for ln in lengths)       # valid keys read
            n_bytes = (keys * (kv * (2 * hd + 2 * 4) + 4)  # k, v, scales, pos
                       + b * n_p * 4 + 2 * b * 4          # tables, lengths
                       + 2 * b * kv * g_heads * hd * 2)   # q in, out
            n_ops = 4.0 * keys * kv * g_heads * hd       # QK^T and PV
            b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
            print(f"[kernel] paged_decode B={b} Kv={kv} G={g_heads} hd={hd}"
                  f" ps={ps} P={n_p} fp8 KV: kernel {ms:.4f} ms (device "
                  f"time, CUDA graph), eager {eager_ms:.4f} ms; plain "
                  f"{plain_ms:.4f} ms; library none; bound {b_ms:.5f} ms "
                  f"({b_by}, {keys} keys)")
            records["paged_decode"] = dict(
                shape=f"B={b} Kv={kv} G={g_heads} hd={hd} ps={ps} P={n_p}",
                timer="cuda_graph", ms=ms, eager_ms=eager_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
    records["paged_decode"]["max_abs_err"] = worst
    check_paged_decode_tree(dev, records, gen)


def _tree_pool(dev, starts, counts, *, n_br, stride, depth, quantized, ps,
               kv, hd, n_p, seed):
    """One layer of a paged pool as a tree step leaves it: slot i holds its
    shared prefix (logical 0 .. starts[i] - 1), then its first counts[i]
    branch spans hold depth + 1 tokens each (branch b's token t at logical
    starts[i] + b * stride + t, pos starts[i] + t), the spans of dummy
    branches b >= counts[i] empty; on shuffled pages, unmapped entries at
    the sentinel page.  A slot with start 0 is empty (length 0)."""
    import torch
    from repro_torch.core import quant
    g = torch.Generator(device="cpu").manual_seed(seed)
    b = len(starts)
    end = [0 if st == 0 else st + n_br * stride for st in starts]
    need = [-(-e // ps) for e in end]
    n_pages = sum(need) + 3
    n_pos = (n_pages + 1) * ps
    perm = torch.randperm(n_pages, generator=g).tolist()
    tables = torch.full((b, n_p), n_pages, dtype=torch.int32)
    pos = torch.full((n_pos,), -1, dtype=torch.int32)
    nxt = 0
    for i, st in enumerate(starts):
        phys = []
        for e in range(need[i]):
            tables[i, e] = perm[nxt]
            phys += [perm[nxt] * ps + o for o in range(ps)]
            nxt += 1
        for lg in range(st):
            pos[phys[lg]] = lg
        for br in range(counts[i] if st else 0):
            for t in range(depth + 1):
                pos[phys[st + br * stride + t]] = st + t
    k = torch.randn(n_pos, kv, hd, generator=g)
    v = torch.randn(n_pos, kv, hd, generator=g)
    cache = {"pos": pos}
    if quantized:
        cache["k"], cache["k_scale"] = quant.quantize_kv(k)
        cache["v"], cache["v_scale"] = quant.quantize_kv(v)
    else:
        cache["k"], cache["v"] = k.to(torch.bfloat16), v.to(torch.bfloat16)
    lengths = [0 if st == 0 else st + depth for st in starts]
    cache = {n: t.to(dev) for n, t in cache.items()}
    return (cache, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev),
            torch.tensor(starts, dtype=torch.int32, device=dev))


def check_paged_decode_tree(dev, records, gen):
    """Tree mode (``starts`` and the engine's branch stride, decode_len -
    1 = 2): C = 4, 8 and 16 branches of G = 4 (C*G = 16, 32 and 64 query
    rows a KV head: one, two and four row tiles), fp8 and bf16 pools, at
    the serving shape (32 slots, prefixes of 7..380 positions) and on
    adversarial tables (empty slots, starts on and beside page
    boundaries, the last span crossing a page); dummy branches (counts
    below C, their spans never written) in the C = 8 serving case and
    throughout the adversarial ones.  Each held to ``TOL`` against the
    plain version; fp8 serving cases timed, with their bound."""
    import torch
    from repro_torch.kernels.paged_decode import ops
    kv, g_heads, hd, ps, b, stride, depth = 4, 4, 128, 32, 32, 2, 1
    serving = [int(x) for x in torch.randint(7, 380, (b,), generator=gen)]
    adversarial = [0, 1, 31, 32, 33, 63, 64, 0, 95, 96, 349, 0, 5, 127,
                   128, 129] * 2
    rows, worst = [], records["paged_decode"]["max_abs_err"]
    for n_br in (4, 8, 16):
        n_p = -(-(388 + n_br * stride) // ps)
        for quantized in (True, False):
            kind = "fp8" if quantized else "bf16"
            for name, starts in (("serving", serving),
                                 ("adversarial", adversarial)):
                if name == "serving":
                    counts = [n_br if n_br != 8 else (8, 4, 3, 1)[i % 4]
                              for i in range(b)]
                else:
                    counts = [1 + (i * 5) % n_br for i in range(b)]
                cache, tables, lens, st = _tree_pool(
                    dev, starts, counts, n_br=n_br, stride=stride,
                    depth=depth, quantized=quantized, ps=ps, kv=kv, hd=hd,
                    n_p=n_p, seed=n_br + quantized + len(name))
                q = torch.randn(b, kv, n_br * g_heads, hd, generator=gen
                                ).to(torch.bfloat16).to(dev)
                args = [q, cache["k"], cache["v"], cache["pos"],
                        cache.get("k_scale"), cache.get("v_scale"), tables,
                        lens, st]
                kw = dict(page_size=ps, group=g_heads, branch_stride=stride,
                          scale=1.0 / math.sqrt(hd))
                out = ops.paged_decode(*args, **kw)
                ref = ops.paged_decode(*[a.cpu() if a is not None else None
                                         for a in args], **kw)
                err = (out.float().cpu() - ref.float()).abs().max().item()
                tol = TOL * ref.float().abs().max().item()
                worst = max(worst, err)
                empty = [i for i, x in enumerate(starts) if x == 0]
                cg = n_br * g_heads
                if not err <= tol or bool(out[empty].any()):
                    fail(f"paged_decode tree CG={cg} {name} {kind} KV: max "
                         f"|diff| {err} > {tol}, or an empty slot is not 0")
                print(f"[kernel] paged_decode tree CG={cg} {name} {kind} KV"
                      f" B={b} stride={stride} (counts {min(counts)}.."
                      f"{max(counts)}): max|diff|={err:.3g} (tol "
                      f"{tol:.3g})")
                if name != "serving" or not quantized:
                    continue
                ms = time_graph_ms(lambda: ops.paged_decode(*args, **kw),
                                   50)
                plain_ms = time_ms(
                    lambda: ops.paged_decode_plain(*args, **kw), 10)
                # keys a block reads: each slot's prefix and its written
                # span tokens, once for all its rows; each row's product
                # covers the prefix and its own span's tokens
                stored = sum(x + c * (depth + 1)
                             for x, c in zip(starts, counts))
                seen = sum(n_br * x + c * (depth + 1)
                           for x, c in zip(starts, counts))
                n_bytes = (stored * kv * (2 * hd + 2 * 4) + stored * 4
                           + b * n_p * 4 + 2 * b * 4
                           + 2 * b * kv * cg * hd * 2)
                n_ops = 4.0 * seen * kv * g_heads * hd
                b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
                print(f"[kernel] paged_decode tree CG={cg} B={b} Kv={kv} "
                      f"hd={hd} ps={ps} P={n_p} fp8 KV: kernel {ms:.4f} ms "
                      f"(device time, CUDA graph); plain {plain_ms:.4f} ms; "
                      f"bound {b_ms:.5f} ms ({b_by}, {stored} stored keys)")
                rows.append(dict(
                    cg=cg, counts=f"{min(counts)}..{max(counts)}", ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
    records["paged_decode"].update(
        max_abs_err=worst, tree_ms={f"CG={r['cg']}": r["ms"] for r in rows},
        tree_rows=rows)


def _topk_rows(b, v, seed):
    """Logits with edge rows: a row of small integers (ties), a row of
    -0.0 and negatives with a few +0.0 (the k-th key among the -0.0 ties,
    which rank below +0.0), and a row of equal values (the kernel's
    candidate list overflows)."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, v, generator=g) * 4
    if b >= 3:
        x[0] = torch.randint(-3, 4, (v,), generator=g).float()
        x[1] = -torch.randint(0, 3, (v,), generator=g).float()
        x[1, ::1500] = 0.0
        x[2] = 1.5
    return x


def check_radix_topk(dev, records):
    import torch
    from repro_torch.kernels.radix_topk import ops
    b, v, k = 32, 8256, 8                   # the engine's select
    g = torch.Generator(device="cpu").manual_seed(4)
    logits = torch.randn(b, v, generator=g) * 4
    ties = torch.randint(-3, 4, (b, v), generator=g).float()
    # even rows: -0.0 and negatives with six +0.0 columns, so the k-th key
    # falls among the -0.0 ties (keys rank -0.0 below +0.0)
    ties[::2] = -torch.randint(0, 4, (b // 2, v), generator=g).float()
    ties[::2, ::1500] = 0.0
    # a row starting off a 16-byte boundary: scalar loads
    flat = _topk_rows(4, v, 8).flatten()
    unaligned = torch.cat([flat[:1], flat]).to(dev)[1:].view(4, v)
    cases = [("logits", logits, k), ("ties/+-0.0", ties, k),
             ("ties/+-0.0 k=64", ties, 64),
             ("logits bf16", logits.to(torch.bfloat16), k),
             ("edge rows k=1024 (MAX_K)", _topk_rows(4, v, 1), 1024),
             ("edge rows k=V=257", _topk_rows(3, 257, 2), 257),
             ("equal values (list overflow)", torch.full((4, v), -2.5), k),
             ("edge rows f32 V=257 (scalar loads)", _topk_rows(3, 257, 3), 4),
             ("edge rows bf16 V=4001 (scalar loads)",
              _topk_rows(5, 4001, 4).to(torch.bfloat16), 16),
             ("edge rows V=2049 (2047 pad columns)", _topk_rows(4, 2049, 5),
              8),
             ("edge rows V=20000 (two tiles)", _topk_rows(3, 20000, 6), 8),
             ("edge rows V=65536 (four tiles)", _topk_rows(3, 65536, 7), 32),
             ("edge rows, unaligned start", unaligned, k),
             ("logits, one row", logits[:1], k),
             ("edge rows, 128 rows", _topk_rows(128, v, 9), k),
             # a W = 8 beam step's select: each row the beams' W x V
             # candidate scores (tiles re-read from L2)
             ("beam rows W*V=66048", _topk_rows(32, 8 * v, 10), k)]
    for name, x, kk in cases:
        x = x.to(dev)
        vals, idx = ops.radix_topk(x, kk)
        ref_v, ref_i = ops.radix_topk_plain(x, kk)
        torch.cuda.synchronize()
        if not (torch.equal(idx, ref_i) and torch.equal(
                vals.view(torch.int32), ref_v.view(torch.int32))):
            bad = (idx != ref_i).any(1).nonzero().flatten().tolist()
            fail(f"radix_topk {name}: kernel and plain differ in rows {bad}")
        p = ops.plan(*x.shape, x.dtype, x.data_ptr() % 16 == 0)
        print(f"[kernel] radix_topk {name} B={x.shape[0]} V={x.shape[1]} "
              f"k={kk} {str(x.dtype)[6:]} plan {tuple(p)}: identical "
              f"values and indices")
    x = logits.to(dev)
    p = ops.plan(b, v, x.dtype, True)
    fns = dict(kernel=lambda: ops.radix_topk(x, k),
               library=lambda: torch.topk(x, k))
    t = time_turns(fns, 50)
    eager = time_turns(fns, 200, timer=time_ms)
    plain_ms = time_ms(lambda: ops.radix_topk_plain(x, k), 20)
    floor_ms = time_graph_ms(lambda: ops.empty_launch(x, p), 50)
    # other selects at the engine's width: larger k, bf16, and a block of
    # rows one of which holds equal values (the list overflows)
    xb = x.to(torch.bfloat16)
    xe = x.clone()
    xe[1] = 1.5
    xw = _topk_rows(32, 8 * v, 10).to(dev)
    cases = {"k=64": lambda: ops.radix_topk(x, 64),
             "k=1024": lambda: ops.radix_topk(x, 1024),
             "bf16": lambda: ops.radix_topk(xb, k),
             "one row of equal values": lambda: ops.radix_topk(xe, k),
             "beam B=32 V=66048": lambda: ops.radix_topk(xw, k)}
    cases_ms = {n: time_graph_ms(fn, 50) for n, fn in cases.items()}
    b_ms, b_by = bound(b * v * 4 + b * k * 8, float(b * v), FP32_OPS_PER_S)
    print(f"[kernel] radix_topk B={b} V={v} k={k} f32 plan {tuple(p)}: "
          f"kernel {t['kernel']:.4f} ms, torch.topk {t['library']:.4f} ms "
          f"(device times, CUDA graphs), empty kernel of the same shape "
          f"{floor_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); eager calls "
          f"back to back: kernel {eager['kernel']:.4f} ms, torch.topk "
          f"{eager['library']:.4f} ms; plain {plain_ms:.4f} ms; "
          + ", ".join(f"{n} {ms:.4f}" for n, ms in cases_ms.items())
          + " ms")
    # the W = 8 beam step's select: kernel, torch.topk and plain at its
    # shape, and its bound
    wv = xw.shape[1]
    tw = time_turns(dict(kernel=lambda: ops.radix_topk(xw, k),
                         library=lambda: torch.topk(xw, k)), 50)
    w_plain = time_ms(lambda: ops.radix_topk_plain(xw, k), 5)
    w_bound, w_by = bound(b * wv * 4 + b * k * 8, float(b * wv),
                          FP32_OPS_PER_S)
    print(f"[kernel] radix_topk beam select B={b} V={wv} k={k} f32 plan "
          f"{tuple(ops.plan(b, wv, xw.dtype, True))}: kernel "
          f"{tw['kernel']:.4f} ms, torch.topk {tw['library']:.4f} ms (device "
          f"times, CUDA graphs), plain {w_plain:.4f} ms, bound "
          f"{w_bound:.5f} ms ({w_by})")
    records["radix_topk"] = dict(
        beam=dict(shape=f"B={b} V={wv} k={k} f32", ms=tw["kernel"],
                  library_ms=tw["library"], plain_ms=w_plain,
                  bound_ms=w_bound, bound_by=w_by),
        shape=f"B={b} V={v} k={k} f32", timer="cuda_graph", ms=t["kernel"],
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=t["library"], eager_ms=eager["kernel"],
        library_eager_ms=eager["library"], floor_ms=floor_ms,
        cases_ms=cases_ms, max_abs_err=0.0)


def _attn_inputs(dev, b, t, h, kv, hd, s, lengths, seed):
    """bf16 q/k/v and positions of a contiguous cache whose row i holds
    positions 0 .. lengths[i] - 1 (the rest empty, -1); the queries sit at
    the last t positions of each row."""
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(b, t, h, hd, generator=g).to(torch.bfloat16)
    k = torch.randn(b, s, kv, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(b, s, kv, hd, generator=g).to(torch.bfloat16)
    ln = torch.tensor(lengths)
    k_pos = torch.arange(s)[None].expand(b, s)
    k_pos = torch.where(k_pos < ln[:, None], k_pos, -1).to(torch.int32)
    q_pos = (ln[:, None] - t + torch.arange(t)[None]).clamp_min(-1)
    return [x.contiguous().to(dev) for x in (q, k, v, q_pos.to(torch.int32),
                                             k_pos)]


def check_batch_attention(dev, records):
    import torch
    import torch.nn.functional as F
    from repro_torch.core import quant
    from repro_torch.kernels.batch_attention import ops
    from repro_torch.layers.attention import _read_kv
    h, kv, hd, s = 16, 4, 128, 388          # full width, S = context_len + 1
    gen = torch.Generator(device="cpu").manual_seed(5)
    serving = [int(x) for x in torch.randint(7, s, (32,), generator=gen)]
    cases = [("decode", 32, 1, serving, 0),
             ("prefill T=64", 4, 64, [64, 200, 388, 70], 0),
             ("decode window=64", 32, 1, serving, 64)]
    worst = 0.0
    for name, b, t_len, lengths, window in cases:
        args = _attn_inputs(dev, b, t_len, h, kv, hd, s, lengths,
                            seed=t_len + window)
        kw = dict(scale=1.0 / math.sqrt(hd), window=window)
        out = ops.batch_attention(*args, **kw)
        ref = ops.batch_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL * ref.float().abs().max().item()
        worst = max(worst, err)
        if not err <= tol:
            fail(f"batch_attention {name}: max |diff| {err} > {tol}")
        print(f"[kernel] batch_attention {name} B={b} T={t_len} H={h} "
              f"Kv={kv} hd={hd} S={s}: max|diff|={err:.3g} (tol {tol:.3g})")
        if name != "decode":
            continue
        q, k, v, q_pos, k_pos = args
        # library yardstick on inputs laid out for it beforehand: SDPA with
        # a boolean mask and grouped KV heads
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        mask = ((k_pos[:, None, :] >= 0)
                & (k_pos[:, None, :] <= q_pos[:, :, None]))[:, None]
        fns = dict(
            kernel=lambda: ops.batch_attention(*args, **kw),
            library=lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True))
        t = time_turns(fns, 50)
        eager = time_turns(fns, 100, timer=time_ms)
        ms, lib_ms = t["kernel"], t["library"]
        plain_ms = time_ms(lambda: ops.batch_attention_plain(*args, **kw),
                           20)
        n_keys = int(mask.sum().item())          # valid (row, key) pairs
        n_bytes = (n_keys * kv * hd * 2 * 2      # the valid keys' K and V
                   + k_pos.numel() * 4 + q_pos.numel() * 4
                   + 2 * q.numel() * 2)          # q in, out
        n_ops = 4.0 * n_keys * h * hd            # QK^T and PV per head
        b_ms, b_by = bound(n_bytes, n_ops, BF16_OPS_PER_S)
        print(f"[kernel] batch_attention B={b} T={t_len} H={h} Kv={kv} "
              f"hd={hd} S={s}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"scaled_dot_product_attention {lib_ms:.4f} ms (device "
              f"times, CUDA graphs), bound {b_ms:.5f} ms ({b_by}, {n_keys} "
              f"valid keys); eager calls back to back: kernel "
              f"{eager['kernel']:.4f} ms, SDPA {eager['library']:.4f} ms")
        records["batch_attention"] = dict(
            shape=f"B={b} T={t_len} H={h} Kv={kv} hd={hd} S={s}",
            timer="cuda_graph", ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms, eager_ms=eager["kernel"],
            library_eager_ms=eager["library"])
        # what runs before the kernel on the contiguous decode path: the
        # plain fp8 -> bf16 dequantization of the whole row pool, one layer
        k8, ksc = quant.quantize_kv(k.float())
        v8, vsc = quant.quantize_kv(v.float())
        deq_ms = time_graph_ms(
            lambda: _read_kv(k8, v8, ksc, vsc, torch.bfloat16), 50)
        deq_bytes = 2 * (k8.numel() + ksc.numel() * 4 + k8.numel() * 2)
        print(f"[kernel] contiguous decode dequantization (_read_kv, fp8 -> "
              f"bf16 K and V) B={b} S={s} Kv={kv} hd={hd}: {deq_ms:.4f} ms, "
              f"bound {deq_bytes / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes); "
              f"batch_attention {ms:.4f} ms")
        records["batch_attention"]["dequant_ms"] = deq_ms
    records["batch_attention"]["max_abs_err"] = worst


# (name, B, H, Kv, hd, S, window): the shared-index decode of phase 4 (h) at
# its last step (position 4111 of a 4112-position cache), B = 4
ZOO_ATTENTION = (
    ("gemma3-1b local (wrapped 512-slot ring)", 4, 4, 1, 256, 512, 512),
    ("gemma3-1b global", 4, 4, 1, 256, 4112, 0),
    ("llama3-8b", 4, 32, 8, 128, 4112, 0),
    ("qwen2-moe / deepseek-moe (G = 1)", 4, 16, 16, 128, 4112, 0),
    ("deepseek-coder-33b (G = 7)", 4, 56, 8, 128, 4112, 0))
ZOO_LAST = 4111                  # the query's position


def check_batch_attention_zoo(dev, records):
    """``batch_attention`` at the zoo's decode shapes: one query a row at
    ``ZOO_LAST`` over a shared cache whose slot s holds the newest position
    p with p % S == s (the 512-slot ring has wrapped eight times), against
    the plain version (the JAX wrapper's blocks: 257 of 16 keys at S =
    4112) to ``TOL``; device and eager times beside SDPA (boolean mask with
    the window, grouped KV heads) and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.batch_attention import ops
    rows = []
    for name, b, h, kv, hd, s, window in ZOO_ATTENTION:
        g = torch.Generator(device="cpu").manual_seed(s + h)
        q, k, v = (torch.randn(shape, generator=g).to(torch.bfloat16).to(dev)
                   for shape in ((b, 1, h, hd), (b, s, kv, hd),
                                 (b, s, kv, hd)))
        slot = torch.arange(s)
        pos = ZOO_LAST - (ZOO_LAST - slot) % s
        k_pos = pos.to(torch.int32)[None].expand(b, s).contiguous().to(dev)
        q_pos = torch.full((b, 1), ZOO_LAST, dtype=torch.int32, device=dev)
        kw = dict(scale=1.0 / math.sqrt(hd), window=window)
        args = (q, k, v, q_pos, k_pos)
        out = ops.batch_attention(*args, **kw)
        ref = ops.batch_attention_plain(*args, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL * ref.float().abs().max().item()
        if not err <= tol:
            fail(f"batch_attention {name}: max |diff| {err} > {tol}")
        qs, ks, vs = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        valid = (k_pos >= 0) & (k_pos <= ZOO_LAST)
        if window:
            valid &= ZOO_LAST - k_pos < window
        mask = valid[:, None, None, :]
        fns = dict(
            kernel=lambda: ops.batch_attention(*args, **kw),
            library=lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, scale=kw["scale"],
                enable_gqa=True))
        t = time_turns(fns, 50)
        eager = time_turns(fns, 50, timer=time_ms)
        plain_ms = time_ms(lambda: ops.batch_attention_plain(*args, **kw), 5)
        n_keys = int(valid.sum().item())          # valid (row, key) pairs
        n_bytes = (n_keys * kv * hd * 2 * 2 + k_pos.numel() * 4
                   + q_pos.numel() * 4 + 2 * q.numel() * 2)
        b_ms, b_by = bound(n_bytes, 4.0 * n_keys * h * hd, BF16_OPS_PER_S)
        print(f"[kernel] batch_attention zoo {name} B={b} H={h} Kv={kv} "
              f"hd={hd} S={s} window={window}: max|diff|={err:.3g} (tol "
              f"{tol:.3g}); kernel {t['kernel']:.4f} ms, SDPA "
              f"{t['library']:.4f} ms (device times, CUDA graphs), eager "
              f"{eager['kernel']:.4f} / {eager['library']:.4f} ms; plain "
              f"{plain_ms:.4f} ms; bound {b_ms:.5f} ms ({b_by}, {n_keys} "
              f"valid keys)")
        rows.append(dict(shape=f"{name}: B={b} T=1 H={h} Kv={kv} hd={hd} "
                               f"S={s} window={window}",
                         ms=t["kernel"], eager_ms=eager["kernel"],
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=t["library"],
                         library_eager_ms=eager["library"], max_abs_err=err))
    records["batch_attention"]["zoo"] = rows
    records["batch_attention"]["max_abs_err"] = max(
        records["batch_attention"]["max_abs_err"],
        max(r["max_abs_err"] for r in rows))


# ---------------------------------------------------------------------------
# Phase 3: card against CPU on a small 128-aligned config
# ---------------------------------------------------------------------------


def visits(cfg, n_first: int, seed: int):
    """``n_first`` ragged first visits at priority 1, and a return visit of
    each at priority 0: the same profile, the history plus one more item
    (``n_codebooks`` tokens), capped at ``history_len`` items."""
    import numpy as np
    from repro_torch.serving.requests import build_requests
    first = [dict(r, priority=1)
             for r in build_requests(cfg, n_first, n_first, seed, True)]
    rng = np.random.default_rng(seed + 1)
    cap = cfg.history_len * cfg.n_codebooks
    back = [dict(r, priority=0, tokens=np.concatenate(
        [r["tokens"], rng.integers(0, cfg.vocab_size - 64,
                                   size=cfg.n_codebooks)])[:cap].astype(
            np.int32)) for r in first]
    return first, back


def serve_visits(engine, first, back):
    """The first visits through ``submit``, stepped until every one is
    admitted; then the return visits, submitted while first visits hold
    the slots, and a drain.  The schedule follows from the construction,
    not the clock.  Returns (items in submission order, stats, slots the
    first visits held when the return visits came)."""
    engine.reset_window()
    handles = [engine.submit(r, base_s=engine._window_t0) for r in first]
    while engine._sched.queue_depth:
        engine.step()
    held = engine.pool.n_used
    handles += [engine.submit(r) for r in back]
    engine.drain()
    return [h.completion.item for h in handles], engine.stats(), held


POLICY = dict(prefix_cache=True, preemption=True)
PHASE3_CHUNK = 16                # phase 3's prefill chunk, policy cases
TREE_WIDTHS = (1, 3, 4, 8)       # phase 3 ``paged-tree``'s n_candidates


def _record_seeds(engine):
    """{request id: (top-2 ids, top-2 logits)} of the logits each request's
    first token is drawn from, as the continuous scheduler seeds it (a
    preempted request's last seeding); empty for the fixed scheduler,
    which seeds no slot."""
    seeds = {}
    sched = engine._sched
    seed_slot = getattr(sched, "_seed_slot", None)
    if seed_slot is None:
        return seeds

    def record(slot, r, ids_row, vals_row, lse, done, freed):
        seeds[sched.pool[slot].request_id] = (
            [int(x) for x in ids_row[:2]], [float(x) for x in vals_row[:2]])
        seed_slot(slot, r, ids_row, vals_row, lse, done, freed)

    sched._seed_slot = record
    return seeds


POLICY_COUNTERS = ("resume_calls", "prefix_hits", "cow_copies",
                   "preemptions")


@contextlib.contextmanager
def plain_gemms():
    """Within: the two GEMM wrappers compute their plain versions on the
    card too (phase 3's diagnosis: what the card gives when only the
    GEMM kernels' sums are taken out).  Their counts stay untouched."""
    import torch
    from repro_torch.kernels.fp8_gemm import ops as gemm_ops
    from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
    kept = gemm_ops.fp8_gemm, grouped_ops.fp8_grouped_gemm

    def gemm(x, wq, sw, *, out_dtype=torch.bfloat16, act_scale=None,
             row_scale=None):
        return gemm_ops.fp8_gemm_plain(x, wq, sw, out_dtype, act_scale,
                                       row_scale)

    def grouped(x, wq, sw, *, out_dtype=torch.bfloat16):
        return grouped_ops.fp8_grouped_gemm_plain(x, wq, sw, out_dtype)

    gemm_ops.fp8_gemm, grouped_ops.fp8_grouped_gemm = gemm, grouped
    try:
        yield
    finally:
        gemm_ops.fp8_gemm, grouped_ops.fp8_grouped_gemm = kept


def ptq_policy():
    """The policy of ``paged-ptq`` and phase 4 (d): the paper's, with static
    activation scales and the k projections in int8."""
    from repro_torch.core.policy import PAPER_POLICY
    return PAPER_POLICY.replace(static_acts=True).override(
        "*/attn/k_proj/kernel", "int8")


_ARTIFACTS = {}     # case -> path of its artifact, written once a process


def write_artifact(name, cfg, params, batches):
    """A policy artifact of ``ptq_policy()`` whose static scales are
    calibrated (``calibrate_static_act_scales``) by the port's forward over
    ``batches``, on the params' device, written to ``build/`` in the
    checkout.  Returns its path."""
    from repro_torch.core import ptq
    from repro_torch.core.policy import save_policy_artifact
    from repro_torch.models.onerec import forward
    pol = ptq_policy()
    qparams = ptq.quantize_params(params, pol)
    scales = ptq.calibrate_static_act_scales(
        lambda q, b: forward(q, b, cfg), qparams, batches)
    del qparams
    if not scales:
        fail(f"{name}: calibration recorded no activation scale")
    path = os.path.join(ROOT, "build", "policy", f"{name}.json")
    save_policy_artifact(path, pol, config=cfg.name, act_scales=scales)
    return path


def request_batches(reqs, size, device):
    """``reqs`` in batches of ``size``, each request's history cut to the
    batch's shortest, as the uncached forward's inputs."""
    import torch
    out = []
    for i in range(0, len(reqs), size):
        group = reqs[i:i + size]
        t = min(len(r["tokens"]) for r in group)
        out.append({
            "tokens": torch.as_tensor(
                [list(r["tokens"][:t]) for r in group]).to(device),
            "profile": torch.as_tensor(
                [list(r["profile"]) for r in group]).float().to(device)})
    return out


def _phase3_setup(case: str):
    """Phase 3's config, params, requests and engine settings for
    ``case``."""
    from repro_torch.configs.base import OneRecConfig, TransformerConfig
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving.requests import build_requests
    paged = case not in ("contiguous", "fixed", "generate")
    cfg = OneRecConfig(
        name="onerec-smoke-aligned", history_len=16,
        transformer=TransformerConfig(
            name="onerec-smoke-aligned-backbone", n_layers=2, d_model=256,
            n_heads=8, n_kv_heads=2, head_dim=64, d_ff=512, vocab_size=576,
            moe=True, n_experts=6, top_k=2, d_expert=256,
            capacity_factor=1.5, ep_degree=4, max_seq_len=128,
            use_attention_kernel=not paged))
    params = init_onerec(0, cfg, device="cpu")
    reqs = build_requests(cfg, 24, 8, seed=1, ragged=True)
    policy = dict(page_size=32, prefill_chunk=PHASE3_CHUNK, **POLICY)
    if case == "paged-ptq":
        # calibrated on the CPU over phase 3's own requests, one at a time;
        # the same artifact goes to both engines
        if "paged-ptq" not in _ARTIFACTS:
            _ARTIFACTS["paged-ptq"] = write_artifact(
                "paged-ptq", cfg, params, request_batches(reqs, 1, "cpu"))
        return cfg, params, reqs, dict(
            batch_size=8, kv_dtype="float8_e4m3fn", page_size=32,
            quant_policy=_ARTIFACTS["paged-ptq"])
    if case == "paged-tree":
        reqs = [dict(r, n_candidates=TREE_WIDTHS[i % len(TREE_WIDTHS)])
                for i, r in enumerate(reqs)]
    contiguous = dict(paged=False, fused_decode="off", use_radix_topk=True)
    layout = {"paged": dict(page_size=32),
              "paged-unfused": dict(page_size=32, fused_decode="off"),
              "paged-policy": policy, "paged-return": policy,
              "paged-tree": dict(page_size=32, max_candidates=8),
              "contiguous": contiguous,
              "fixed": dict(contiguous, mode="fixed"),
              "generate": {}}[case]
    return cfg, params, reqs, dict(batch_size=8, kv_dtype="float8_e4m3fn",
                                   **layout)


def _serve_case(engine, case: str, cfg, reqs):
    """Serve phase 3's requests for ``case``: a closed batch, or through
    ``serve_visits`` (``paged-policy``: the 24 requests, the last 8 at a
    higher priority, submitted while the first 16 hold the slots;
    ``paged-return``: 12 first visits, then a return visit of each;
    ``paged-tree``: through ``submit`` and ``drain``, whole completions).
    Returns (items, or completions, and stats)."""
    if case == "paged-policy":
        outs, stats, _ = serve_visits(
            engine, [dict(r, priority=1) for r in reqs[:16]],
            [dict(r, priority=0) for r in reqs[16:]])
    elif case == "paged-return":
        outs, stats, _ = serve_visits(engine, *visits(cfg, 12, seed=1))
    elif case == "paged-tree":
        # whole completions: every branch's ranked item and score
        engine.reset_window()
        handles = [engine.submit(r, base_s=engine._window_t0) for r in reqs]
        engine.drain()
        outs, stats = [h.completion for h in handles], engine.stats()
    else:
        outs, stats = engine.serve_requests(reqs)
    return outs, stats


def _serve_pair(dev, case: str, *, kv_dtype=None, plain_gemm=False):
    """Serve ``case`` on the CPU and on the card (``plain_gemm``: the
    card's GEMM wrappers computing their plain versions).  Returns (CPU
    items, card items, CPU seeds, card seeds, CPU counters, card
    counters); fails unless both served every request and, on the policy
    cases, ran the same schedule with every policy counter > 0."""
    from repro_torch.serving import EngineConfig, ServingEngine
    cfg, params, reqs, ecfg = _phase3_setup(case)
    if kv_dtype:
        ecfg["kv_dtype"] = kv_dtype
    runs = []
    for d in ("cpu", dev):
        engine = ServingEngine(params, cfg, EngineConfig(**ecfg), device=d)
        seeds = _record_seeds(engine)
        with plain_gemms() if plain_gemm and d != "cpu" \
                else contextlib.nullcontext():
            outs, stats = _serve_case(engine, case, cfg, reqs)
        if stats["n_requests"] != len(outs) or len(outs) != 24:
            fail(f"card-vs-CPU {case} serve on {d} completed "
                 f"{stats['n_requests']} of 24")
        runs.append((outs, seeds, {k: int(stats[k]) for k in (
            "prefill_calls", "decode_steps", "decode_multi_steps",
            "branch_tokens", *POLICY_COUNTERS)}))
    (c_outs, c_seeds, c_cnt), (g_outs, g_seeds, g_cnt) = runs
    if case in ("paged-policy", "paged-return"):
        if c_cnt != g_cnt or not all(c_cnt[k] for k in POLICY_COUNTERS):
            fail(f"card-vs-CPU {case}: counters on the CPU {c_cnt}, on "
                 f"the card {g_cnt}: expected equal, each policy counter "
                 f"> 0")
    if case == "paged-tree" and (c_cnt != g_cnt
                                 or not c_cnt["decode_multi_steps"]):
        fail(f"card-vs-CPU {case}: counters on the CPU {c_cnt}, on the "
             f"card {g_cnt}: expected equal, tree steps > 0")
    return c_outs, g_outs, c_seeds, g_seeds, c_cnt, g_cnt


def _first_agree(case, tag, c_outs, g_outs, c_seeds, g_seeds):
    """Share of requests whose first token agrees; prints each
    disagreeing request's top-2 first-token logits on both devices."""
    import numpy as np
    for i, (a, b) in enumerate(zip(c_outs, g_outs)):
        if a[0] != b[0] and i in c_seeds and i in g_seeds:
            (ci, cv), (gi, gv) = c_seeds[i], g_seeds[i]
            print(f"[card-vs-cpu] {case}{tag} request {i}: first token "
                  f"{a[0]} on the CPU, {b[0]} on the card; top-2 logits CPU "
                  f"{ci} {[round(v, 4) for v in cv]} (gap "
                  f"{cv[0] - cv[1]:.4f}), card {gi} "
                  f"{[round(v, 4) for v in gv]} (gap {gv[0] - gv[1]:.4f})")
    return float(np.mean([a[0] == b[0] for a, b in zip(c_outs, g_outs)]))


def _overlap8(a, b):
    """Mean share of the top-8 ids two (rows, V) logit arrays agree on."""
    import numpy as np
    top = [np.argsort(-x, -1)[:, :8] for x in (a, b)]
    return float(np.mean([len(set(x) & set(y)) / 8 for x, y in zip(*top)]))


def card_vs_cpu(dev, case: str):
    """``case``: ``paged`` (decode through kernel ``paged_decode``),
    ``paged-unfused`` (the gathered view), ``paged-policy`` (prefix store,
    chunked prefill and preemption: the same requests, the last 8 at a
    higher priority, submitted while the first 16 hold the slots, so
    preempted rows resume through the store), ``paged-return`` (the same
    settings; 12 first visits, then a return visit of each that hits the
    first visit's stored prefix) or ``contiguous`` (``use_attention_kernel``
    and ``use_radix_topk``).  On the two policy cases the CPU and the card
    must run the same schedule (equal counters, each policy counter > 0).
    ``paged-ptq``: the paged layout through a policy artifact (static
    activation scales calibrated on the CPU, the k projections in int8).
    ``fixed``: the contiguous case's settings in ``mode="fixed"`` (three
    lock-step batches of 8; the teacher-forced part is the contiguous
    case's).  Every case is held to both bars.  ``paged-return`` also
    serves on bf16
    K/V, and on fp8 K/V with the GEMM wrappers computing their plain
    versions on the card, for information (ROADMAP C2's diagnosis)."""
    import numpy as np
    import torch
    from repro_torch.serving.executor import PhaseExecutor
    paged = case not in ("contiguous", "fixed")
    resumed = case in ("paged-policy", "paged-return")
    cfg, params, reqs, _ = _phase3_setup(case)
    c_outs, g_outs, c_seeds, g_seeds, _, counters = _serve_pair(dev, case)
    first = _first_agree(case, "", c_outs, g_outs, c_seeds, g_seeds)
    items = np.mean([np.array_equal(a, b) for a, b in zip(c_outs, g_outs)])
    # teacher-forced: the same prefill (in the policy cases a first segment
    # and its resume) and decode inputs on both devices
    kw = dict(page_size=32, n_pages=8 * 2,
              fused_decode=case != "paged-unfused") if paged else dict(
        paged=False, use_radix_topk=True)
    if case == "paged-ptq":
        from repro_torch.core.policy import load_policy_artifact
        artifact = load_policy_artifact(_ARTIFACTS[case])
        kw.update(quant_policy=artifact["policy"],
                  act_scales=artifact["act_scales"])
    exs = [PhaseExecutor(params, cfg, n_slots=8, device=torch.device(d),
                         kv_dtype="float8_e4m3fn", **kw)
           for d in ("cpu", dev)]
    hists = [np.asarray(r["tokens"]) for r in reqs[:8]]
    profs = [np.asarray(r["profile"]) for r in reqs[:8]]
    for ex in exs:
        for s, h in enumerate(hists):
            if paged and not ex.grant_slot(s, len(h) + 3):
                fail("card-vs-CPU page grant failed")
    if resumed:
        chunk = PHASE3_CHUNK
        for ex in exs:
            ex.prefill_insert([h[:chunk] for h in hists], profs,
                              list(range(8)))
        logits = [ex.resume_prefill([h[chunk:] for h in hists],
                                    list(range(8)), [chunk + 1] * 8)
                  .float().cpu().numpy() for ex in exs]
    else:
        logits = [ex.prefill_insert(hists, profs, list(range(8))).float()
                  .cpu().numpy() for ex in exs]
    lengths = np.asarray([len(h) + 1 for h in hists], np.int32)
    overlaps, devs = [], []
    for step in range(cfg.decode_len):
        overlaps.append(_overlap8(*logits))
        devs.append(float(np.abs(logits[0] - logits[1]).max()
                          / np.abs(logits[0]).max()))
        if step == cfg.decode_len - 1:
            break
        toks = np.argmax(logits[0], -1).astype(np.int32)[:, None]
        logits = [ex.decode(toks, lengths).float().cpu().numpy()
                  for ex in exs]
        lengths = lengths + 1
    extra = f"; counters on both devices {counters}" if resumed else ""
    print(f"[card-vs-cpu] {cfg.name} {case}: first tokens agree on "
          f"{first:.3f} of requests (>= {CPU_FIRST_TOKEN_AGREE}), whole "
          f"items {items:.3f}; "
          f"teacher-forced top-8 overlap per step "
          f"{[round(float(o), 3) for o in overlaps]} (>= "
          f"{CPU_TOP8_OVERLAP}), max |logit diff| / max |logit| per step "
          f"{[round(x, 4) for x in devs]}{extra}")
    if min(overlaps) < CPU_TOP8_OVERLAP:
        fail(f"card-vs-CPU {case}: teacher-forced overlap under the bar")
    if first < CPU_FIRST_TOKEN_AGREE:
        fail(f"card-vs-CPU {case}: first tokens under the bar")
    if case != "paged-return":
        return
    for tag, kw in ((" bf16 K/V", dict(kv_dtype="bfloat16")),
                    (" fp8 K/V, GEMMs plain on the card",
                     dict(plain_gemm=True))):
        c_outs, g_outs, c_seeds, g_seeds, _, _ = _serve_pair(dev, case,
                                                             **kw)
        agree = _first_agree(case, tag, c_outs, g_outs, c_seeds, g_seeds)
        print(f"[card-vs-cpu] {cfg.name} {case},{tag}: first tokens agree "
              f"on {agree:.3f} of requests (information); counters equal on "
              f"both devices")


def card_vs_cpu_tree(dev):
    """``paged-tree``: fused paged decode, fp8 K/V, ``max_candidates=8``,
    the requests' ``n_candidates`` cycling 1, 3, 4, 8 (width buckets 4 and
    8, dummy branches): the same schedule on both devices (equal counters,
    tree steps > 0); every request's set of branch seeds, and its
    top-ranked item's first token, agree on >= ``CPU_FIRST_TOKEN_AGREE``
    of requests; whole ranked sets for information.  Teacher-forced: 8
    slots prefilled on both devices, each seeded with the CPU's top-8
    prefill ids at the widths above, then the tree steps fed the CPU's
    per-branch argmax; every real branch's top-8 overlap >=
    ``CPU_TOP8_OVERLAP`` at each step."""
    import numpy as np
    import torch
    from repro_torch.serving.executor import PhaseExecutor
    case = "paged-tree"
    cfg, params, reqs, _ = _phase3_setup(case)
    c_comps, g_comps, _, _, _, counters = _serve_pair(dev, case)
    seeds = np.mean([sorted(int(i[0]) for i in a.items)
                     == sorted(int(i[0]) for i in b.items)
                     for a, b in zip(c_comps, g_comps)])
    first = np.mean([a.item[0] == b.item[0]
                     for a, b in zip(c_comps, g_comps)])
    ranked = np.mean([len(a.items) == len(b.items) and all(
        np.array_equal(x, y) for x, y in zip(a.items, b.items))
        for a, b in zip(c_comps, g_comps)])
    for c in g_comps:
        if c.scores != sorted(c.scores, reverse=True) \
                or len({tuple(i) for i in c.items}) != len(c.items):
            fail(f"card-vs-CPU {case}: request {c.rid}'s items are not "
                 f"distinct and ranked")
    n_br = 8
    exs = [PhaseExecutor(params, cfg, n_slots=8, device=torch.device(d),
                         kv_dtype="float8_e4m3fn", page_size=32,
                         n_pages=8 * 2, n_candidates=n_br)
           for d in ("cpu", dev)]
    hists = [np.asarray(r["tokens"]) for r in reqs[:8]]
    profs = [np.asarray(r["profile"]) for r in reqs[:8]]
    counts = np.asarray([TREE_WIDTHS[i % len(TREE_WIDTHS)]
                         for i in range(8)], np.int32)
    for ex in exs:
        for s_i, h in enumerate(hists):
            if not ex.grant_slot(s_i, len(h) + 1
                                 + n_br * ex.branch_stride):
                fail("card-vs-CPU tree page grant failed")
    logits = [ex.prefill_insert(hists, profs, list(range(8))).float()
              .cpu().numpy() for ex in exs]
    overlaps = [_overlap8(*logits)]
    starts = np.asarray([len(h) + 1 for h in hists], np.int32)
    lengths = starts.copy()
    toks = np.argsort(-logits[0], -1)[:, :n_br].astype(np.int32)
    real = np.arange(n_br)[None, :] < counts[:, None]
    for step in range(cfg.decode_len - 1):
        logits = [ex.decode_multi(toks, lengths, starts, counts).float()
                  .cpu().numpy() for ex in exs]
        overlaps.append(_overlap8(logits[0][real], logits[1][real]))
        toks = np.argmax(logits[0], -1).astype(np.int32)
        lengths = lengths + 1
    print(f"[card-vs-cpu] {cfg.name} {case}: branch seed sets agree on "
          f"{seeds:.3f} of requests, top-ranked first tokens on {first:.3f} "
          f"(>= {CPU_FIRST_TOKEN_AGREE}), whole ranked sets {ranked:.3f}; "
          f"teacher-forced top-8 overlap (prefill, then real branches of "
          f"each tree step) {[round(o, 3) for o in overlaps]} (>= "
          f"{CPU_TOP8_OVERLAP}); counters on both devices {counters}")
    if min(overlaps) < CPU_TOP8_OVERLAP:
        fail(f"card-vs-CPU {case}: teacher-forced overlap under the bar")
    if min(seeds, first) < CPU_FIRST_TOKEN_AGREE:
        fail(f"card-vs-CPU {case}: seeds or first tokens under the bar")


def card_vs_cpu_generate(dev):
    """``generate``: ``generate_items`` and ``beam_generate(beam_width=4)``
    with ``use_attention_kernel`` and ``topk_fn=radix_topk`` (kernels
    ``batch_attention`` and ``radix_topk`` on the card, their plain
    versions on the CPU) over 8 full histories, FP8 weights: greedy first
    tokens and the top beams' first tokens agree on >=
    ``CPU_FIRST_TOKEN_AGREE``; beams sorted on both devices, beams and
    whole items for information.  Teacher-forced: the shared-cache prefill
    and two decode steps fed the CPU's argmax, top-8 overlap >=
    ``CPU_TOP8_OVERLAP`` at each step."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.kernels.radix_topk.ops import radix_topk
    from repro_torch.models import onerec
    from repro_torch.serving.requests import build_requests
    cfg, params, _, _ = _phase3_setup("generate")
    reqs = build_requests(cfg, 8, 8, seed=1, ragged=False)
    runs = []
    for d in ("cpu", dev):
        qp = quantize_params(tree.map_with_path(lambda _, t: t.to(d),
                                                params), PAPER_POLICY)
        batch = request_batches(reqs, 8, d)[0]
        greedy = onerec.generate_items(qp, batch, cfg, topk_fn=radix_topk)
        beams, scores = onerec.beam_generate(qp, batch, cfg, beam_width=4,
                                             topk_fn=radix_topk)
        cache = onerec.init_cache(cfg, 8, device=d)
        lg, cache = onerec.prefill(qp, batch, cfg, cache)
        runs.append((qp, batch, cache, [lg], greedy.cpu().numpy(),
                     beams.cpu().numpy(), scores.cpu().numpy()))
    (cq, cb, cc, cl, cg, cbm, cs), (gq, _, gc, gl, gg, gbm, gs) = runs
    index = cb["tokens"].shape[1] + 1
    for step in range(cfg.decode_len - 1):
        tok = cl[-1].float().argmax(-1)[:, None].to(torch.int32)
        lg_c, cc = onerec.decode_step(cq, tok, cfg, cc, index + step)
        lg_g, gc = onerec.decode_step(gq, tok.to(dev), cfg, gc, index + step)
        cl.append(lg_c)
        gl.append(lg_g)
    overlaps = [_overlap8(a.float().cpu().numpy(), b.float().cpu().numpy())
                for a, b in zip(cl, gl)]
    first = float(np.mean(cg[:, 0] == gg[:, 0]))
    beam_first = float(np.mean(cbm[:, 0, 0] == gbm[:, 0, 0]))
    for sc in (cs, gs):
        if not (np.diff(sc, axis=1) <= 0).all():
            fail("card-vs-CPU generate: beams not sorted by score")
    print(f"[card-vs-cpu] {cfg.name} generate: greedy first tokens agree on "
          f"{first:.3f} of requests, whole items "
          f"{np.mean((cg == gg).all(1)):.3f}; top beams' first tokens "
          f"{beam_first:.3f}, whole beam sets "
          f"{np.mean((cbm == gbm).all((1, 2))):.3f}, max |score diff| "
          f"{np.abs(cs - gs).max():.4g}; teacher-forced top-8 overlap per "
          f"step {[round(o, 3) for o in overlaps]} (>= {CPU_TOP8_OVERLAP})")
    if min(overlaps) < CPU_TOP8_OVERLAP:
        fail("card-vs-CPU generate: teacher-forced overlap under the bar")
    if min(first, beam_first) < CPU_FIRST_TOKEN_AGREE:
        fail("card-vs-CPU generate: first tokens under the bar")


LM_PROMPT, LM_ROWS, LM_STEPS = 48, 16, 8     # phase 3's LM cases


def lm_smoke_cfg(case: str):
    """Phase 3's two small 128-aligned LM configs, at reduced depth:
    ``lm-gemma`` (a window of 16 with a global layer every third, two RoPE
    thetas, QK-norm, sandwich and zero-centred norms, tied and scaled
    embeddings, GeGLU, head_dim 256) and ``lm-moe`` (a leading dense
    layer, 16 experts top-4 with two shared experts and their gate, MHA);
    both with ``use_attention_kernel`` and q chunks of 16, so the 48-token
    prefill runs ``_chunked_attention``."""
    from repro_torch.configs.base import TransformerConfig
    common = dict(vocab_size=512, max_seq_len=128, remat=False,
                  attn_chunk_size=16, use_attention_kernel=True)
    if case == "lm-gemma":
        return TransformerConfig(
            name="lm-smoke-gemma", n_layers=6, d_model=256, n_heads=4,
            n_kv_heads=1, head_dim=256, d_ff=512, act="gelu",
            sliding_window=16, global_interval=3, rope_theta=1e6,
            rope_theta_local=1e4, use_qk_norm=True, use_post_norm=True,
            zero_centered_norm=True, embed_scale=True, tie_embeddings=True,
            **common)
    return TransformerConfig(
        name="lm-smoke-moe", n_layers=3, d_model=256, n_heads=4,
        n_kv_heads=4, head_dim=64, d_ff=256, moe=True, n_experts=16, top_k=4,
        d_expert=256, n_shared_experts=2, shared_expert_gate=True,
        n_dense_layers=1, d_ff_dense=512, capacity_factor=1.5, ep_degree=16,
        **common)


def card_vs_cpu_lm(dev, case: str):
    """``lm-gemma`` / ``lm-moe``: ``LM_ROWS`` prompts of ``LM_PROMPT`` tokens
    from ``SyntheticLMStream`` through ``lm_bundle``'s prefill step, then
    ``LM_STEPS`` greedy steps through its decode step over a shared cache
    of ``LM_PROMPT + LM_STEPS`` positions, FP8 weights (the same raw params
    PTQ'd on each device); on the card kernels ``fp8_gemm``,
    ``batch_attention`` (and ``fp8_grouped_gemm``), on the CPU their plain
    versions.  Greedy first tokens agree on >= ``CPU_FIRST_TOKEN_AGREE`` of
    the rows; teacher-forced (the card fed the CPU's greedy tokens) top-8
    overlap >= ``CPU_TOP8_OVERLAP`` at the prefill and every step; whole
    greedy sequences for information."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.data.lm import LMStreamConfig, SyntheticLMStream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    cfg = lm_smoke_cfg(case)
    prefill, decode = (steps.lm_bundle(case, cfg, ShapeSpec(
        kind, kind, seq_len=n, global_batch=LM_ROWS), fp8=False, seed=3,
        device="cpu") for kind, n in (("prefill", LM_PROMPT),
                                      ("decode", LM_PROMPT + LM_STEPS)))
    prompts = torch.from_numpy(SyntheticLMStream(LMStreamConfig(
        cfg.vocab_size, LM_PROMPT, LM_ROWS, seed=3)).batch_at(0)["tokens"])
    wrappers = _wrappers()

    def run(d, params, teacher=None):
        """Prefill logits, then greedy steps (fed ``teacher``'s tokens if
        given): (tokens (rows, 1 + steps), logits of each, launches)."""
        for w in wrappers.values():
            w.launches = 0
        logits, _ = prefill.fn(params, {"tokens": prompts.to(d)})
        cache = tree.map_with_path(lambda _, t: t.clone().to(d),
                                   decode.args[1])
        _, cache = tfm.prefill(params, prompts.to(d), cfg, cache)
        out = [logits]
        toks = [logits.argmax(-1).to(torch.int32)]
        for i in range(LM_STEPS):
            feed = toks[-1] if teacher is None else \
                torch.from_numpy(teacher[:, i]).to(d)
            lg, cache = decode.fn(params, cache, {"tokens": feed[:, None]},
                                  LM_PROMPT + i)
            out.append(lg)
            toks.append(lg.argmax(-1).to(torch.int32))
        logits = [x.float().cpu().numpy() for x in out]
        if not all(np.isfinite(x).all() for x in logits):
            fail(f"card-vs-CPU {case}: non-finite logits on {d}")
        return (torch.stack(toks, 1).cpu().numpy(), logits,
                {n: w.launches for n, w in wrappers.items()})

    params = {d: quantize_params(tree.map_with_path(
        lambda _, t: t.to(d), prefill.args[0]), PAPER_POLICY)
        for d in ("cpu", dev)}
    c_toks, c_logits, c_launch = run("cpu", params["cpu"])
    g_toks, _, g_launch = run(dev, params[dev])
    _, t_logits, _ = run(dev, params[dev], teacher=c_toks)
    if any(c_launch.values()):
        fail(f"card-vs-CPU {case}: kernels counted on the CPU {c_launch}")
    if not g_launch["fp8_gemm"] or not g_launch["batch_attention"] \
            or bool(cfg.moe) != bool(g_launch["fp8_grouped_gemm"]):
        fail(f"card-vs-CPU {case}: card launches {g_launch}")
    overlaps = [_overlap8(a, b) for a, b in zip(c_logits, t_logits)]
    first = float(np.mean(c_toks[:, 0] == g_toks[:, 0]))
    whole = float(np.mean((c_toks == g_toks).all(1)))
    print(f"[card-vs-cpu] {cfg.name} {case}: {LM_ROWS} prompts of "
          f"{LM_PROMPT} tokens + {LM_STEPS} greedy steps; greedy first "
          f"tokens agree on {first:.3f} of rows (>= {CPU_FIRST_TOKEN_AGREE}),"
          f" whole sequences {whole:.3f}; teacher-forced top-8 overlap "
          f"(prefill, then each step) {[round(o, 3) for o in overlaps]} (>= "
          f"{CPU_TOP8_OVERLAP}); card launches {g_launch}")
    if min(overlaps) < CPU_TOP8_OVERLAP:
        fail(f"card-vs-CPU {case}: teacher-forced overlap under the bar")
    if first < CPU_FIRST_TOKEN_AGREE:
        fail(f"card-vs-CPU {case}: first tokens under the bar")


# ---------------------------------------------------------------------------
# Phase 4: full width through the launcher
# ---------------------------------------------------------------------------


def _wrappers():
    """Every launch counter: the five kernels, and the int8 product
    (``torch._int_mm``, no kernel of the port)."""
    from repro_torch.core import quant
    from repro_torch.kernels.batch_attention import ops as attn_ops
    from repro_torch.kernels.fp8_gemm import ops as gemm_ops
    from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
    from repro_torch.kernels.paged_decode import ops as decode_ops
    from repro_torch.kernels.radix_topk import ops as topk_ops
    return {"fp8_gemm": gemm_ops.fp8_gemm,
            "fp8_grouped_gemm": grouped_ops.fp8_grouped_gemm,
            "paged_decode": decode_ops.paged_decode,
            "radix_topk": topk_ops.radix_topk,
            "batch_attention": attn_ops.batch_attention,
            "int8_matmul": quant.int8_matmul}


def _drive(dev, path: str, run, expect_fn):
    """Drive one main path with every kernel's launch count zeroed just
    before and read just after; check the outputs and hold the counts
    against ``expect_fn(stats)``, the layer arithmetic.  Returns (outputs,
    launches, stats, peak device bytes)."""
    import torch
    from repro_torch.configs.onerec_v2 import CONFIG
    wrappers = _wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    outs, stats = run()[:2]
    wall = time.perf_counter() - t0
    launches = {n: w.launches for n, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[full-width] {CONFIG.name} {path}: {len(outs)} requests, "
          f"{int(stats['prefill_calls'])} prefills + "
          f"{int(stats['decode_steps'])} decode steps + "
          f"{int(stats['select_calls'])} unfused selects in {wall:.1f} s "
          f"(init + PTQ + serve); serve p50 "
          f"{stats['p50_latency_s'] * 1e3:.1f} ms, p99 "
          f"{stats['p99_latency_s'] * 1e3:.1f} ms, "
          f"{stats['throughput_rps']:.2f} req/s, join p50 / p99 "
          f"{stats['join_p50_s'] * 1e3:.1f} / "
          f"{stats['join_p99_s'] * 1e3:.1f} ms, decode stall "
          f"{100 * stats['decode_stall_frac']:.0f}%; KV pool "
          f"{stats['kv_bytes'] / 2**30:.3f} GiB; peak device memory "
          f"{peak / 2**30:.2f} GiB; launches {launches}")
    if len(outs) != 64 or stats["n_requests"] != 64:
        fail(f"full width {path} completed {stats['n_requests']} of 64 "
             f"requests")
    for item in outs:
        if item.shape != (CONFIG.decode_len,) or not (
                (item >= 0) & (item < CONFIG.vocab_size)).all():
            fail(f"{path}: out-of-vocabulary or short item {item}")
    expect = expect_fn(stats)
    if launches != expect or not all(launches[n] for n, e in expect.items()
                                     if e):
        fail(f"{path}: launch counts {launches} != layer arithmetic "
             f"{expect}")
    return outs, launches, stats, peak


@contextlib.contextmanager
def guarded_decode_steps(dev, path: str):
    """Phase 4 (a)'s decode steps under ``analysis.guards.steady_state``
    (N10a): every ``PhaseExecutor.decode`` after an engine's first (the
    warmup) runs inside the guard, so an unsanctioned host sync or a
    kernel build fails the run.  Yields the sanctioned syncs of each
    guarded step (the explicit staging of the step's inputs and the fused
    select's readback)."""
    from repro_torch.analysis.guards import (SteadyStateViolation,
                                             steady_state)
    from repro_torch.serving.executor import PhaseExecutor
    decode = PhaseExecutor.decode
    per_step = []

    def guarded(self, *args, **kwargs):
        if not self.counters["decode_steps"]:
            return decode(self, *args, **kwargs)
        try:
            with steady_state(dev) as mon:
                out = decode(self, *args, **kwargs)
        except (RuntimeError, SteadyStateViolation) as e:
            fail(f"{path}: decode step {self.counters['decode_steps']} "
                 f"under steady_state(): {e}")
        per_step.append(mon.sanctioned)
        return out

    PhaseExecutor.decode = guarded
    try:
        yield per_step
    finally:
        PhaseExecutor.decode = decode


def full_width(dev):
    """Phase 4: the paged path through the launcher, then the contiguous
    path through ``ServingEngine``.  Returns each path's launch counts and
    (a)'s items."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.launch import serve
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import build_requests
    n_layers = CONFIG.transformer.n_layers

    def per_forward(stats):
        forwards = int(stats["prefill_calls"] + stats["decode_steps"])
        return {"fp8_gemm": forwards * 4 * n_layers,           # q, k, v, o
                "fp8_grouped_gemm": forwards * 3 * n_layers,   # gate, up, down
                "int8_matmul": 0}

    with guarded_decode_steps(dev, "paged") as sanctioned_per_step:
        paged_outs, paged, paged_stats, paged_peak = _drive(
            dev, "paged", lambda: serve.main([
                "--paged", "--kv-fp8", "--fused-decode", "auto",
                "--requests", "64", "--batch", "32", "--ragged", "--seed",
                "0", "--device", str(dev)]),
            lambda st: {**per_forward(st), "radix_topk": 0,
                        "batch_attention": 0,
                        "paged_decode": int(st["decode_steps"]) * n_layers})
    if len(sanctioned_per_step) != int(paged_stats["decode_steps"]) - 1:
        fail(f"paged: {len(sanctioned_per_step)} decode steps guarded of "
             f"{int(paged_stats['decode_steps'])}")
    print(f"[steady-state] paged: {len(sanctioned_per_step)} decode steps "
          f"after the first under steady_state(): 0 unsanctioned host "
          f"syncs, 0 kernel builds; sanctioned syncs per step (count: "
          f"steps) {dict(collections.Counter(sanctioned_per_step))}")

    def contiguous():
        cfg = dataclasses.replace(CONFIG, transformer=dataclasses.replace(
            CONFIG.transformer, use_attention_kernel=True))
        params = init_onerec(0, cfg, device=dev)
        engine = ServingEngine(params, cfg, EngineConfig(
            batch_size=32, kv_dtype="float8_e4m3fn", paged=False,
            fused_decode="off", use_radix_topk=True), device=dev)
        del params       # the engine holds the quantized tree
        return engine.serve_requests(build_requests(cfg, 64, 32, 0, True))

    outs, contig, contig_stats, _ = _drive(
        dev, "contiguous", contiguous,
        lambda st: {**per_forward(st), "paged_decode": 0,
                    "radix_topk": int(st["select_calls"]),
                    "batch_attention": int(st["decode_steps"]) * n_layers})
    first = np.mean([a[0] == b[0] for a, b in zip(outs, paged_outs)])
    items = np.mean([np.array_equal(a, b) for a, b in zip(outs, paged_outs)])
    print(f"[full-width] contiguous vs paged: first tokens agree on "
          f"{first:.3f} of requests, whole items on {items:.3f}; every item "
          f"agrees: {bool(items == 1.0)} (information: both prefills write "
          f"only the real rows of a padded group, and the two decode "
          f"attentions round differently)")
    return {"paged": paged, "contiguous": contig,
            "policy": policy_path(dev, per_forward),
            "ptq": ptq_path(dev, per_forward, paged_outs),
            "tree": tree_path(dev, per_forward, paged_stats, paged_peak),
            "fixed": fixed_path(dev, per_forward, contig_stats),
            **generation_path(dev), **lm_zoo_path(dev),
            **recsys_path(dev), **egnn_path(dev)}, paged_outs


def _latency_line(name, stats, ref_name, ref):
    print(f"[full-width] {name} beside {ref_name} (same run): p50 "
          f"{stats['p50_latency_s'] * 1e3:.1f} / "
          f"{ref['p50_latency_s'] * 1e3:.1f} ms, p99 "
          f"{stats['p99_latency_s'] * 1e3:.1f} / "
          f"{ref['p99_latency_s'] * 1e3:.1f} ms, throughput "
          f"{stats['throughput_rps']:.2f} / {ref['throughput_rps']:.2f} "
          f"req/s")


TREE_MIX = (8, 4, 3, 1)          # phase 4 (e)'s n_candidates, cycled


def tree_path(dev, per_forward, paged_stats, paged_peak):
    """Phase 4 (e): ``ServingEngine`` on (a)'s paged FP8 pool (page 32,
    fused decode, 32 slots) with ``max_candidates=8`` serves (a)'s 64
    ragged requests, their ``n_candidates`` cycling 8, 4, 3, 1: kernels
    ``fp8_gemm``, ``fp8_grouped_gemm`` and ``paged_decode`` in tree mode.
    Tree steps, branch tokens and selects answered from the fused stash
    must each be > 0; every completion carries its ``n_candidates``
    distinct items, ranked by non-increasing score, and the peak device
    memory stays within 5% of (a)'s (the branch spans add 14 positions a
    row)."""
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import build_requests
    n_layers = CONFIG.transformer.n_layers
    reqs = [dict(r, n_candidates=TREE_MIX[i % len(TREE_MIX)])
            for i, r in enumerate(build_requests(CONFIG, 64, 32, 0, True))]
    comps = []

    def serve():
        params = init_onerec(0, CONFIG, device=dev)
        engine = ServingEngine(params, CONFIG, EngineConfig(
            batch_size=32, kv_dtype="float8_e4m3fn", page_size=32,
            fused_decode="auto", max_candidates=8), device=dev)
        del params       # the engine holds the quantized tree
        engine.reset_window()
        handles = [engine.submit(r, base_s=engine._window_t0) for r in reqs]
        engine.drain()
        comps.extend(h.completion for h in handles)
        return [c.item for c in comps], engine.stats()

    _, launches, stats, peak = _drive(
        dev, "tree", serve,
        lambda st: {**per_forward(st), "radix_topk": 0, "batch_attention": 0,
                    "paged_decode": int(st["decode_steps"]) * n_layers})
    for key in ("decode_multi_steps", "branch_tokens", "fused_select_hits"):
        if not stats[key] > 0:
            fail(f"tree path: {key} = {stats[key]}, expected > 0")
    for r, c in zip(reqs, comps):
        if len(c.items) != r["n_candidates"] \
                or len({tuple(i) for i in c.items}) != len(c.items) \
                or c.scores != sorted(c.scores, reverse=True):
            fail(f"tree path: request {c.rid} carries {len(c.items)} items "
                 f"for n_candidates {r['n_candidates']}, or they are not "
                 f"distinct and ranked")
    if peak > 1.05 * paged_peak:
        fail(f"tree path: peak device memory {peak / 2**30:.2f} GiB over "
             f"(a)'s {paged_peak / 2**30:.2f} GiB by more than 5%")
    print(f"[full-width] tree: {int(stats['decode_multi_steps'])} of "
          f"{int(stats['decode_steps'])} decode steps tree steps, "
          f"{int(stats['branch_tokens'])} branch tokens "
          f"({stats['branches_per_decode_step']:.1f} a step), "
          f"{int(stats['fused_select_hits'])} selects from the fused stash; "
          f"{int(stats['pages_total'])} pages; peak device memory "
          f"{peak / 2**30:.2f} GiB")
    _latency_line("tree", stats, "paged (a)", paged_stats)
    return launches


def fixed_path(dev, per_forward, contig_stats):
    """Phase 4 (f): ``ServingEngine(mode="fixed")`` on the contiguous FP8
    pool, 32 slots, ``use_attention_kernel`` and ``use_radix_topk``,
    serves the 64 requests in two lock-step batches: kernels ``fp8_gemm``,
    ``fp8_grouped_gemm``, ``batch_attention`` and ``radix_topk``.  Its
    latency beside (b)'s, for information (fixed mode is the JAX
    benchmark's reference arm)."""
    import dataclasses
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import build_requests
    n_layers = CONFIG.transformer.n_layers
    cfg = dataclasses.replace(CONFIG, transformer=dataclasses.replace(
        CONFIG.transformer, use_attention_kernel=True))

    def serve():
        params = init_onerec(0, cfg, device=dev)
        engine = ServingEngine(params, cfg, EngineConfig(
            mode="fixed", batch_size=32, kv_dtype="float8_e4m3fn",
            paged=False, fused_decode="off", use_radix_topk=True),
            device=dev)
        del params       # the engine holds the quantized tree
        return engine.serve_requests(build_requests(cfg, 64, 32, 0, True))

    _, launches, stats, _ = _drive(
        dev, "fixed", serve,
        lambda st: {**per_forward(st), "paged_decode": 0,
                    "radix_topk": int(st["select_calls"]),
                    "batch_attention": int(st["decode_steps"]) * n_layers})
    if stats["prefill_calls"] != 2:
        fail(f"fixed path: {stats['prefill_calls']} prefills for two "
             f"batches")
    _latency_line("fixed", stats, "contiguous (b)", contig_stats)
    return launches


def generation_path(dev):
    """Phase 4 (g): ``generate_items`` and ``beam_generate(beam_width=8)``
    over the batch-shared cache on 32 of the requests' profiles with full
    histories (128 items), FP8 weights, ``use_attention_kernel`` and
    ``topk_fn=radix_topk``: kernels ``fp8_gemm``, ``fp8_grouped_gemm``,
    ``batch_attention`` and ``radix_topk``.  Launches: greedy 1 prefill +
    3 decode steps and 3 selects, beam 1 + 2 and 3 selects; beams sorted
    by score, ``beam_generate(beam_width=1)`` equal to ``generate_items``
    on the card."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.kernels.radix_topk.ops import radix_topk
    from repro_torch.models import onerec
    from repro_torch.serving.requests import build_requests
    n_layers = CONFIG.transformer.n_layers
    cfg = dataclasses.replace(CONFIG, transformer=dataclasses.replace(
        CONFIG.transformer, use_attention_kernel=True))
    reqs = build_requests(cfg, 32, 32, 0, False)
    batch = request_batches(reqs, 32, dev)[0]
    if batch["tokens"].shape[1] != cfg.history_len * cfg.n_codebooks:
        fail("generation path: histories are not full length")
    wrappers = _wrappers()
    t0 = time.perf_counter()
    params = quantize_params(onerec.init_onerec(0, cfg, device=dev),
                             PAPER_POLICY)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    launches, walls = {}, {}
    for name, fn in (
            ("greedy", lambda: onerec.generate_items(
                params, batch, cfg, topk_fn=radix_topk)),
            ("beam", lambda: onerec.beam_generate(
                params, batch, cfg, beam_width=8, topk_fn=radix_topk))):
        for w in wrappers.values():
            w.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        launches[name] = {n: w.launches for n, w in wrappers.items()}
        if name == "greedy":
            greedy = out.cpu().numpy()
        else:
            beams, scores = (t.cpu().numpy() for t in out)
    peak = torch.cuda.max_memory_allocated(dev)
    one, _ = onerec.beam_generate(params, batch, cfg, beam_width=1,
                                  topk_fn=radix_topk)
    for name, steps in (("greedy", cfg.decode_len),
                        ("beam", cfg.decode_len - 1)):
        forwards = 1 + steps
        expect = {"fp8_gemm": forwards * 4 * n_layers,
                  "fp8_grouped_gemm": forwards * 3 * n_layers,
                  "batch_attention": steps * n_layers,
                  "radix_topk": cfg.decode_len, "paged_decode": 0,
                  "int8_matmul": 0}
        if launches[name] != expect:
            fail(f"generation {name}: launch counts {launches[name]} != "
                 f"layer arithmetic {expect}")
    v = cfg.vocab_size
    for items in (greedy, beams):
        if not ((items >= 0) & (items < v)).all():
            fail("generation path: out-of-vocabulary ids")
    if greedy.shape != (32, cfg.decode_len) \
            or beams.shape != (32, 8, cfg.decode_len):
        fail(f"generation path: shapes {greedy.shape}, {beams.shape}")
    if not (np.diff(scores, axis=1) <= 0).all():
        fail("generation path: beams not sorted by score")
    if not np.array_equal(one[:, 0].cpu().numpy(), greedy):
        fail("generation path: beam_generate(beam_width=1) differs from "
             "generate_items")
    print(f"[full-width] {cfg.name} generate: 32 full histories "
          f"({batch['tokens'].shape[1]} tokens + profile); greedy "
          f"{walls['greedy']:.3f} s, beam W=8 {walls['beam']:.3f} s (init + "
          f"PTQ {setup_s:.1f} s apart); top beam = greedy item on "
          f"{np.mean((beams[:, 0] == greedy).all(1)):.3f} of rows; "
          f"beam_generate(beam_width=1) == generate_items; peak device "
          f"memory {peak / 2**30:.2f} GiB; launches {launches}")
    return {"generate": launches["greedy"], "beam": launches["beam"]}


ZOO = ("llama3-8b", "gemma3-1b", "qwen2-moe-a2.7b", "deepseek-moe-16b",
       "deepseek-coder-33b")
ZOO_B, ZOO_PROMPT, ZOO_DECODE = 4, 4096, 16


def zoo_per_forward(cfg):
    """Kernel launches of one forward of an LM (a prefill or a decode
    step): ``fp8_gemm`` q, k, v, o a layer, gate, up, down a dense layer
    and a layer's shared experts; ``fp8_grouped_gemm`` gate, up, down an
    MoE layer."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe else 0
    dense = cfg.n_layers - n_moe
    shared = n_moe if cfg.n_shared_experts else 0
    return {"fp8_gemm": 4 * cfg.n_layers + 3 * (dense + shared),
            "fp8_grouped_gemm": 3 * n_moe}


def zoo_decode_floor_ms(params, cache, cfg):
    """The least time of one decode step at the full cache, in ms: every
    weight it reads (all padded experts, the kernel's read; the head, or
    the tied table; not the embedding rows it gathers) and the whole K/V
    cache, once each, over the HBM rate."""
    from repro_torch import tree
    from repro_torch.core.quant import QuantizedTensor
    n = 0
    for path, leaf in tree.leaves_with_path(params):
        if path.startswith("embed/") and not cfg.tie_embeddings:
            continue
        n += leaf.nbytes() if isinstance(leaf, QuantizedTensor) \
            else leaf.numel() * leaf.element_size()
    n += sum(leaf.numel() * leaf.element_size()
             for path, leaf in tree.leaves_with_path(cache)
             if path.rsplit("/", 1)[-1] in ("k", "v"))
    return n / HBM_BYTES_PER_S * 1e3


def lm_zoo_path(dev):
    """Phase 4 (h): each LM of the zoo at its published widths and depth:
    ``lm_bundle``'s decode bundle (FP8 PTQ with the paper's policy, layer by
    layer at init, raw leaves bf16; an empty shared bf16 cache of
    ``ZOO_PROMPT + ZOO_DECODE`` positions), ``transformer.prefill`` of
    ``ZOO_B`` prompts of ``ZOO_PROMPT`` tokens from ``SyntheticLMStream``
    at the arch's vocabulary (``_chunked_attention``; gemma3-1b's 512-slot
    rings wrap), then ``decode_fused`` for ``ZOO_DECODE`` steps with
    ``use_attention_kernel``.  Launch counts are zeroed before and read
    after the prefill and the decode, and must equal the layer arithmetic
    (``batch_attention``: n_layers a decode step, none at prefill); logits
    finite, tokens in the vocabulary.  Returns {"lm-zoo/<arch>": launches
    of prefill + decode}."""
    import dataclasses
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.lm import LMStreamConfig, SyntheticLMStream
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    wrappers = _wrappers()
    out = {}
    for arch in ZOO:
        cfg = dataclasses.replace(registry.get_arch(arch).CONFIG,
                                  use_attention_kernel=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        bundle = steps.lm_bundle(arch, cfg, ShapeSpec(
            "zoo-decode", "decode", seq_len=ZOO_PROMPT + ZOO_DECODE,
            global_batch=ZOO_B), fp8=True, dtype=torch.bfloat16, device=dev)
        params, cache = bundle.args[:2]
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        weights = torch.cuda.memory_allocated(dev)
        prompts = torch.from_numpy(SyntheticLMStream(LMStreamConfig(
            cfg.vocab_size, ZOO_PROMPT, ZOO_B, seed=0)).batch_at(0)["tokens"]
        ).to(dev)
        per = zoo_per_forward(cfg)
        launches, walls = {}, {}
        for phase in ("prefill", "decode"):
            for w in wrappers.values():
                w.launches = 0
            t0 = time.perf_counter()
            if phase == "prefill":
                logits, cache = tfm.prefill(params, prompts, cfg, cache)
                first = logits.argmax(-1)[:, None].to(torch.int32)
                forwards = 1
            else:
                toks, cache = tfm.decode_fused(params, first, cfg, cache,
                                               ZOO_PROMPT, ZOO_DECODE)
                forwards = ZOO_DECODE
            torch.cuda.synchronize()
            walls[phase] = time.perf_counter() - t0
            launches[phase] = {n: w.launches for n, w in wrappers.items()}
            expect = {"fp8_gemm": forwards * per["fp8_gemm"],
                      "fp8_grouped_gemm": forwards * per["fp8_grouped_gemm"],
                      "batch_attention": cfg.n_layers * ZOO_DECODE
                      if phase == "decode" else 0,
                      "paged_decode": 0, "radix_topk": 0, "int8_matmul": 0}
            if launches[phase] != expect:
                fail(f"lm-zoo {arch} {phase}: launch counts "
                     f"{launches[phase]} != layer arithmetic {expect}")
            if phase == "decode":
                # the last step again (its input token, position and
                # writes are the same), outside the counted window, for
                # its logits
                logits, cache = tfm.decode_step(
                    params, toks[:, -1:], cfg, cache,
                    ZOO_PROMPT + ZOO_DECODE - 1)
            if not bool(torch.isfinite(logits).all()):
                fail(f"lm-zoo {arch} {phase}: non-finite logits")
        toks = toks.cpu()
        if toks.shape != (ZOO_B, ZOO_DECODE) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            fail(f"lm-zoo {arch}: tokens {tuple(toks.shape)} out of range")
        peak = torch.cuda.max_memory_allocated(dev)
        floor_ms = zoo_decode_floor_ms(params, cache, cfg)
        print(f"[full-width] lm-zoo {arch}: {cfg.n_layers} of "
              f"{cfg.n_layers} layers (published widths, depth uncut), "
              f"{cfg.param_count_estimate() / 1e9:.3f} B params "
              f"({cfg.active_param_count_estimate() / 1e9:.3f} B active); "
              f"init + PTQ {init_s:.1f} s, weights + cache "
              f"{weights / 2**30:.2f} GiB; prefill {ZOO_B} x {ZOO_PROMPT} "
              f"{walls['prefill'] * 1e3:.1f} ms "
              f"({ZOO_B * ZOO_PROMPT / walls['prefill']:.0f} tokens/s); "
              f"decode_fused {ZOO_DECODE} steps "
              f"{walls['decode'] * 1e3 / ZOO_DECODE:.2f} ms a step "
              f"({ZOO_B * ZOO_DECODE / walls['decode']:.1f} generated "
              f"tokens/s; byte floor of the last step {floor_ms:.3f} ms); "
              f"peak device memory {peak / 2**30:.2f} GiB; "
              f"launches {launches}")
        out[f"lm-zoo/{arch}"] = {n: launches["prefill"][n]
                                 + launches["decode"][n] for n in wrappers}
        del bundle, params, cache, logits
    return out


def _policy_line(name, stats, peak, held=None):
    held_txt = "" if held is None else \
        f"first visits held {held} of 32 slots at the return visits; "
    print(f"[full-width] {name}: {held_txt}p50 / p99 latency "
          f"{stats['p50_latency_s'] * 1e3:.1f} / "
          f"{stats['p99_latency_s'] * 1e3:.1f} ms (priority 0: p99 "
          f"{stats['class_stats'].get('0', {}).get('p99_latency_s', 0) * 1e3:.1f}"
          f" ms, priority 1: p99 "
          f"{stats['class_stats'].get('1', {}).get('p99_latency_s', 0) * 1e3:.1f}"
          f" ms), join p50 / p99 {stats['join_p50_s'] * 1e3:.1f} / "
          f"{stats['join_p99_s'] * 1e3:.1f} ms over "
          f"{int(stats['join_steps'])} join steps, decode stall "
          f"{100 * stats['decode_stall_frac']:.0f}%, "
          f"{int(stats['prefill_calls'])} prefills ("
          f"{int(stats['resume_calls'])} resumes) + "
          f"{int(stats['decode_steps'])} decode steps, prefix hit rate "
          f"{stats['prefix_hit_rate']:.3f} ({int(stats['prefix_hits'])} "
          f"hits, {int(stats['prefix_tokens_saved'])} prefill tokens "
          f"saved, {int(stats['cow_copies'])} COW pages, "
          f"{int(stats['prefix_evictions'])} evictions), "
          f"{int(stats['preemptions'])} preemptions, "
          f"{int(stats['deadline_misses'])} deadline misses of "
          f"{int(stats['n_requests'])} (deadline {DEADLINE_S} s), peak device "
          f"memory {peak / 2**30:.2f} GiB")


def policy_path(dev, per_forward):
    """Phase 4 (c): 32 first visits, then 32 return visits, on the paged
    FP8 pool with the prefix store, chunked prefill and preemption; then
    the same visits with the three knobs off, for information."""
    import numpy as np
    import torch
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    n_layers = CONFIG.transformer.n_layers
    first, back = visits(CONFIG, 32, seed=0)
    first = [dict(r, deadline_s=DEADLINE_S) for r in first]
    back = [dict(r, deadline_s=DEADLINE_S) for r in back]
    runs = {}

    def serve(knobs):
        params = init_onerec(0, CONFIG, device=dev)
        engine = ServingEngine(params, CONFIG, EngineConfig(
            batch_size=32, kv_dtype="float8_e4m3fn", page_size=32,
            fused_decode="auto", **knobs), device=dev)
        del params       # the engine holds the quantized tree
        out = serve_visits(engine, first, back)
        runs[bool(knobs)] = out
        return out

    outs, launches, stats, peak = _drive(
        dev, "policy", lambda: serve(dict(prefill_chunk=128, **POLICY)),
        lambda st: {**per_forward(st), "radix_topk": 0, "batch_attention": 0,
                    "paged_decode": int(st["decode_steps"]) * n_layers})
    _policy_line("policy (prefix store, chunk 128, preemption)", stats, peak,
                 runs[True][2])
    for key in ("resume_calls", "prefix_hits", "cow_copies", "preemptions"):
        if not stats[key] > 0:
            fail(f"policy path: {key} = {stats[key]}, expected > 0")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    off_outs, off_stats, held = serve({})
    _policy_line("the same visits, knobs off", off_stats,
                 torch.cuda.max_memory_allocated(dev), held)
    agree = np.mean([np.array_equal(a, b) for a, b in zip(outs, off_outs)])
    first_tok = np.mean([a[0] == b[0] for a, b in zip(outs, off_outs)])
    print(f"[full-width] policy vs knobs off: items agree on {agree:.3f} "
          f"of 64, first tokens on {first_tok:.3f} (information: MoE "
          f"capacity makes batch composition matter at full width)")
    return launches


def ptq_path(dev, per_forward, paged_outs):
    """Phase 4 (d): the paged path (page 32, fused decode, 32 slots, fp8
    K/V) through a policy artifact: ``ptq_policy()`` with static scales
    calibrated on the card over two batches of phase 4's requests, so q, v
    and o run kernel ``fp8_gemm``'s static mode and k the int8 product.
    Serves the 64 requests of phase 4 (a) and compares its items with (a)'s
    dynamic-scale run (information)."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import build_requests
    n_layers = CONFIG.transformer.n_layers
    reqs = build_requests(CONFIG, 64, 32, 0, True)
    t0 = time.perf_counter()
    params = init_onerec(0, CONFIG, device=dev)
    path = write_artifact("phase4-ptq", CONFIG, params,
                          request_batches(reqs[:32], 16, dev))
    del params
    with open(path) as f:
        n_scales = len(json.load(f)["act_scales"])
    print(f"[full-width] ptq: artifact with {n_scales} static scales "
          f"calibrated on the card in {time.perf_counter() - t0:.1f} s "
          f"(init + PTQ + two forwards of 16 requests)")

    def serve():
        params = init_onerec(0, CONFIG, device=dev)
        engine = ServingEngine(params, CONFIG, EngineConfig(
            batch_size=32, kv_dtype="float8_e4m3fn", page_size=32,
            fused_decode="auto", quant_policy=path), device=dev)
        del params       # the engine holds the quantized tree
        static = sum(1 for _, leaf in tree.leaves_with_path(
            engine.executor.params)
            if getattr(leaf, "act_scale", None) is not None)
        if static != n_scales:
            fail(f"ptq path: {static} leaves carry a static scale, the "
                 f"artifact holds {n_scales}")
        return engine.serve_requests(reqs)

    def expect(st):
        forwards = int(st["prefill_calls"] + st["decode_steps"])
        return {**per_forward(st),
                "fp8_gemm": forwards * 3 * n_layers,           # q, v, o
                "int8_matmul": forwards * n_layers,            # k
                "radix_topk": 0, "batch_attention": 0,
                "paged_decode": int(st["decode_steps"]) * n_layers}

    outs, launches, _, _ = _drive(dev, "ptq", serve, expect)
    first = np.mean([a[0] == b[0] for a, b in zip(outs, paged_outs)])
    items = np.mean([np.array_equal(a, b) for a, b in zip(outs, paged_outs)])
    print(f"[full-width] ptq vs paged (dynamic scales, fp8 k projections): "
          f"first tokens agree on {first:.3f} of requests, whole items on "
          f"{items:.3f} (information)")
    return launches


# ---------------------------------------------------------------------------
# The recsys family and the EGNN: phase 2's recsys GEMMs, phase 3's recsys
# cases, phase 4 (i) and (j)
# ---------------------------------------------------------------------------

RECSYS = ("two-tower-retrieval", "mind", "din", "dien")
# each config's per-channel fp8 kernels under the paper's policy, in the
# order a call launches kernel ``fp8_gemm`` on them: (layer, K, N)
RECSYS_GEMMS = {
    "two-tower-retrieval": (("user tower", 2304, 1024),
                            ("user tower", 1024, 512),
                            ("user tower", 512, 256),
                            ("item tower", 256, 1024),
                            ("item tower", 1024, 512),
                            ("item tower", 512, 256)),
    "mind": (("proj tower", 576, 64),),
    "din": (("score mlp", 180, 200), ("score mlp", 200, 80),
            ("score mlp", 80, 1)),
    "dien": (("score mlp", 270, 200), ("score mlp", 200, 80),
             ("score mlp", 80, 1)),
}
RECSYS_P99, RECSYS_BULK, RECSYS_CANDS = 512, 262144, 1_000_000
# candidates a retrieval call in phase 4 (i): the whole million where the
# working set is small; DIN's attention MLP (C x 100 rows of 72, an f32
# copy and an f32 output of 80) and DIEN's two GRU passes over C copies of
# the user take 4 calls of 250,000 to stay under ~60 GiB
RECSYS_CHUNK = {"two-tower-retrieval": 1_000_000, "mind": 1_000_000,
                "din": 250_000, "dien": 250_000}
RECSYS_TIMED = 5                 # timed calls a cell, after one warmup
RECSYS_SCORE_REL = 1e-2          # phase 3: card vs CPU score rel. L2
RECSYS_TOP10 = 0.9               # phase 3: card vs CPU top-10 overlap


def recsys_rows(arch: str, layer: str):
    """The rows a layer's product sees at ``serve_p99`` and the most it sees
    in phase 4 (i): the batch (serve_bulk), the retrieval chunk for the
    item tower, times MIND's 4 interests for its proj tower."""
    top = RECSYS_CHUNK[arch] if layer == "item tower" else RECSYS_BULK
    mult = 4 if arch == "mind" else 1
    return RECSYS_P99 * mult, top * mult


def check_fp8_gemm_recsys(dev, records):
    """Phase 2, ROADMAP C5: kernel ``fp8_gemm`` at the recsys family's 13
    quantized (K, N) -- K = 180, 200, 270 and N = 1, 80, 200 among them --
    at the rows ``serve_p99`` gives each and the most phase 4 (i) gives it,
    dynamic and static scales, each held to ``TOL`` and ``OFF_EXACT_MAX``;
    device time (calls in a CUDA graph, kernel and library in turns),
    eager time, the plain version's, the bound, and ``torch._scaled_mm``'s
    time on the same operands quantized beforehand, or its refusal."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_gemm import ops
    g = torch.Generator(device=dev).manual_seed(11)
    rows, worst = [], 0.0
    for arch, layers in RECSYS_GEMMS.items():
        for layer, k, n in layers:
            # one weight (the serve path reuses these small towers; they
            # stay in L2), PTQ's padded K-major payload
            wq = quant.quantize_per_channel(torch.randn(
                1, k, n, device=dev, generator=g) / math.sqrt(k))
            sw = wq.scale.reshape(1, n).contiguous()
            w = wq.data
            for m in recsys_rows(arch, layer):
                x = torch.randn(1, m, k, device=dev, generator=g).to(
                    torch.bfloat16)
                s_act = (x.float().abs().max() / 448.0).reshape(1, 1)
                shape = f"M={m} K={k} N={n}"
                errs, shares = [], []
                for static in (None, s_act):
                    out = ops.fp8_gemm(x, w, sw, act_scale=static)
                    ref = ops.fp8_gemm_plain(x, w, sw, act_scale=static)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    tol = TOL * ref.float().abs().max().item()
                    if not err <= tol:
                        mode = "static" if static is not None else "dynamic"
                        fail(f"fp8_gemm {arch} {shape} {mode}: max |diff| "
                             f"{err} > {tol}")
                    if static is None:
                        xq = quant.quantize_per_token(x)
                        xd, sx = xq.data, xq.scale.double()
                    else:
                        xd = quant.cast_to_fp8(x, static.reshape(1, 1, 1))
                        sx = static.double()
                    exact = (xd.double() @ w.double()) * sx \
                        * sw.double()[:, None, :]
                    shares.append(off_exact(
                        "fp8_gemm" + (" static" if static is not None
                                      else ""), f"{arch} {shape}", out,
                        ref, exact)["off_exact_kernel"])
                    errs.append(err)
                    del out, ref, xd, exact
                worst = max(worst, *errs)
                lq = quant.quantize_per_token(x[0])

                def library():
                    torch._scaled_mm(lq.data, w[0], scale_a=lq.scale,
                                     scale_b=sw, out_dtype=torch.bfloat16)

                refusal = _refusals({"_scaled_mm": library})["_scaled_mm"]
                fns = {"kernel": lambda: ops.fp8_gemm(x, w, sw)}
                if refusal is None:
                    fns["library"] = library
                iters = 5 if m > 100_000 else 50
                t = time_turns(fns, iters)
                eager = time_ms(fns["kernel"], iters)
                plain_ms = time_ms(lambda: ops.fp8_gemm_plain(x, w, sw),
                                   iters=3, warmup=1)
                b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * n * 2,
                                   2.0 * m * n * k, FP8_OPS_PER_S)
                splits, _ = ops.plan(1, m, n, k, ops.sm_count(dev))
                path = "prefill" if splits == 0 else f"decode, {splits} " \
                    f"splits"
                lib_txt = f"torch._scaled_mm {t['library']:.4f} ms" \
                    if refusal is None else f"torch._scaled_mm refused " \
                    f"({refusal})"
                print(f"[kernel] fp8_gemm recsys {arch} {layer} {shape} "
                      f"({path}): max|diff| {errs[0]:.3g}, static "
                      f"{errs[1]:.3g}; kernel {t['kernel']:.4f} ms device "
                      f"/ {eager:.4f} ms eager; plain {plain_ms:.4f} ms; "
                      f"{lib_txt}; bound {b_ms:.4f} ms ({b_by})")
                rows.append(dict(
                    model=f"{arch} {layer}", shape=shape, path=path,
                    ms=t["kernel"], eager_ms=eager, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by,
                    library_ms=t.get("library"), library_refusal=refusal,
                    max_abs_err=errs[0], max_abs_err_static=errs[1],
                    off_exact_kernel=shares[0], off_exact_static=shares[1]))
                del x, lq
    rec = records["fp8_gemm"]
    rec["max_abs_err"] = max(rec["max_abs_err"], worst)
    rec["recsys"] = rows


def _recsys_batch_tensors(batch, keys, dev):
    import torch
    return {k: torch.from_numpy(batch[k]).to(dev) for k in keys}


def _top_items(scores, cands, k):
    """The ``k`` distinct candidate items of highest score (stable: ties go
    to the lower item id)."""
    import numpy as np
    uniq, first = np.unique(cands, return_index=True)
    order = np.argsort(-scores[first], kind="stable")[:k]
    return set(uniq[order].tolist())


def card_vs_cpu_recsys(dev, arch: str):
    """Phase 3, ``recsys-<arch>``: the arch's ``reduced_config()``, the same
    raw params (drawn on the CPU, copied to the card) as bf16-compute and
    as fp8 weights (PTQ'd on each device): ``score`` of 512 users from
    ``SyntheticInteractions`` and ``retrieval_scores`` of the first against
    4096 candidates drawn from its 1000 items, on the card (kernel
    ``fp8_gemm``) and on the CPU (its plain version).  Scores within
    relative L2 ``RECSYS_SCORE_REL``; top-10 distinct items overlap >=
    ``RECSYS_TOP10``."""
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                              SyntheticInteractions)
    from repro_torch.models import recsys as recsys_model
    cfg = registry.get_arch(arch).reduced_config()
    raw = recsys_model.init_recsys(torch.Generator().manual_seed(5), cfg)
    raws = {"cpu": raw, dev: tree.map_with_path(lambda _, t: t.to(dev), raw)}
    batch = SyntheticInteractions(RecsysStreamConfig(
        cfg.n_items, cfg.n_sparse_fields, cfg.field_vocab, cfg.seq_len,
        RECSYS_P99, seed=3)).batch_at(0)
    cands = np.random.default_rng(3).integers(
        0, cfg.n_items, size=4096).astype(np.int32)
    one = {k: batch[k][:1] for k in ("hist_ids", "target_ids", "field_ids")}
    one["candidate_ids"] = cands
    wrappers = _wrappers()
    n_gemm = len(RECSYS_GEMMS[arch])
    for arm in ("bf16", "fp8"):
        got = {}
        for d in ("cpu", dev):
            params = quantize_params(raws[d], PAPER_POLICY) \
                if arm == "fp8" else raws[d]
            for w in wrappers.values():
                w.launches = 0
            s = recsys_model.score(params, _recsys_batch_tensors(
                batch, ("hist_ids", "target_ids", "field_ids"), d), cfg)
            r = recsys_model.retrieval_scores(
                params, _recsys_batch_tensors(one, one, d), cfg)
            launches = {n: w.launches for n, w in wrappers.items()}
            expect = dict.fromkeys(wrappers, 0)
            if arm == "fp8" and torch.device(d).type == "cuda":
                expect["fp8_gemm"] = 2 * n_gemm
            if launches != expect:
                fail(f"card-vs-CPU recsys-{arch} {arm} on {d}: launches "
                     f"{launches} != {expect}")
            got[d] = (s.float().cpu().numpy(), r.float().cpu().numpy())
        (cs, cr), (gs, gr) = got["cpu"], got[dev]
        if not (np.isfinite(gs).all() and np.isfinite(gr).all()):
            fail(f"card-vs-CPU recsys-{arch} {arm}: non-finite scores")
        rel = float(np.linalg.norm(gs - cs) / np.linalg.norm(cs))
        overlap = len(_top_items(gr, cands, 10)
                      & _top_items(cr, cands, 10)) / 10
        print(f"[card-vs-cpu] {cfg.name} recsys-{arch} {arm}: score of "
              f"{RECSYS_P99} users relative L2 {rel:.3e} (<= "
              f"{RECSYS_SCORE_REL}), max |diff| "
              f"{np.abs(gs - cs).max():.3e}; retrieval over 4096 candidates "
              f"top-10 overlap {overlap:.2f} (>= {RECSYS_TOP10}); fp8_gemm "
              f"launches on the card {2 * n_gemm if arm == 'fp8' else 0}")
        if not rel <= RECSYS_SCORE_REL:
            fail(f"card-vs-CPU recsys-{arch} {arm}: score rel. L2 {rel}")
        if overlap < RECSYS_TOP10:
            fail(f"card-vs-CPU recsys-{arch} {arm}: top-10 overlap "
                 f"{overlap}")


def recsys_path(dev):
    """Phase 4 (i): each recsys config at published widths and full tables
    (10 M item rows, 8 x 100 k field rows; two-tower's item table 10.24
    GB of f32), seed 0, bf16-compute (raw f32 weights) and fp8 (PTQ'd with
    the paper's policy; the tables shared) arms, inputs from
    ``SyntheticInteractions`` (Zipf-skewed histories and targets):
    ``serve_p99`` (512 users), ``serve_bulk`` (262144 users) and
    ``retrieval_cand`` (the first user against 1,000,000 uniform candidates,
    ``RECSYS_CHUNK`` a call).  Launch counts of each cell's first call must
    equal the layer arithmetic (fp8_gemm: the quantized layers a call, a
    chunk); then ``RECSYS_TIMED`` calls on the host clock ending in
    ``synchronize``.  Returns {"recsys/<arch>": fp8 arm launches}."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                              SyntheticInteractions)
    from repro_torch.models import recsys as recsys_model
    wrappers = _wrappers()
    out = {}
    for arch in RECSYS:
        cfg = registry.get_arch(arch).CONFIG
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        raw = recsys_model.init_recsys(
            torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
        arms = {"bf16": raw, "fp8": quantize_params(raw, PAPER_POLICY)}
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        table_gb = raw["item_embed"]["table"].nbytes / 1e9
        t0 = time.perf_counter()
        bulk_np = SyntheticInteractions(RecsysStreamConfig(
            cfg.n_items, cfg.n_sparse_fields, cfg.field_vocab, cfg.seq_len,
            RECSYS_BULK, seed=0)).batch_at(0)
        keys = ("hist_ids", "target_ids", "field_ids")
        bulk = _recsys_batch_tensors(bulk_np, keys, dev)
        data_s = time.perf_counter() - t0
        p99 = {k: v[:RECSYS_P99] for k, v in bulk.items()}
        ret = {k: v[:1] for k, v in bulk.items()}
        ret["candidate_ids"] = torch.randint(
            0, cfg.n_items, (RECSYS_CANDS,), dtype=torch.int32, device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        chunk = RECSYS_CHUNK[arch]
        n_gemm = len(RECSYS_GEMMS[arch])
        n_chunks = -(-RECSYS_CANDS // chunk)
        cells = {
            "serve_p99": (lambda p: recsys_model.score(p, p99, cfg),
                          RECSYS_P99, n_gemm),
            "serve_bulk": (lambda p: recsys_model.score(p, bulk, cfg),
                           RECSYS_BULK, n_gemm),
            "retrieval_cand": (lambda p: recsys_model.retrieval_scores_chunked(
                p, ret, cfg, chunk), RECSYS_CANDS, n_gemm * n_chunks)}
        print(f"[full-width] recsys {arch}: published widths, tables "
              f"{cfg.n_items} x {cfg.embed_dim} items ({table_gb:.2f} GB "
              f"f32) + {cfg.n_sparse_fields} x {cfg.field_vocab} field rows; "
              f"init + PTQ {init_s:.1f} s; SyntheticInteractions batch of "
              f"{RECSYS_BULK} on the host {data_s:.1f} s; retrieval chunk "
              f"{chunk} ({n_chunks} calls)")
        results, counted = {}, dict.fromkeys(wrappers, 0)
        for arm, params in arms.items():
            for cell, (fn, rows, n_launch) in cells.items():
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                for w in wrappers.values():
                    w.launches = 0
                res = fn(params)
                torch.cuda.synchronize()
                launches = {n: w.launches for n, w in wrappers.items()}
                expect = dict.fromkeys(wrappers, 0)
                expect["fp8_gemm"] = n_launch if arm == "fp8" else 0
                if launches != expect:
                    fail(f"recsys {arch} {arm} {cell}: launch counts "
                         f"{launches} != layer arithmetic {expect}")
                if arm == "fp8":
                    counted = {n: counted[n] + launches[n] for n in counted}
                if res.shape != (rows,) or not bool(
                        torch.isfinite(res).all()):
                    fail(f"recsys {arch} {arm} {cell}: output "
                         f"{tuple(res.shape)} not ({rows},) and finite")
                walls = []
                for _ in range(RECSYS_TIMED):
                    t0 = time.perf_counter()
                    fn(params)
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                p50 = float(np.median(walls))
                peak = torch.cuda.max_memory_allocated(dev)
                unit = "candidates" if cell == "retrieval_cand" else "rows"
                print(f"[full-width] recsys {arch} {arm} {cell}: p50 "
                      f"{p50 * 1e3:.2f} ms over {RECSYS_TIMED} calls (min "
                      f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}); "
                      f"{rows / p50:.0f} {unit}/s; peak device memory "
                      f"{peak / 2**30:.2f} GiB; launches {launches}")
                results[(arm, cell)] = res.float()
                del res
        a, b = results[("fp8", "serve_bulk")], results[("bf16", "serve_bulk")]
        rel = ((a - b).norm() / b.norm()).item()
        top = [set(results[(arm, "retrieval_cand")].topk(100).indices.tolist())
               for arm in ("fp8", "bf16")]
        print(f"[full-width] recsys {arch} fp8 vs bf16: serve_bulk score "
              f"relative L2 {rel:.4e}; retrieval top-100 overlap "
              f"{len(top[0] & top[1]) / 100:.2f}")

        def gathers():
            recsys_model._hist_vecs(raw, bulk["hist_ids"])
            recsys_model._target_vecs(raw, bulk["target_ids"])
            recsys_model._field_vecs(raw, bulk["field_ids"], cfg)

        g_ms = time_ms(gathers, iters=5, warmup=1)
        n_rows = RECSYS_BULK * (cfg.seq_len + 1 + cfg.n_sparse_fields)
        g_bound = n_rows * cfg.embed_dim * (4 + 2) / HBM_BYTES_PER_S * 1e3
        print(f"[full-width] recsys {arch} serve_bulk embedding gathers "
              f"(hist + target + fields, {n_rows} rows of {cfg.embed_dim}): "
              f"{g_ms:.3f} ms (eager, CUDA events) against a byte bound of "
              f"{g_bound:.3f} ms (f32 rows read, bf16 written, 3.35 TB/s)")
        out[f"recsys/{arch}"] = counted
        del arms, p99, ret, results
        if arch == "two-tower-retrieval":
            torch.cuda.empty_cache()
            bag_identity(dev, raw["item_embed"]["table"], bulk["hist_ids"])
        del raw, bulk
    return out


def segment_sum_times(tag, vals, seg, n):
    """ROADMAP C7: ``layers.embedding.segment_sum`` (a stable sort by
    segment, then ``torch.segment_reduce``) on the card: two calls must be
    bit-identical.  Timed (eager, CUDA events) against ``index_add_``,
    which adds with atomics in no fixed order, and against the
    deterministic ``index_add_`` that ``torch.use_deterministic_algorithms``
    selects (the other fixed-order candidate), on the same inputs."""
    import torch
    from repro_torch.layers.embedding import segment_sum

    def atomic():
        return vals.new_zeros((n, *vals.shape[1:])).index_add_(0, seg, vals)

    def deterministic():
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return atomic()
        finally:
            torch.use_deterministic_algorithms(prev)

    if not torch.equal(segment_sum(vals, seg, n), segment_sum(vals, seg, n)):
        fail(f"{tag}: two segment_sum calls differ")
    t = {name: time_ms(fn, iters=10, warmup=2) for name, fn in (
        ("segment_sum", lambda: segment_sum(vals, seg, n)),
        ("index_add_", atomic), ("deterministic index_add_", deterministic))}
    print(f"[C7] {tag}: {vals.shape[0]} rows of {vals[0].numel()} into {n} "
          f"segments: segment_sum {t['segment_sum']:.4f} ms (two calls "
          f"bit-identical), index_add_ {t['index_add_']:.4f} ms, "
          f"deterministic index_add_ {t['deterministic index_add_']:.4f} "
          f"ms (eager, CUDA events)")
    return t


def bag_identity(dev, table, hist_ids):
    """ROADMAP C7: ``embedding_bag`` ``sum`` and ``mean`` at two-tower's
    ``serve_bulk`` shape (262144 bags of the history's ids, rows of the
    10 M-row item table): two calls of each mode bit-identical, timed;
    then the segment sum alone against ``index_add_``."""
    import torch
    from repro_torch.layers import embedding
    b, l = hist_ids.shape
    ids = hist_ids.reshape(-1)
    seg = torch.arange(b, device=dev).repeat_interleave(l)
    for mode in ("sum", "mean"):
        def call():
            return embedding.embedding_bag({"table": table}, ids, seg,
                                           n_bags=b, mode=mode)
        if not torch.equal(call(), call()):
            fail(f"embedding_bag {mode} at serve_bulk: two calls differ")
        print(f"[C7] embedding_bag {mode}, {b} bags of {l} rows of "
              f"{table.shape[1]}: two calls bit-identical; "
              f"{time_ms(call, iters=3, warmup=1):.3f} ms a call (eager)")
    vals = embedding._gather_f32(table, ids)
    segment_sum_times("embedding_bag's segment sum at serve_bulk", vals, seg,
                      b)


EGNN_LG_DEGREE = 100   # random_geometric_graph's avg_degree argument for
#                        minibatch_lg's graph (it keeps ~0.41 of the draws)
EGNN_TIMED = 5
# equivariance bounds, relative to max |x| and max |h|: the coordinate
# weights are f32 tanh of a bf16 MLP output over rotation-invariant bf16
# inputs, so a bf16 rounding flip there moves an update by up to ~2**-8 of
# its |dx|
EGNN_EQUIV_X, EGNN_EQUIV_H = 2.0 ** -7, 2.0 ** -4
EGNN_CPU_REL = 2.0 ** -4     # card against CPU logits, of max |logit|


def egnn_path(dev):
    """Phase 4 (j): ``egnn`` at its published width (4 layers, d_hidden
    64), unquantized, seed 0: ``node_logits`` on ``full_graph_sm`` (2708
    nodes, the first 10556 edges of ``random_geometric_graph``, d_feat
    1433, ``graph_batch``) and on ``minibatch_lg`` (one ``NeighborSampler``
    batch, 1024 seeds, fanout (15, 10), padded to 169984 nodes, from a
    graph of 232,965 nodes with d_feat 602; its average degree cut to
    ~41 from reddit's 492: the batch's shapes do not depend on it), and
    ``graph_logits`` on ``molecule`` (128 graphs x 30 nodes x 64 edges,
    d_feat 16).  ms p50 over ``EGNN_TIMED`` calls (host clock ending in
    ``synchronize``), peak device memory, and the coordinates' E(3)
    equivariance error under a random rotation and translation on the
    card (bounds ``EGNN_EQUIV_X``, ``EGNN_EQUIV_H``); no kernel of the port
    runs (counts 0).  Returns {"egnn/<cell>": launches}."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data import graph
    from repro_torch.models import gnn
    mod = registry.get_arch("egnn")
    cfg, n_classes = mod.CONFIG, mod.N_CLASSES
    spec = mod.SHAPES
    t0 = time.perf_counter()
    sm = graph.random_geometric_graph(
        spec["full_graph_sm"].n_nodes, 10, spec["full_graph_sm"].d_feat,
        n_classes, seed=0)
    if len(sm.edges) < spec["full_graph_sm"].n_edges:
        fail(f"egnn full_graph_sm: {len(sm.edges)} edges drawn")
    sm = dataclasses.replace(
        sm, edges=sm.edges[:spec["full_graph_sm"].n_edges])
    lg_spec = spec["minibatch_lg"]
    big = graph.random_geometric_graph(lg_spec.n_nodes, EGNN_LG_DEGREE,
                                       lg_spec.d_feat, n_classes, seed=0)
    mol = spec["molecule"]
    cells = {
        "full_graph_sm": (graph.graph_batch(sm), 0),
        "minibatch_lg": (graph.NeighborSampler(
            big, lg_spec.fanout, lg_spec.batch_nodes, seed=0).sample_at(0),
            0),
        "molecule": (graph.molecule_batch(mol.global_batch, mol.n_nodes,
                                          mol.n_edges, mol.d_feat,
                                          n_classes, seed=0),
                     mol.global_batch)}
    print(f"[full-width] egnn: graphs built on the host in "
          f"{time.perf_counter() - t0:.1f} s; minibatch_lg's graph "
          f"{lg_spec.n_nodes} nodes, {len(big.edges)} edges (average degree "
          f"{len(big.edges) / lg_spec.n_nodes:.1f}; reddit's 492 cut)")
    wrappers = _wrappers()
    out = {}
    for cell, (batch_np, n_graphs) in cells.items():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_np.items()}
        params = gnn.init_egnn(torch.Generator(device=dev).manual_seed(0),
                               cfg, batch["feat"].shape[1], n_classes,
                               device=dev)
        if n_graphs:
            def fn():
                return gnn.graph_logits(params, batch, cfg, n_graphs)
        else:
            def fn():
                return gnn.node_logits(params, batch, cfg)
        for w in wrappers.values():
            w.launches = 0
        logits = fn()
        torch.cuda.synchronize()
        launches = {n: w.launches for n, w in wrappers.items()}
        rows = n_graphs or batch["feat"].shape[0]
        if any(launches.values()) or logits.shape != (rows, n_classes) \
                or not bool(torch.isfinite(logits).all()):
            fail(f"egnn {cell}: logits {tuple(logits.shape)}, launches "
                 f"{launches}")
        walls = []
        for _ in range(EGNN_TIMED):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        err_x, err_h = gnn.equivariance_error(
            params, batch, cfg, torch.Generator(device=dev).manual_seed(1))
        # the same input twice: bit-identical since C7 (segment sums in a
        # fixed order)
        h_a, x_a = gnn.egnn_forward(params, batch, cfg)
        h_b, x_b = gnn.egnn_forward(params, batch, cfg)
        if not (torch.equal(h_a, h_b) and torch.equal(x_a, x_b)):
            fail(f"egnn {cell}: two forwards of the same input differ")
        peak = torch.cuda.max_memory_allocated(dev)
        n_e = int(batch["edge_mask"].sum().item())
        cpu_txt = ""
        if cell != "minibatch_lg":    # the small graphs, on the CPU too
            cpu = {k: torch.from_numpy(v) for k, v in batch_np.items()}
            cparams = tree.map_with_path(lambda _, t: t.cpu(), params)
            ref = (gnn.graph_logits(cparams, cpu, cfg, n_graphs) if n_graphs
                   else gnn.node_logits(cparams, cpu, cfg))
            rel = ((logits.cpu() - ref).abs().max()
                   / ref.abs().max()).item()
            cpu_txt = f"; logits against the CPU's {rel:.3e} of max |logit| " \
                f"(<= {EGNN_CPU_REL})"
            if not rel <= EGNN_CPU_REL:
                fail(f"egnn {cell}: card logits {rel} off the CPU's")
        print(f"[full-width] egnn {cell}: {batch['feat'].shape[0]} nodes "
              f"(d_feat {batch['feat'].shape[1]}), {batch['edges'].shape[0]} "
              f"edges ({n_e} real), {'graph' if n_graphs else 'node'}_logits "
              f"p50 {np.median(walls) * 1e3:.2f} ms over {EGNN_TIMED} calls; "
              f"peak device memory {peak / 2**30:.3f} GiB; equivariance "
              f"error: coordinates {err_x:.3e} (<= {EGNN_EQUIV_X}), node "
              f"embeddings {err_h:.3e} (<= {EGNN_EQUIV_H}); the same input "
              f"twice: bit-identical{cpu_txt}")
        segment_sum_times(
            f"egnn {cell} message sum", torch.randn(
                (batch["edges"].shape[0], cfg.d_hidden), device=dev,
                generator=torch.Generator(device=dev).manual_seed(2)),
            batch["edges"][:, 1].long(), batch["feat"].shape[0])
        if not (err_x <= EGNN_EQUIV_X and err_h <= EGNN_EQUIV_H):
            fail(f"egnn {cell}: equivariance error {err_x}, {err_h}")
        out[f"egnn/{cell}"] = launches
        del batch, params, logits, h_a, h_b, x_a, x_b
    return out


# ---------------------------------------------------------------------------
# Phase 5: the paper's distribution analysis and the auto-tuner (N9a)
# ---------------------------------------------------------------------------

STATS_REQUESTS = 32              # the activation report's prefill group
SEARCH_STEPS = 2                 # phase 5's search: candidate evaluations


def _timed_report(dev, tag, fn):
    """``fn()`` -> a report, with its wall time (ending in ``synchronize``)
    and its peak device memory above what was allocated before it."""
    import torch
    from repro_torch.core import stats
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    report = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    print(f"[stats] {tag}: {report.summary()} -> "
          f"{stats.feasibility_verdict(report)}; {secs:.2f} s, peak "
          f"{peak:.2f} GiB above the model's")
    for row in report.csv_rows():
        print(f"[stats] csv {row}")
    if not report.per_tensor or not all(
            math.isfinite(v) for t in report.per_tensor
            for v in (t.variance, t.absmax, t.absp99)):
        fail(f"stats {tag}: empty report or non-finite statistics")
    return report


def distribution_phase(dev):
    """Phase 5 (N9a): the Fig.-1 report (``core.stats``) of the full-width
    OneRec-V2 params before PTQ (f32, as ``init_onerec`` makes them; every
    leaf's statistics on the card) and of the activations of one
    ``STATS_REQUESTS``-request forward through ``capture_taps``; the same
    for DIN at published widths with its 10 M-row tables (a ``serve_p99``
    batch of 512 users); ``feasibility_verdict`` for each.  Then one
    search (``make_eval_task("din")``, reduced, ``max_steps``
    ``SEARCH_STEPS``) whose artifact is loaded and deployed: PTQ with its
    policy, its static scales attached, one retrieval call whose launches
    of ``fp8_gemm`` and the int8 product equal its quantized leaves."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.core import autotune, ptq, stats
    from repro_torch.core.policy import load_policy_artifact
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                              SyntheticInteractions)
    from repro_torch.models import onerec, recsys
    from repro_torch.tree import leaves_with_path
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    params = onerec.init_onerec(0, CONFIG, device=dev)
    n_params = sum(t.numel() for _, t in leaves_with_path(params))
    _timed_report(dev, f"onerec-v2 weights ({n_params / 1e9:.2f} B "
                       f"params, f32)",
                  lambda: stats.collect_weight_stats(params, "onerec-v2"))
    g = torch.Generator(device=dev).manual_seed(2)
    batch = {"tokens": torch.randint(
        0, CONFIG.vocab_size, (STATS_REQUESTS,
                               CONFIG.history_len * CONFIG.n_codebooks),
        generator=g, device=dev, dtype=torch.int32),
        "profile": torch.randn((STATS_REQUESTS, onerec.PROFILE_DIM),
                               generator=g, device=dev)}

    def activations():
        with stats.capture_taps() as taps:
            onerec.forward(params, batch, CONFIG)
        return stats.collect_activation_stats(taps, "onerec-v2")

    act = _timed_report(dev, f"onerec-v2 activations ({STATS_REQUESTS} "
                                f"requests, forward + report)", activations)
    print(f"[stats] onerec-v2 activation taps: "
          f"{[t.name for t in act.per_tensor]}")
    del params, batch
    torch.cuda.empty_cache()
    cfg = registry.get_arch("din").CONFIG
    params = recsys.init_recsys(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    _timed_report(dev, f"din weights ({cfg.n_items} x {cfg.embed_dim} item "
                       f"table)",
                  lambda: stats.collect_weight_stats(params, "din"))
    bnp = SyntheticInteractions(RecsysStreamConfig(
        cfg.n_items, cfg.n_sparse_fields, cfg.field_vocab, cfg.seq_len,
        RECSYS_P99, seed=0)).batch_at(0)
    rb = _recsys_batch_tensors(bnp, ("hist_ids", "target_ids", "field_ids"),
                               dev)

    def din_activations():
        with stats.capture_taps() as taps:
            recsys.score(params, rb, cfg)
        return stats.collect_activation_stats(taps, "din")

    _timed_report(dev, f"din activations ({RECSYS_P99} users)",
                  din_activations)
    del params, rb
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    task = autotune.make_eval_task("din", seed=0, device=dev)
    res = autotune.autotune(task, target=0.6, max_steps=SEARCH_STEPS)
    path = os.path.join(ROOT, "build", "smoke_quant_policy_din.json")
    res.save(path, config="din")
    search_s = time.perf_counter() - t0
    art = load_policy_artifact(path)
    q = ptq.quantize_params(task.params, art["policy"])
    if art["act_scales"]:
        q = ptq.apply_static_act_scales(q, art["act_scales"])
    n_q = sum(isinstance(leaf, QuantizedTensor)
              for _, leaf in leaves_with_path(q))
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    dcfg = registry.get_arch("din").reduced_config()
    scores = recsys.retrieval_scores(q, task.calib_batches[0], dcfg)
    torch.cuda.synchronize()
    launched = wrappers["fp8_gemm"].launches + \
        wrappers["int8_matmul"].launches
    deployed = task.overlap(q)
    trace = [(t["action"], t["group"], round(t["overlap"], 4),
              t["accepted"]) for t in res.trace]
    print(f"[autotune] din (reduced, max_steps {SEARCH_STEPS}) on the card "
          f"in {search_s:.2f} s: trace {trace}; "
          f"overlap {res.overlap:.4f} (uniform "
          f"{res.uniform['overlap']:.4f}), bytes {res.bytes_quantized} "
          f"(uniform {res.uniform['bytes_quantized']}); artifact {path} "
          f"deployed: {n_q} quantized leaves, {launched} quantized "
          f"products a retrieval call, overlap {deployed:.4f}")
    if scores.shape != (64,) or not bool(torch.isfinite(scores).all()) \
            or launched != n_q or n_q == 0 or deployed < res.target:
        fail(f"autotune din: the artifact did not deploy ({n_q} leaves, "
             f"{launched} launches, overlap {deployed})")
    print(f"[stats] phase 5 took {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# Phase 6: gradients, AdamW and the single-card train step (N9b)
# ---------------------------------------------------------------------------

# (k): OneRec-V2 at full width, 6 of its 12 layers: f32 params, gradients
# and AdamW's f32 mu and nu hold 16 bytes a parameter, ~79.9 GB at 12
# layers (more than the card before any activation), ~40.2 GB at 6
TRAIN_LAYERS = 6
TRAIN_ROWS, TRAIN_STEPS = 32, 3   # train_b512's 384 tokens, 32 of 512 rows
TABLE1_STEPS = 120                # (l): tests/test_system.py's schedule
DIN_STEPS, DIN_ROWS = 100, 512    # (m): DIN reduced, its loss falls by
DIN_LOSS_DROP = 0.8               # ... at least this factor (last 10 / first
#                                   10 steps' mean)
DIN_HELD_OUT = 4096               # (m): users scored fp8 against bf16
# (n): card against CPU, one step: the loss (f32 sums in another order)
# and the gradients (bf16 products summed in f32 chunks on the card, the
# f32 product on the CPU), held as tests/_torch_parity.py holds the port
# against JAX: >= 2-D leaves one by one, 1-D leaves as one vector
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-4, 1e-2


def _timed_steps(dev, step, params, opt, batches, tag):
    """Run ``step`` over ``batches`` on the card: per step the wall time
    (ending in ``synchronize``), the device time (CUDA events around the
    step) and the host time (until the step returned, before the sync);
    the loss and the global gradient norm.  Returns (params, opt, losses,
    lines)."""
    import torch
    losses, lines = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loss, params, opt = step(params, opt, batch)
        end.record()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses.append(loss.item())
        gnorm = step.metrics["grad_norm"].item()
        lines.append(f"[train] {tag} step {i}: loss {losses[-1]:.6f}, "
                     f"global norm {gnorm:.6f}, wall {wall * 1e3:.1f} ms, "
                     f"device {start.elapsed_time(end):.1f} ms, host "
                     f"{host * 1e3:.1f} ms")
        if not math.isfinite(losses[-1]) or not math.isfinite(gnorm):
            fail(f"train {tag}: non-finite loss or norm at step {i}")
    return params, opt, losses, lines


def onerec_train_path(dev, cfg=None, rows=TRAIN_ROWS, seq=None):
    """(k) OneRec-V2 at full width, ``TRAIN_LAYERS`` layers: the
    ``train_b512`` bundle (``steps.onerec_bundle``: f32 params, AdamW with
    the JAX ``OPT_CFG``, ``remat``) at ``rows`` rows of its 384 tokens,
    ``TRAIN_STEPS`` steps; step times, losses, global norms and the peak
    device memory against 16 bytes a parameter.  Every kernel's launch
    count is zeroed before and read after: training runs raw products
    (cuBLAS), so all must stay 0.  A second run from the same seed must
    give bit-identical losses and params."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs.onerec_v2 import CONFIG, SHAPES
    from repro_torch.launch import steps
    cfg = cfg or dataclasses.replace(CONFIG, transformer=dataclasses.replace(
        CONFIG.transformer, n_layers=TRAIN_LAYERS))
    shape = dataclasses.replace(SHAPES["train_b512"], global_batch=rows,
                                seq_len=seq or SHAPES["train_b512"].seq_len)
    wrappers = _wrappers()
    runs = []
    for run in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        for w in wrappers.values():
            w.launches = 0
        b = steps.onerec_bundle("onerec-v2", cfg, shape, fp8=False, seed=0,
                                device=dev)
        params, opt, batch = b.args
        n_params = sum(t.numel() for _, t in tree.leaves_with_path(params))
        params, opt, losses, lines = _timed_steps(
            dev, b.fn, params, opt, [batch] * TRAIN_STEPS,
            f"onerec-v2 x{cfg.transformer.n_layers} run {run}")
        peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
        launches = {n: w.launches for n, w in wrappers.items()}
        for line in lines:
            print(line)
        state = n_params * 16 / 2**30
        print(f"[train] onerec-v2 x{cfg.transformer.n_layers} run {run}: "
              f"{n_params / 1e9:.4f} B params, {rows} x {shape.seq_len} "
              f"tokens, remat {cfg.transformer.remat}; peak device memory "
              f"{peak:.2f} GiB against {state:.2f} GiB of params, "
              f"gradients, mu and nu (16 B a param): "
              f"{peak - state:.2f} GiB of activations and temporaries; "
              f"launches {launches}")
        if any(launches.values()):
            fail(f"train: the raw train step launched a kernel {launches}")
        del opt, batch, b
        runs.append((losses, params))
    (l0, p0), (l1, p1) = runs
    same = l0 == l1 and all(torch.equal(a, p1_leaf) for (_, a), (_, p1_leaf)
                            in zip(tree.leaves_with_path(p0),
                                   tree.leaves_with_path(p1)))
    print(f"[train] onerec-v2 two runs of {TRAIN_STEPS} steps from seed 0: "
          f"losses {l0} / {l1}; params bit-identical: {same}")
    if not same:
        fail("train: two runs from one seed differ (run-to-run identity)")
    del runs, p0, p1
    torch.cuda.empty_cache()


def table1_path(dev, steps_n=TABLE1_STEPS):
    """(l) The Table-1 analogue on the card, ``tests/test_system.py``'s
    config, schedule and bounds: OneRec-mini trained ``steps_n`` steps (lr
    2e-3, batch 16, ``SemanticIDStream``), its Fig.-1 weight report, BF16
    and FP8 serving through the port's engine (first-codebook hit rate of
    4 x 16 held-out requests) in the contiguous layout, the JAX engine's
    default (kernel ``paged_decode`` takes head_dim 64, 128 or 256, and
    OneRec-mini's is 16), PTQ coverage."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import stats
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.data.onerec_data import (OneRecStreamConfig,
                                              SemanticIDStream)
    from repro_torch.launch.steps import train_step
    from repro_torch.models import onerec
    from repro_torch.optim import OptimizerConfig, adamw_init
    from repro_torch.serving import EngineConfig, ServingEngine
    t0 = time.perf_counter()
    cfg = get_arch("onerec-v2").reduced_config()
    stream = SemanticIDStream(OneRecStreamConfig(
        codebook_size=cfg.transformer.vocab_size - 64,
        history_len=cfg.history_len, global_batch=16, n_interests=8))
    params = onerec.init_onerec(0, cfg, device=dev)
    step = train_step(lambda p, b: onerec.train_loss(p, b, cfg),
                      OptimizerConfig(lr=2e-3, warmup_steps=5,
                                      total_steps=steps_n))
    batches = ({k: torch.from_numpy(v).to(dev)
                for k, v in stream.batch_at(i).items() if k != "target"}
               for i in range(steps_n))
    params, _, losses, _ = _timed_steps(dev, step, params, adamw_init(params),
                                        batches, "onerec-mini")
    train_s = time.perf_counter() - t0
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    rep = stats.collect_weight_stats(params, "onerec-mini")

    def hitrate(use_fp8):
        eng = ServingEngine(params, cfg, EngineConfig(
            batch_size=16, use_fp8=use_fp8, paged=False,
            fused_decode="off"), device=dev)
        hits = total = 0
        for i in range(100, 104):
            r = stream.serve_request_at(i)
            out = eng.generate_batch(r["tokens"], r["profile"])
            hits += int((out[:, 0] == r["target"][:, 0]).sum())
            total += out.shape[0]
        return hits / total

    h_bf16, h_fp8 = hitrate(False), hitrate(True)
    _, ptq = quantize_params(params, PAPER_POLICY, with_report=True,
                             compute_errors=True)
    print(f"[train] table-1 onerec-mini on the card: {steps_n} steps in "
          f"{train_s:.2f} s, loss first-10 mean {first:.4f} -> last-10 mean "
          f"{last:.4f} ({last / first:.3f}); weights mean variance "
          f"{rep.mean_variance:.4e}, mean absmax {rep.mean_absmax:.4f}; "
          f"first-codebook hit rate bf16 {h_bf16:.4f} fp8 {h_fp8:.4f}; PTQ "
          f"{ptq.n_quantized} leaves, mean rel err {ptq.mean_rel_err:.4f}, "
          f"bytes {ptq.bytes_after / ptq.bytes_before:.4f} of the "
          f"original")
    if not (last < 0.7 * first and rep.mean_variance < 1.0
            and rep.mean_absmax < 50.0 and h_bf16 > 0.2
            and abs(h_fp8 - h_bf16) <= 0.11 and ptq.n_quantized >= 7
            and ptq.mean_rel_err < 0.05
            and ptq.bytes_after < 0.35 * ptq.bytes_before):
        fail("train: the Table-1 analogue missed tests/test_system.py's "
             "bounds")


def din_trained_fp8(dev, steps_n=DIN_STEPS):
    """(m) DIN (reduced) trained ``steps_n`` steps on ``SyntheticInteractions``
    (batch ``DIN_ROWS``, lr 1e-2); its loss must fall below
    ``DIN_LOSS_DROP`` of its start.  Then the FP8 (PTQ'd with the paper's
    policy) against BF16-compute score deviation, relative L2 over
    ``DIN_HELD_OUT`` held-out users (phase 4 (i)'s measure), of the
    trained params and of the same params at init."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                              SyntheticInteractions)
    from repro_torch.launch.steps import train_step
    from repro_torch.models import recsys
    from repro_torch.optim import OptimizerConfig, adamw_init
    cfg = registry.get_arch("din").reduced_config()

    def stream(rows, seed):
        return SyntheticInteractions(RecsysStreamConfig(
            cfg.n_items, cfg.n_sparse_fields, cfg.field_vocab, cfg.seq_len,
            rows, seed=seed))

    held = {k: torch.from_numpy(v).to(dev)
            for k, v in stream(DIN_HELD_OUT, 1).batch_at(0).items()}

    def deviation(p):
        a = recsys.score(quantize_params(p, PAPER_POLICY), held, cfg).float()
        b = recsys.score(p, held, cfg).float()
        return ((a - b).norm() / b.norm()).item()

    params = recsys.init_recsys(torch.Generator(device=dev).manual_seed(0),
                                cfg, device=dev)
    at_init = deviation(params)
    train = stream(DIN_ROWS, 0)
    step = train_step(lambda p, b: recsys.train_loss(p, b, cfg),
                      OptimizerConfig(lr=1e-2, warmup_steps=10,
                                      total_steps=steps_n))
    batches = ({k: torch.from_numpy(v).to(dev)
                for k, v in train.batch_at(i).items()}
               for i in range(steps_n))
    t0 = time.perf_counter()
    params, _, losses, _ = _timed_steps(dev, step, params, adamw_init(params),
                                        batches, "din")
    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    trained = deviation(params)
    print(f"[train] din (reduced) {steps_n} steps x {DIN_ROWS} users in "
          f"{time.perf_counter() - t0:.2f} s: loss first-10 mean "
          f"{first:.4f} -> last-10 mean {last:.4f} ({last / first:.3f}, "
          f"bound {DIN_LOSS_DROP}); fp8 against bf16 score relative L2 over "
          f"{DIN_HELD_OUT} held-out users: trained {trained:.4e}, at init "
          f"{at_init:.4e}")
    if not last < DIN_LOSS_DROP * first or not math.isfinite(trained):
        fail("train: DIN's loss did not fall by the stated margin")


def _grad_gap(card, cpu):
    """(loss rel. difference, worst >= 2-D leaf and its rel. L2, rel. L2 of
    the 1-D leaves as one vector) of the card's (loss, grads) against the
    CPU's."""
    from repro_torch import tree
    (cl, cg), (hl, hg) = card, cpu
    loss_rel = abs(cl.item() - hl.item()) / abs(hl.item())
    got = dict(tree.leaves_with_path(cg))
    worst, worst_rel, num, den = "", 0.0, 0.0, 0.0
    for path, ref in tree.leaves_with_path(hg):
        ref = ref.double()
        err = (got[path].double().cpu() - ref).norm().item()
        if ref.ndim >= 2:
            rel = err / max(ref.norm().item(), 1e-30)
            if rel >= worst_rel:
                worst, worst_rel = path, rel
        else:
            num, den = num + err ** 2, den + ref.norm().item() ** 2
    return loss_rel, worst, worst_rel, math.sqrt(num / max(den, 1e-60))


def train_card_vs_cpu(dev):
    """(n) One gradient of reduced OneRec-V2 and of a reduced MoE LM with
    the load-balance loss on (qwen2-moe, ``aux_loss_weight`` 0.05), on the
    card and on the CPU from the same weights and batch; then one AdamW
    step on each from the CPU's gradients."""
    import dataclasses
    import torch
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.data.onerec_data import (OneRecStreamConfig,
                                              SemanticIDStream)
    from repro_torch.models import onerec
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
    ocfg = registry.get_arch("onerec-v2").reduced_config()
    b = SemanticIDStream(OneRecStreamConfig(
        codebook_size=ocfg.vocab_size - 64, history_len=ocfg.history_len,
        global_batch=4, n_interests=8)).batch_at(0)
    obatch = {k: torch.from_numpy(b[k]) for k in ("tokens", "profile",
                                                  "labels")}
    lcfg = dataclasses.replace(
        registry.get_arch("qwen2-moe-a2.7b").reduced_config(),
        aux_loss_weight=0.05)
    tok = torch.randint(0, lcfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    cases = {
        "onerec-v2 reduced": (onerec.init_onerec(0, ocfg, device="cpu"),
                              obatch, lambda p, x: onerec.train_loss(
                                  p, x, ocfg)),
        "qwen2-moe reduced, aux 0.05": (
            tfm.init_transformer(torch.Generator().manual_seed(0), lcfg),
            {"tokens": tok, "labels": tok},
            lambda p, x: tfm.train_loss(p, x, lcfg))}
    for name, (params, batch, loss_fn) in cases.items():
        cpu = tree.value_and_grad(loss_fn, params, batch)
        on_card = tree.map_with_path(lambda _, t: t.to(dev), params)
        card = tree.value_and_grad(loss_fn, on_card, {
            k: v.to(dev) for k, v in batch.items()})
        loss_rel, worst, worst_rel, rel_1d = _grad_gap(card, cpu)
        opt_cfg = OptimizerConfig(clip_norm=0.0)
        p_cpu, _, _ = adamw_update(params, tree.map_with_path(
            lambda _, t: t.clone(), cpu[1]), adamw_init(params), opt_cfg)
        p_card, _, _ = adamw_update(on_card, tree.map_with_path(
            lambda _, t: t.to(dev), cpu[1]), adamw_init(on_card), opt_cfg)
        ulps = max(int((a.cpu().view(torch.int32).long()
                        - c.view(torch.int32).long()).abs().max())
                   for (_, a), (_, c) in zip(tree.leaves_with_path(p_card),
                                             tree.leaves_with_path(p_cpu)))
        print(f"[train] card vs cpu, {name}: loss {card[0].item():.6f} / "
              f"{cpu[0].item():.6f} (rel {loss_rel:.3e}); worst gradient "
              f"leaf {worst} rel L2 {worst_rel:.3e}, 1-D leaves "
              f"{rel_1d:.3e}; AdamW on equal gradients: params within "
              f"{ulps} f32 ulp(s)")
        if loss_rel > TRAIN_LOSS_REL or worst_rel > TRAIN_GRAD_REL \
                or rel_1d > TRAIN_GRAD_REL or ulps > 1:
            fail(f"train: card vs cpu {name} beyond its bounds")


def training_phase(dev):
    """Phase 6 (N9b): (k), (l), (m), (n)."""
    t0 = time.perf_counter()
    onerec_train_path(dev)
    table1_path(dev)
    din_trained_fp8(dev)
    train_card_vs_cpu(dev)
    print(f"[train] phase 6 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 7: the training runner and its checkpoints (N9c)
# ---------------------------------------------------------------------------

# (o): OneRec-V2 at full width, CKPT_LAYERS of its 12 layers: params, mu
# and nu hold 12 bytes a parameter, ~5.37 GB a checkpoint at one layer
CKPT_LAYERS = 1
CKPT_ROWS, CKPT_STEPS, CKPT_EVERY, CKPT_KEEP = 32, 8, 3, 2
CKPT_FAULTS = {4: 1, 7: 1}
CKPT_PEAK_SLACK = 2 ** 30        # run A's peak at most run B's plus this
CKPT_DIR = os.path.join(ROOT, "build", "phase7")
# (q): the launcher's runs, each held to a falling loss (last 10 steps'
# mean below the first 10's)
LAUNCH_RUNS = (("onerec-v2", ["--batch", "32", "--lr", "3e-3",
                              "--compress-grads"]),
               ("din", ["--batch", "64", "--lr", "3e-3"]))
LAUNCH_STEPS, LAUNCH_EVERY = 40, 10


def _state_bytes(state) -> int:
    from repro_torch.checkpoint import store
    return sum(t.numel() * t.element_size()
               for t in store._flatten(state)[1])


def _check_disk(directory: str, need: int, tag: str) -> None:
    """Fail before writing unless the disk holds twice ``need`` bytes."""
    os.makedirs(directory, exist_ok=True)
    free = shutil.disk_usage(directory).free
    print(f"[ckpt] {tag}: {free / 1e9:.2f} GB free for {need / 1e9:.2f} GB "
          f"of checkpoints")
    if free < 2 * need:
        fail(f"{tag}: {free / 1e9:.2f} GB free under {directory}, twice "
             f"{need / 1e9:.2f} GB needed")


def _zero(wrappers) -> None:
    for w in wrappers.values():
        w.launches = 0


def _launched(wrappers, tag: str) -> dict:
    launches = {n: w.launches for n, w in wrappers.items()}
    if any(launches.values()):
        fail(f"{tag}: training launched a kernel {launches}")
    return launches


def restart_path(dev, cfg=None, rows=CKPT_ROWS):
    """(o): run A with ``CKPT_FAULTS`` injected, run B clean, each through
    ``FaultTolerantRunner`` from seed 0 with a fresh checkpoint directory.
    Returns the measured rates for the extrapolation."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import tree
    from repro_torch.checkpoint import store
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.distributed import FaultTolerantRunner, RunnerConfig
    from repro_torch.launch import steps, train
    cfg = cfg or dataclasses.replace(CONFIG, transformer=dataclasses.replace(
        CONFIG.transformer, n_layers=CKPT_LAYERS))
    wrappers = _wrappers()
    runs = {}
    for name, faults in (("A", CKPT_FAULTS), ("B", None)):
        d = os.path.join(CKPT_DIR, name)
        shutil.rmtree(d, ignore_errors=True)
        init, step_fn, batch_fn, _ = train.training_for(
            "onerec", cfg, batch=rows, seq=0, compress_grads=False,
            opt_cfg=steps.OPT_CFG, seed=0, device=dev)
        seen = []

        def batch_at(i, batch_fn=batch_fn, seen=seen):
            seen.append(i)
            return batch_fn(i)

        def init_checked(init=init, d=d, name=name):
            state = init()
            _check_disk(d, _state_bytes(state) * (CKPT_KEEP + 1),
                        f"(o) run {name}")
            return state

        runner = FaultTolerantRunner(
            step_fn, batch_at, init_checked,
            RunnerConfig(total_steps=CKPT_STEPS, ckpt_every=CKPT_EVERY,
                         ckpt_dir=d, keep=CKPT_KEEP), fail_at=faults)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        _zero(wrappers)
        t0 = time.perf_counter()
        state, summary = runner.run()
        wall = time.perf_counter() - t0
        launches = _launched(wrappers, f"(o) run {name}")
        peak = torch.cuda.max_memory_allocated(dev) - base
        losses = [(i, m["loss"].item()) for i, m in zip(seen,
                                                        summary["metrics"])]
        ckpts = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        verified = [store.verify_checkpoint(os.path.join(d, x))
                    for x in ckpts]
        sizes = {p: t.numel()
                 for p, t in tree.leaves_with_path(state["params"])}
        n_params = sum(sizes.values())
        in_layers = sum(n for p, n in sizes.items() if "/stacks/" in p)
        runs[name] = dict(
            host=store.host_copy(state), summary=summary, losses=losses,
            timings=list(runner.checkpointer.timings), peak=peak,
            wall=wall, n_params=n_params, in_layers=in_layers,
            bytes=_state_bytes(state),
            restores=[e for e in summary["events"]
                      if e["kind"] == "restore"],
            step_times=list(runner.step_times))
        r = runs[name]
        print(f"[ckpt] (o) run {name}: {cfg.name} x"
              f"{cfg.transformer.n_layers}, {n_params / 1e9:.4f} B params, "
              f"{rows} x {cfg.history_len * cfg.n_codebooks + cfg.n_codebooks}"
              f" tokens, {CKPT_STEPS} steps, faults {faults}: "
              f"{summary['restarts']} restarts, {len(r['restores'])} "
              f"restores, {len(summary['metrics'])} steps taken in "
              f"{wall:.1f} s; checkpoints {ckpts} verified {verified}; "
              f"peak device memory {peak / 2**30:.2f} GiB; launches "
              f"{launches}")
        print(f"[ckpt] (o) run {name}: step times (s) "
              f"{[round(t, 4) for t in r['step_times']]}; losses {losses}")
        if not all(verified) or len(ckpts) != CKPT_KEEP:
            fail(f"(o) run {name}: checkpoints {ckpts} verified {verified}")
        del state, runner, summary
        torch.cuda.empty_cache()
    a, b = runs["A"], runs["B"]
    want = sum(CKPT_FAULTS.values())
    if a["summary"]["restarts"] != want or b["summary"]["restarts"] != 0:
        fail(f"(o): restarts {a['summary']['restarts']} / "
             f"{b['summary']['restarts']}, want {want} / 0")
    clean = dict(b["losses"])
    if sorted(clean) != list(range(CKPT_STEPS)) or any(
            clean[i] != loss for i, loss in a["losses"]):
        fail(f"(o): losses differ: {a['losses']} / {b['losses']}")
    same = [(p, np.array_equal(store._bytes(x), store._bytes(y)))
            for (p, x), (_, y) in zip(tree.leaves_with_path(a["host"]),
                                      tree.leaves_with_path(b["host"]))]
    bad = [p for p, ok in same if not ok]
    print(f"[ckpt] (o) final params, mu, nu and step of runs A and B "
          f"bit-identical: {not bad} ({len(same)} leaves); peak A / B "
          f"{a['peak'] / 2**30:.2f} / {b['peak'] / 2**30:.2f} GiB")
    if bad:
        fail(f"(o): runs A and B differ in {bad[:5]}")
    if a["peak"] > b["peak"] + CKPT_PEAK_SLACK:
        fail(f"(o): run A's peak {a['peak'] / 2**30:.2f} GiB exceeds run "
             f"B's {b['peak'] / 2**30:.2f} GiB by more than "
             f"{CKPT_PEAK_SLACK / 2**30:.0f} GiB (a second state?)")
    timings = a["timings"] + b["timings"]
    nbytes = timings[0]["bytes"]
    d2h = sorted(t["d2h_s"] for t in timings)
    block = sorted(t["block_s"] for t in timings)
    write = sorted(t["write_s"] for t in timings)
    hsh = sorted(t["hash_s"] for t in timings)
    restore = sorted(e["seconds"] for e in a["restores"])
    steady = sorted(a["step_times"][1:] + b["step_times"][1:])
    med = lambda xs: xs[len(xs) // 2]                   # noqa: E731
    print(f"[ckpt] (o) a checkpoint: {nbytes} bytes ({nbytes / 1e9:.3f} "
          f"GB, {len(timings)} written); save holds the training thread "
          f"{d2h[0]:.3f}-{d2h[-1]:.3f} s for the copy to host memory "
          f"({nbytes / med(d2h) / 1e9:.2f} GB/s), {block[0]:.3f}-"
          f"{block[-1]:.3f} s in all (queue back-pressure included); the "
          f"writer's npz write {write[0]:.3f}-{write[-1]:.3f} s "
          f"({nbytes / med(write) / 1e9:.2f} GB/s), hash {hsh[0]:.3f}-"
          f"{hsh[-1]:.3f} s ({nbytes / med(hsh) / 1e9:.2f} GB/s); restore "
          f"(verify, read, hash, copy to the card) {restore} s; steps "
          f"after the first {steady[0] * 1e3:.1f}-{steady[-1] * 1e3:.1f} ms"
          f" (median {med(steady) * 1e3:.1f})")
    # the state's bytes at L layers: 12 B a parameter (params, mu, nu);
    # a layer's parameters are the stacks' over CKPT_LAYERS
    per_layer = a["in_layers"] / cfg.transformer.n_layers
    rest = a["n_params"] - a["in_layers"]
    for layers in (6, 12):
        n = per_layer * layers + rest
        gb = 12 * n / 1e9
        print(f"[ckpt] (o) extrapolated at {layers} layers: {n / 1e9:.3f} "
              f"B params, {gb:.2f} GB a checkpoint; save holds the thread "
              f"~{gb / (nbytes / med(d2h) / 1e9):.1f} s, write + hash "
              f"~{gb / (nbytes / med(write) / 1e9) + gb / (nbytes / med(hsh) / 1e9):.1f}"
              f" s, restore ~{gb / nbytes * 1e9 * med(restore):.1f} s")
    return runs


def deployment_path(dev, paged_outs, paged_launches, cfg=None,
                    requests=64, batch=32):
    """(p): (a)'s params (``init_onerec(0)``), PTQ'd with the paper's
    policy, saved as a checkpoint and loaded into a fresh tree; the loaded
    tree serves (a)'s requests as (a) serves them."""
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.models.onerec import init_onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import build_requests
    import numpy as np
    cfg = cfg or CONFIG
    d = os.path.join(CKPT_DIR, "deploy")
    shutil.rmtree(d, ignore_errors=True)
    params = quantize_params(init_onerec(0, cfg, device=dev), PAPER_POLICY)
    torch.cuda.empty_cache()
    nbytes = _state_bytes(params)
    _check_disk(d, nbytes, "(p)")
    timing = {}
    t0 = time.perf_counter()
    path = store.save_checkpoint(d, 0, params, timing=timing)
    save_s = time.perf_counter() - t0
    with open(os.path.join(path, store.MANIFEST)) as f:
        saved_hash = json.load(f)["hash"]
    t0 = time.perf_counter()
    loaded, manifest = store.load_checkpoint(path, params)
    torch.cuda.synchronize(dev)
    load_s = time.perf_counter() - t0
    paths, ours = store._flatten(params)
    theirs = store._flatten(loaded)[1]
    raw = lambda t: t.view(torch.uint8) if t.element_size() == 1 \
        else t                                           # noqa: E731
    k_major = sum(t.ndim >= 2 and t.stride(-2) == 1 for t in theirs)
    differ = [p for p, x, y in zip(paths, ours, theirs)
              if x.stride() != y.stride() or not torch.equal(raw(x), raw(y))]
    again = store._content_hash([store._host(t, copy=False)
                                 for t in theirs])
    fp8 = sum(t.numel() for t in theirs if t.dtype == torch.float8_e4m3fn)
    print(f"[ckpt] (p) FP8 deployment checkpoint of {cfg.name}: {nbytes} "
          f"bytes ({nbytes / 1e9:.3f} GB: {fp8 / 1e9:.3f} GB of e4m3 "
          f"payloads), {len(paths)} leaves; save {save_s:.2f} s (copy "
          f"{timing['host_s']:.2f}, write {timing['write_s']:.2f}, hash "
          f"{timing['hash_s']:.2f}), load {load_s:.2f} s; {k_major} "
          f"K-major payloads laid out again; leaves with other bytes or "
          f"layout: {differ[:5]}; hash saved / manifest / loaded tree "
          f"equal: {saved_hash == manifest['hash'] == again}")
    if differ or not saved_hash == manifest["hash"] == again:
        fail("(p): the loaded deployment tree differs from the saved one")
    del params, ours
    torch.cuda.empty_cache()
    n_layers = cfg.transformer.n_layers

    def serve():
        engine = ServingEngine(loaded, cfg, EngineConfig(
            batch_size=batch, kv_dtype="float8_e4m3fn"), device=dev)
        return engine.serve_requests(build_requests(cfg, requests, batch, 0,
                                                    True))

    def expect(st):
        forwards = int(st["prefill_calls"] + st["decode_steps"])
        return {"fp8_gemm": forwards * 4 * n_layers,
                "fp8_grouped_gemm": forwards * 3 * n_layers,
                "int8_matmul": 0, "radix_topk": 0, "batch_attention": 0,
                "paged_decode": int(st["decode_steps"]) * n_layers}

    outs, launches, _, _ = _drive(dev, "deployment", serve, expect)
    same = [bool(np.array_equal(x, y)) for x, y in zip(outs, paged_outs)]
    print(f"[ckpt] (p) served from the loaded checkpoint: items identical "
          f"to (a)'s on {sum(same)} of {len(same)} requests; launches "
          f"{launches} against (a)'s {paged_launches}")
    if not all(same) or len(same) != len(paged_outs):
        fail("(p): the deployment checkpoint's items differ from (a)'s")
    if launches != paged_launches:
        fail(f"(p): launches {launches} != (a)'s {paged_launches}")
    shutil.rmtree(d, ignore_errors=True)
    return launches


def launcher_path(dev, steps_n=LAUNCH_STEPS, every=LAUNCH_EVERY):
    """(q): ``launch.train``'s ``main`` twice per run of ``LAUNCH_RUNS``,
    the second resuming the first's last step; then ``ef_compress`` on
    the card against the CPU."""
    import numpy as np
    import torch
    from repro_torch.distributed import ef_compress, ef_init
    from repro_torch.launch import train
    wrappers = _wrappers()
    for arch, extra in LAUNCH_RUNS:
        d = os.path.join(CKPT_DIR, arch)
        shutil.rmtree(d, ignore_errors=True)
        argv = ["--arch", arch, "--reduced", "--steps", str(steps_n),
                "--ckpt-every", str(every), "--ckpt-dir", d, "--device",
                str(dev), *extra]
        _zero(wrappers)
        t0 = time.perf_counter()
        _, summary = train.main(argv)
        wall = time.perf_counter() - t0
        _, again = train.main(argv)
        _launched(wrappers, f"(q) {arch}")
        losses = [float(m["loss"]) for m in summary["metrics"]]
        first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        resumed = [e["step"] for e in again["events"]
                   if e["kind"] == "restore"]
        print(f"[ckpt] (q) {' '.join(argv)}: {len(losses)} steps in "
              f"{wall:.1f} s, loss first 10 {first:.4f} -> last 10 "
              f"{last:.4f}; the second run restored step {resumed} and took "
              f"{len(again['metrics'])} steps")
        if len(losses) != steps_n or not last < first:
            fail(f"(q) {arch}: the loss did not fall ({first} -> {last})")
        if again["metrics"] or resumed != [steps_n]:
            fail(f"(q) {arch}: the second run did not resume step {steps_n}")
        shutil.rmtree(d, ignore_errors=True)
    rng = np.random.default_rng(0)
    grads = [{"w": torch.from_numpy((rng.normal(size=(2048, 512)) * 1e-3)
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.normal(size=(4096,))
                                    .astype(np.float32)),
              "z": torch.zeros(64, 64)} for _ in range(3)]
    res = {"cpu": ef_init(grads[0]), "card": ef_init(
        {k: v.to(dev) for k, v in grads[0].items()})}
    worst = 0
    for g in grads:
        ghat_c, res["cpu"] = ef_compress(g, res["cpu"])
        ghat_g, res["card"] = ef_compress({k: v.to(dev) for k, v in
                                           g.items()}, res["card"])
        for k in g:
            for x, y in ((ghat_c[k], ghat_g[k]), (res["cpu"][k],
                                                  res["card"][k])):
                ulps = (x.view(torch.int32).to(torch.int64)
                        - y.cpu().view(torch.int32).to(torch.int64)).abs()
                worst = max(worst, int(ulps.max()))
    print(f"[ckpt] (q) ef_compress card vs CPU over 3 steps of equal f32 "
          f"gradients (a zero leaf among them): ghat and residuals {worst} "
          f"ulps apart")
    if worst:
        fail(f"(q): ef_compress on the card is {worst} ulps off the CPU")


def checkpoint_phase(dev, paged_outs, paged_launches):
    """Phase 7 (N9c): (o), (p), (q)."""
    t0 = time.perf_counter()
    restart_path(dev)
    deployment_path(dev, paged_outs, paged_launches)
    launcher_path(dev)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print(f"[ckpt] phase 7 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 8: expert parallelism, compressed_psum and elastic restore (N9d)
# ---------------------------------------------------------------------------

EP_WORLD = 4
EP_MESHES = ((1, 4), (2, 2))     # (data, model)
EP_TIMEOUT_S = 120               # a rank waiting longer in a collective fails
ELASTIC_LAYERS = 2               # (t): full width, depth cut to fit the phase
ELASTIC_ROWS = 32                # (t): fp8_gemm rows on a q_proj shard
EP_DIR = os.path.join(ROOT, "build", "phase8")
# (s): full-width OneRec-V2's embedding table and one layer's attention
PSUM_SHAPES = {"embed": (8256, 2048), "q_proj": (2048, 2048),
               "k_proj": (2048, 512), "v_proj": (2048, 512),
               "o_proj": (2048, 2048)}
PSUM_CASES = (((1, 4), "model"), ((2, 2), "data"))


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bf16_ulps(a, b):
    """Largest |a - b| in bf16 ulps of the larger magnitude."""
    import torch
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return ((a - b).abs() / ulp).max().item()


def _psum_tree(rank: int, dev):
    """(grads, residuals) of rank ``rank``, from its own seed."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1000 + rank)
    grads = {k: torch.randn(s, generator=g, device=dev) * 1e-2
             for k, s in PSUM_SHAPES.items()}
    res = {k: torch.randn(s, generator=g, device=dev) * 1e-5
           for k, s in PSUM_SHAPES.items()}
    return grads, res


def _shard_of(t, placements, mesh):
    """The slice of the global ``t`` that a rank at ``mesh``'s coordinate
    holds under ``placements`` (tensor dims split in mesh order)."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    for dim in range(t.ndim):
        idx, count = 0, 1
        for i, pl in enumerate(placements):
            if isinstance(pl, Shard) and pl.dim == dim:
                idx, count = idx * mesh.size(i) + coord[i], \
                    count * mesh.size(i)
        n = t.shape[dim] // count
        t = t.narrow(dim, idx * n, n)
    return t


def _u8(t):
    import torch
    return t.view(torch.uint8) if t.element_size() == 1 else t


def ep_serving(dev, rank, cfg, batch, out):
    """(r) in one rank: for each mesh, params from seed 0 made layer by
    layer, PTQ'd and cut to the rank's experts as they are made; the
    rank's rows prefilled (checked, then timed), once more with every
    ``all_reduce`` timed apart, then ``generate_items``."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.layers import moe
    from repro_torch.models import onerec
    from repro_torch.models import transformer as tfm
    wrappers = _wrappers()
    e_pad = tfm.moe_spec_for(cfg.transformer).n_experts_padded
    for n_data, n_model in EP_MESHES:
        tag = f"({n_data}, {n_model})"
        mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                        device_type=dev.type)
        d, m = mesh.get_coordinate()
        e_local = e_pad // n_model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = onerec.init_onerec(0, cfg, device=dev, transform=(
            lambda path, t: moe.keep_experts(quantize_params(
                t, PAPER_POLICY, prefix=path), m * e_local, e_local)))
        _sync(dev)
        init_s = time.perf_counter() - t0
        n = batch["tokens"].shape[0] // n_data
        rows = {k: v[d * n:(d + 1) * n].to(dev) for k, v in batch.items()}

        def prefill():
            cache = onerec.init_cache(cfg, n, device=dev)
            return onerec.prefill(params, rows, cfg, cache)[0]

        with sh.use_mesh(mesh, sh.INFER_RULES):
            _zero(wrappers)
            logits = prefill()
            _sync(dev)
            fwd_launches = {k: w.launches for k, w in wrappers.items()}
            times = []
            for _ in range(2):
                dist.barrier()
                t0 = time.perf_counter()
                prefill()
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            reduce = dict(calls=0, bytes=0, s=0.0)
            all_reduce = dist.all_reduce

            def timed(t, *args, **kwargs):
                _sync(dev)
                t1 = time.perf_counter()
                all_reduce(t, *args, **kwargs)
                _sync(dev)
                reduce["s"] += time.perf_counter() - t1
                reduce["calls"] += 1
                reduce["bytes"] += t.numel() * t.element_size()

            dist.all_reduce = timed
            try:
                prefill()
            finally:
                dist.all_reduce = all_reduce
            _zero(wrappers)
            items = onerec.generate_items(params, rows, cfg)
            _sync(dev)
            gen_launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        held = sum(t.numel() * t.element_size() for t in
                   _tensors(params))
        out[tag] = dict(
            coord=[d, m], e_local=e_local, init_s=init_s,
            prefill_ms=times, reduce=reduce, peak=peak, held_bytes=held,
            forward_launches=fwd_launches, generate_launches=gen_launches,
            logits=logits.cpu(), items=items.cpu())
        del params, logits
    return out


def _keystr_to_path(key: str) -> str:
    """A checkpoint's JAX ``keystr`` path -> the ``/``-joined path the
    sharding rules read (``[<flat index 0>]`` -> ``0``)."""
    import re
    return "/".join(a or b for a, b in re.findall(
        r"\[(?:'([^']*)'|<flat index (\d+)>)\]", key))


def _tensors(tree):
    from repro_torch.checkpoint import store
    return store._flatten(tree)[1]


def psum_case(dev, rank, out):
    """(s) in one rank: ``compressed_psum`` of the rank's tree over each
    case's axis; residuals against ``ef_compress`` and a rerun, bitwise."""
    import torch
    from repro_torch.distributed import compression
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    for (n_data, n_model), axis in PSUM_CASES:
        mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                        device_type=dev.type)
        grads, res = _psum_tree(rank, dev)
        with sh.use_mesh(mesh):
            _sync(dev)
            t0 = time.perf_counter()
            red, new_res = compression.compressed_psum(grads, axis, res)
            _sync(dev)
            secs = time.perf_counter() - t0
            red2, _ = compression.compressed_psum(grads, axis, res)
        _, want = compression.ef_compress(grads, res)
        for k in PSUM_SHAPES:
            if not torch.equal(new_res[k], want[k]):
                raise AssertionError(f"(s) rank {rank}: residual {k} is not "
                                     f"ef_compress's")
            if not torch.equal(red2[k], red[k]):
                raise AssertionError(f"(s) rank {rank}: a rerun of {k} "
                                     f"differs")
        out[f"({n_data}, {n_model}) {axis}"] = dict(
            s=secs, coord=list(mesh.get_coordinate()),
            bytes=sum(t.numel() * 4 for t in red.values()),
            reduced={k: v.cpu() for k, v in red.items()})
    return out


def elastic_case(dev, rank, cfg, ckpt, out):
    """(t) in one rank: restore onto (1, 4) under INFER_RULES and (2, 2)
    under TRAIN_RULES from a ``meta`` template; every local shard against
    the global leaf's slice, bit for bit, its placements against
    ``param_sharding``'s, fp8 payloads K-major; ``fp8_gemm`` on the rank's
    shard of q_proj against the slice of the full product."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.checkpoint import store
    from repro_torch.core import quant
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.distributed import elastic
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import onerec
    template = quantize_params(onerec.init_onerec(0, cfg, device="meta"),
                               PAPER_POLICY)
    cpu_tpl = store._unflatten(template, iter(
        tree_util.empty_like(t, device="cpu")
        for t in store._flatten(template)[1]))
    full, _ = store.load_checkpoint(ckpt, cpu_tpl)
    g = torch.Generator(device=dev).manual_seed(7)
    d_model = cfg.transformer.d_model
    x = torch.randn(ELASTIC_ROWS, d_model, generator=g,
                    device=dev).to(torch.bfloat16)
    q_full = full["backbone"]["stacks"]["0"]["p0"]["attn"]["q_proj"][
        "kernel"]
    for (n_data, n_model), rules_name in (((1, 4), "infer"),
                                          ((2, 2), "train")):
        rules = sh.RULE_SETS[rules_name]
        mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                        device_type=dev.type)
        _sync(dev)
        t0 = time.perf_counter()
        restored, _ = elastic.restore_elastic(ckpt, template, mesh, rules)
        _sync(dev)
        secs = time.perf_counter() - t0
        n_leaves = k_major = sharded = 0
        glob = dict(zip(*store._flatten(full)))
        for path, leaf in zip(*store._flatten(restored)):
            want = glob[path]
            jpath = _keystr_to_path(path)
            expect = sh.param_sharding(
                sh.infer_param_axes(jpath, want.ndim), tuple(want.shape),
                mesh=mesh, rules=rules).placements
            if list(leaf.placements) != list(expect):
                raise AssertionError(f"(t) {path}: placements "
                                     f"{leaf.placements} != {expect}")
            local = leaf.to_local()
            part = _shard_of(want, leaf.placements, mesh)
            if not torch.equal(_u8(local.cpu()), _u8(part)):
                raise AssertionError(f"(t) rank {rank} {path}: the local "
                                     f"shard is not the global slice")
            if quant.is_fp8_dtype(local.dtype) and local.ndim >= 2:
                k = local.shape[-2]
                if local.stride(-2) != 1 or \
                        local.stride(-1) != -(-k // 16) * 16:
                    raise AssertionError(f"(t) {path}: payload strides "
                                         f"{local.stride()} not K-major")
                k_major += 1
            sharded += tuple(local.shape) != tuple(want.shape)
            n_leaves += 1
        q = restored["backbone"]["stacks"]["0"]["p0"]["attn"]["q_proj"][
            "kernel"]
        w_loc = quant.QuantizedTensor(q.data.to_local()[0],
                                      q.scale.to_local()[0], "per_channel")
        coord = mesh.get_coordinate()
        kk, nn = w_loc.data.shape
        ki = coord[0] if rules_name == "train" else 0
        ni = coord[-1]
        xs = x[:, ki * kk:(ki + 1) * kk].contiguous()
        rows_k = q_full.data[0][ki * kk:(ki + 1) * kk]
        w_ref = quant.QuantizedTensor(quant.k_major(rows_k.to(dev)),
                                      q_full.scale[0].to(dev), "per_channel")
        ref = quant.fp8_linear(xs, w_ref)[:, ni * nn:(ni + 1) * nn]
        got = quant.fp8_linear(xs, w_loc)
        ulps = _bf16_ulps(got, ref)
        if not ulps <= 1.0:
            raise AssertionError(f"(t) rank {rank} {rules_name}: fp8_gemm on "
                                 f"the local q_proj shard {ulps} bf16 ulps "
                                 f"off the full product's slice")
        out[f"({n_data}, {n_model}) {rules_name}"] = dict(
            s=secs, leaves=n_leaves, sharded=sharded, k_major=k_major,
            bytes_read=sum(t.numel() * t.element_size()
                           for t in glob.values()),
            local_bytes=sum(t.to_local().numel() * t.to_local().element_size()
                            for t in store._flatten(restored)[1]),
            gemm_ulps=ulps, q_local=tuple(w_loc.data.shape))
        del restored
    return out


def _phase8_rank(rank, world, tmpdir, device, cfg, batch, ckpt,
                 elastic_cfg):
    """One spawned rank of phase 8: gloo over a ``FileStore``, every rank
    on card 0, the kernels loaded from the libraries the parent built."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    torch.set_num_threads(2)
    if device == "cuda":
        torch.cuda.set_device(0)
    dev = resolve_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmpdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=EP_TIMEOUT_S))
    try:
        out = {"rank": rank}
        ep_serving(dev, rank, cfg, batch, out.setdefault("r", {}))
        psum_case(dev, rank, out.setdefault("s", {}))
        elastic_case(dev, rank, elastic_cfg, ckpt, out.setdefault("t", {}))
        if build.BUILDS:
            raise AssertionError(f"rank {rank} ran nvcc {build.BUILDS} "
                                 f"times: it must load the parent's builds")
        out["builds"] = build.BUILDS
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def grouped_e4_slices(dev):
    """``fp8_grouped_gemm`` on each 4-expert slice of 16 (a cloned slice,
    as a rank of (1, 4) holds it) gives the bits of the E = 16 call's
    rows, at decode and prefill rows."""
    import torch
    from repro_torch import tree as tree_util
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_grouped_gemm import ops
    g = torch.Generator(device=dev).manual_seed(24)
    for c, k, n in ((8, 2048, 4096), (3080, 2048, 4096), (8, 4096, 2048),
                    (3080, 4096, 2048)):
        x = torch.randn(16, c, k, generator=g, device=dev).to(torch.bfloat16)
        w = quant.quantize_blockwise(
            torch.randn(16, k, n, generator=g, device=dev) / math.sqrt(k))
        full = ops.fp8_grouped_gemm(x, w.data, w.scale)
        for r in range(4):
            part = w.data[4 * r:4 * r + 4]
            part = tree_util.empty_like(part).copy_(part)
            out = ops.fp8_grouped_gemm(x[4 * r:4 * r + 4].contiguous(), part,
                                       w.scale[4 * r:4 * r + 4].contiguous())
            if not torch.equal(out, full[4 * r:4 * r + 4]):
                fail(f"fp8_grouped_gemm E=4 C={c} K={k} N={n}: experts "
                     f"{4 * r}-{4 * r + 3} differ from the E=16 call's")
        del x, w, full
    print("[ep] fp8_grouped_gemm at E=4 on each 4-expert slice of 16 (C = "
          "8 and 3080, gate/up and down shapes): bit-identical to the E=16 "
          "call's rows")


def _decode_tokens(dev, cfg, rows):
    """The serve_b32 step's input: one token a row, from seed 1."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    return torch.randint(0, cfg.vocab_size, (rows, 1), generator=g,
                         device=dev, dtype=torch.int32)


def _with_kernel(cfg, on: bool):
    """``cfg`` with ``use_attention_kernel`` set to ``on``."""
    import dataclasses
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, use_attention_kernel=on))


def _filled_decode(params, tokens, cfg, cache, on: bool, index: int):
    """A decode step of ``tokens`` (B, 1) at ``index`` over a copy of
    ``cache``, as a prefill left it, with ``use_attention_kernel`` set to
    ``on``: ``generate_items``' first step, its token given.  Returns the
    logits."""
    from repro_torch import tree as tree_util
    from repro_torch.models import onerec
    copy = tree_util.map_with_path(lambda _, t: t.clone(), cache)
    return onerec.decode_step(params, tokens, _with_kernel(cfg, on), copy,
                              index)[0]


def _world1(dev, cfg, rows):
    """The prefill_b32 bundle's step at world 1 on ``rows`` rows: its
    params (seed 0, PTQ'd layer by layer) and batch; the last logits and
    ``generate_items`` of all rows and of each half alone; and the
    serve_b32 step (one token a row at index ``seq_len - 1`` of an empty
    shared cache) on all rows and on each half, with
    ``use_attention_kernel`` off and on (``"decode"``).  For phase 9:
    the first layer's output of each prefill (``"layer0"``); a decode step
    over the cache each prefill filled, its token the first of the item
    (``"filled"``, kernel off and on); and the logits of the prefill, of
    the decode steps and of the generation on all rows with the GEMM
    kernels' plain versions (``"plain"``: how far a change of f32
    summation order alone moves them)."""
    import dataclasses
    import torch
    from repro_torch.configs.onerec_v2 import SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import onerec
    shape = dataclasses.replace(SHAPES["prefill_b32"], global_batch=rows)
    b = steps.onerec_bundle("onerec-v2", cfg, shape, fp8=True, device=dev)
    params, batch = b.args
    wrappers = _wrappers()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _zero(wrappers)
    logits, filled = b.fn(params, batch)
    _sync(dev)
    launches = {k: w.launches for k, w in wrappers.items()}
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        b.fn(params, batch)
        _sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    from repro_torch.core.stats import capture_taps
    with capture_taps() as taps:
        b.fn(params, batch)
    ref = {"all": dict(logits=logits.cpu(), items=onerec.generate_items(
        params, batch, cfg).cpu(), layer0=taps["layer_out/p0"].cpu())}
    del taps
    caches = {"all": filled}
    half = rows // 2
    for d in range(2):
        part = {k: v[d * half:(d + 1) * half] for k, v in batch.items()}
        cache = onerec.init_cache(cfg, half, device=dev)
        with capture_taps() as taps:
            part_logits, caches[d] = onerec.prefill(params, part, cfg, cache)
        ref[d] = dict(
            logits=part_logits.cpu(), layer0=taps["layer_out/p0"].cpu(),
            items=onerec.generate_items(params, part, cfg).cpu())
        del taps
    after = batch["tokens"].shape[1] + 1          # + the profile position
    ref["filled"] = {}
    for key, cache in caches.items():
        first = ref[key]["items"][:, :1].to(dev)
        for on in (False, True):
            ref["filled"][key, on] = _filled_decode(
                params, first, cfg, cache, on, after).cpu()
    del caches, filled
    tok = _decode_tokens(dev, cfg, rows)
    index = SHAPES["serve_b32"].seq_len - 1
    ref["decode"] = {}
    for on in (False, True):
        kcfg = _with_kernel(cfg, on)
        for key, sl in (("all", slice(0, rows)), (0, slice(0, half)),
                        (1, slice(half, rows))):
            cache = onerec.init_cache(kcfg, sl.stop - sl.start, device=dev)
            ref["decode"][key, on] = onerec.decode_step(
                params, tok[sl], kcfg, cache, index)[0].cpu()
    with plain_gemms():
        plain_logits, filled = b.fn(params, batch)
        ref["plain"] = {"prefill": plain_logits.cpu(),
                        "items": onerec.generate_items(params, batch,
                                                       cfg).cpu()}
        first = ref["all"]["items"][:, :1].to(dev)
        for on in (False, True):
            ref["plain"]["filled", on] = _filled_decode(
                params, first, cfg, filled, on, after).cpu()
        del filled
        for on in (False, True):
            kcfg = _with_kernel(cfg, on)
            cache = onerec.init_cache(kcfg, rows, device=dev)
            ref["plain"][on] = onerec.decode_step(params, tok, kcfg, cache,
                                                  index)[0].cpu()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    held = sum(t.numel() * t.element_size() for t in _tensors(params))
    return ref, {k: v.cpu() for k, v in batch.items()}, dict(
        prefill_ms=times, peak=peak, held_bytes=held, launches=launches)


def ep_phase(dev, cfg=None, elastic_cfg=None, rows=32, world1=None):
    """Phase 8 (N9d): (r) EP serving, (s) ``compressed_psum``, (t) elastic
    restore, in ``EP_WORLD`` gloo ranks sharing the card, against
    ``world1`` (``_world1``'s, made here when not given).  Returns the EP
    path's launch counts (rank 0 of (1, 4): one prefill and a
    generation)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint import store
    from repro_torch.configs.onerec_v2 import CONFIG
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.distributed import compression
    from repro_torch.models import onerec
    t_phase = time.perf_counter()
    cfg = cfg or CONFIG
    elastic_cfg = elastic_cfg or dataclasses.replace(
        CONFIG, transformer=dataclasses.replace(CONFIG.transformer,
                                                n_layers=ELASTIC_LAYERS))
    n_layers = cfg.transformer.n_layers
    if dev.type == "cuda":
        grouped_e4_slices(dev)
    ref, batch, w1 = world1 or _world1(dev, cfg, rows)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"[ep] world 1: prefill {rows} x {batch['tokens'].shape[1]} "
          f"tokens {w1['prefill_ms'][0]:.1f} / {w1['prefill_ms'][1]:.1f} "
          f"ms, params {w1['held_bytes'] / 1e9:.3f} GB, peak "
          f"{w1['peak'] / 2**30:.2f} GiB; launches a forward "
          f"{w1['launches']}")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    os.makedirs(EP_DIR)
    t0 = time.perf_counter()
    ck = store.save_checkpoint(EP_DIR, 1, onerec.init_onerec(
        0, elastic_cfg, device=dev, transform=lambda path, t: quantize_params(
            t, PAPER_POLICY, prefix=path)))
    print(f"[ep] (t) saved {elastic_cfg.transformer.n_layers}-layer "
          f"full-width OneRec-V2, FP8 PTQ, in {time.perf_counter() - t0:.1f}"
          f" s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # gloo finds the loopback interface by name on a host without a network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(dir=EP_DIR)
    t0 = time.perf_counter()
    torch.multiprocessing.spawn(_phase8_rank, args=(
        EP_WORLD, tmp, dev.type, cfg, batch, ck, elastic_cfg),
        nprocs=EP_WORLD)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(EP_WORLD)]
    per_forward = {"fp8_gemm": 4 * n_layers, "fp8_grouped_gemm": 3 * n_layers}
    # (r)
    for n_data, n_model in EP_MESHES:
        tag = f"({n_data}, {n_model})"
        for o in outs:
            r = o["r"][tag]
            d, m = r["coord"]
            want = ref["all"] if n_data == 1 else ref[d]
            if not torch.equal(r["logits"], want["logits"]):
                diff = (r["logits"] - want["logits"]).abs().max().item()
                fail(f"(r) {tag} rank {o['rank']}: prefill logits differ "
                     f"from world 1's (max |diff| {diff})")
            if not torch.equal(r["items"], want["items"]):
                fail(f"(r) {tag} rank {o['rank']}: items differ from world "
                     f"1's")
            for k, v in (per_forward.items() if dev.type == "cuda" else ()):
                if r["forward_launches"][k] != v:
                    fail(f"(r) {tag} rank {o['rank']}: {k} launched "
                         f"{r['forward_launches'][k]} times a forward, not "
                         f"{v}")
                if r["generate_launches"][k] != v * (1 + cfg.decode_len):
                    fail(f"(r) {tag} rank {o['rank']}: {k} launched "
                         f"{r['generate_launches'][k]} times a generation")
            red = r["reduce"]
            print(f"[ep] (r) {tag} rank {o['rank']} (data {d}, model {m}):"
                  f" {r['e_local']} experts a layer, params "
                  f"{r['held_bytes'] / 1e9:.3f} GB (made in "
                  f"{r['init_s']:.1f} s), prefill of "
                  f"{batch['tokens'].shape[0] // n_data} rows "
                  f"{r['prefill_ms'][0]:.1f} / {r['prefill_ms'][1]:.1f} ms "
                  f"(ranks time-sliced on one card), all_reduce "
                  f"{red['calls']} calls {red['bytes'] / 1e6:.1f} MB "
                  f"{red['s'] * 1e3:.1f} ms a forward (gloo through host "
                  f"memory), peak {r['peak'] / 2**30:.2f} GiB, launches a "
                  f"forward {r['forward_launches']}")
        print(f"[ep] (r) {tag}: every rank's prefill logits and items "
              f"bit-identical to world 1's"
              + (" (each data shard's rows alone)" if n_data > 1 else ""))
    # (s)
    comp = {q: compression.ef_compress(*_psum_tree(q, dev))[0]
            for q in range(EP_WORLD)}
    for (n_data, n_model), axis in PSUM_CASES:
        tag = f"({n_data}, {n_model}) {axis}"
        groups = {}         # ranks that share the other axis's coordinate
        for o in outs:
            d, m = o["s"][tag]["coord"]
            groups.setdefault(d if axis == "model" else m, []).append(
                o["rank"])
        worst_sum = worst_mag = 0.0
        for members in groups.values():
            for name in PSUM_SHAPES:
                terms = [comp[q][name].double() for q in members]
                total = sum(terms)
                mag = sum(t.abs() for t in terms).float()
                ulp_mag = torch.ldexp(torch.ones_like(mag),
                                      torch.frexp(mag)[1] - 24)
                tot32 = total.float().abs().clamp(min=2.0 ** -126)
                ulp_sum = torch.ldexp(torch.ones_like(tot32),
                                      torch.frexp(tot32)[1] - 24)
                first = outs[members[0]]["s"][tag]["reduced"][name]
                for q in members:
                    got = outs[q]["s"][tag]["reduced"][name]
                    if not torch.equal(got, first):
                        fail(f"(s) {tag}: ranks {members[0]} and {q} hold "
                             f"different sums of {name}")
                err = (first.to(dev).double() - total).abs()
                worst_mag = max(worst_mag, (err / ulp_mag.double()).max()
                                .item())
                worst_sum = max(worst_sum, (err / ulp_sum.double()).max()
                                .item())
        if not worst_mag <= 2.0:
            fail(f"(s) {tag}: {worst_mag} f32 ulps off the float64 sum, in "
                 f"ulps of the sum of the terms' magnitudes (bound 2)")
        secs = [o["s"][tag]["s"] for o in outs]
        print(f"[ep] (s) compressed_psum {tag}, groups {list(groups.values())}"
              f": {outs[0]['s'][tag]['bytes'] / 1e6:.1f} MB a rank, "
              f"{min(secs):.3f}-{max(secs):.3f} s (gloo through host "
              f"memory); every rank of a group equal; within {worst_mag:.3f}"
              f" f32 ulps of the float64 sum of the ranks' ef_compress "
              f"outputs, in ulps of the sum of their magnitudes (bound 2; "
              f"{worst_sum:.3f} ulps of the sum itself, where terms "
              f"cancel); residuals and a rerun bit for bit")
    # (t)
    for o in outs:
        for tag, t in o["t"].items():
            print(f"[ep] (t) {tag} rank {o['rank']}: restored {t['leaves']} "
                  f"leaves ({t['sharded']} sharded, {t['k_major']} K-major "
                  f"fp8 payloads), read {t['bytes_read'] / 1e9:.3f} GB, kept "
                  f"{t['local_bytes'] / 1e9:.3f} GB, {t['s']:.2f} s; "
                  f"fp8_gemm on the local q_proj shard {t['q_local']} "
                  f"{t['gemm_ulps']:.2f} bf16 ulps off the full product's "
                  f"slice (bound 1)")
    print("[ep] (t) every local shard bit-equal to its global slice, "
          "placements param_sharding's, no nvcc in any rank")
    shutil.rmtree(EP_DIR, ignore_errors=True)
    r0 = outs[0]["r"]["(1, 4)"]
    ep = {k: r0["forward_launches"][k] + r0["generate_launches"][k]
          for k in r0["forward_launches"]}
    print(f"[ep] ranks {ranks_s:.1f} s; phase 8 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"ep": ep}


# ---------------------------------------------------------------------------
# Phase 9: tensor parallelism (N9e.1)
# ---------------------------------------------------------------------------

TP_MESHES = ((1, 4), (2, 2))     # (data, model)
TP_DIR = os.path.join(ROOT, "build", "phase9")
# (v): the first layer's output against world 1's on the same input,
# relative L2.  The logits after 12 layers cannot be held so close: world
# 1's own GEMMs against their plain versions (the same e4m3 payloads, f32
# sums in another order) move the prefill's by 3.54e-2 and an empty-cache
# decode step's by 1.93e-2 (measured on one NVIDIA H100 80GB HBM3 at
# 700.00 W), a random-weight MoE stack amplifying a last-bit difference
# through attention and flipped top-2 choices.  So the logits after a
# prefill, and of a decode step over the cache it filled, are held to
# TP_LOGITS_REL_L2; an empty-cache decode step's to TP_DECODE_REL_L2; all
# of them to the top-8 overlap of phase 3; and the generated items to
# TP_ITEMS_EQUAL, the share of rows whose item equals world 1's (a flipped
# greedy step changes the rest of its row)
TP_REL_L2 = 1e-2
TP_LOGITS_REL_L2 = 5e-2
TP_DECODE_REL_L2 = 2.5e-2
TP_ITEMS_EQUAL = 0.75
# (v): layer 0's products against world 1's, in bf16 ulps of the largest
# output (``TOL``, phase 2's GEMM bound): an output near zero, where the
# ranks' f32 partials cancel, may sit many of its own ulps off
TP_GAP_ULPS = 1.0
GAP_ROWS = 1024                  # (v): rows of the per-layer gap's input
# (u): o_proj's row-parallel K-slice on a rank of (1, 4), (M, K, N) with
# f32 out: the prefill_b32 step's 32 x 385 rows and a decode step's 32
GIVEN_SHAPES = ((12320, 512, 2048), (32, 512, 2048))
GIVEN_RANKS = 4


def check_fp8_gemm_given(dev, records):
    """(u) ``fp8_gemm``'s given-scale mode on each rank's K-slice of
    o_proj at ``GIVEN_SHAPES``, the row scales those of the whole rows (the
    max all-reduce's result): against its plain version (1 bf16 ulp of the
    largest output) and the float64-summed function (``OFF_EXACT_MAX``
    of the outputs rounded to bf16); each slice's quantized payload (the
    kernel's f16 copies of the e4m3 values, and its row scales) equal to
    the K-slice of one rank's dynamic-mode payload, bit for bit; rank 0's
    slice timed beside the dynamic mode at the same shape and
    ``torch._scaled_mm`` on operands quantized beforehand (bf16 out)."""
    import torch
    from repro_torch.core import quant
    from repro_torch.kernels.fp8_gemm import ops
    g = torch.Generator(device=dev).manual_seed(9)
    worst, shapes = 0.0, []
    for m, k, n in GIVEN_SHAPES:
        kk = GIVEN_RANKS * k
        x = torch.randn(1, m, kk, device=dev, generator=g).to(torch.bfloat16)
        w = quant.quantize_per_channel(
            torch.randn(kk, n, device=dev, generator=g) / math.sqrt(kk))
        sw = w.scale.reshape(1, n).contiguous()
        row = quant.amax_to_scale(x.float().abs().amax(-1))      # (1, M)
        _, _, xh_full, sx_full, _, _ = ops.scratch(x, w.data.unsqueeze(0))
        ops.quantize_pass(x, xh_full, sx_full)
        errs, offs = [], []
        for r in range(GIVEN_RANKS):
            xs = x[..., r * k:(r + 1) * k].contiguous()
            ws = quant.k_major(w.data[r * k:(r + 1) * k]).unsqueeze(0)
            _, _, xh, sx, _, _ = ops.scratch(xs, ws)
            ops.quantize_pass(xs, xh, sx, row_scale=row)
            torch.cuda.synchronize()
            if not (torch.equal(sx, sx_full) and torch.equal(
                    xh, xh_full[..., r * k:(r + 1) * k])):
                fail(f"fp8_gemm given M={m} K={k} N={n}: rank {r}'s payload "
                     f"is not the K-slice of one rank's")
            out = ops.fp8_gemm(xs, ws, sw, out_dtype=torch.float32,
                               row_scale=row)
            ref = ops.fp8_gemm_plain(xs, ws, sw, torch.float32,
                                     row_scale=row)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = TOL * ref.abs().max().item()
            if not err <= tol:
                fail(f"fp8_gemm given M={m} K={k} N={n} rank {r}: max "
                     f"|diff| {err} > {tol}")
            exact = (quant.cast_to_fp8(xs, row[..., None]).double()
                     @ ws.double()) * row.double()[..., None] \
                * sw.double()[:, None, :]
            offs.append(off_exact("fp8_gemm given", f"M={m} K={k} N={n} "
                                  f"rank {r}", out.to(torch.bfloat16),
                                  ref.to(torch.bfloat16), exact))
            errs.append(err)
            del exact
        worst = max(worst, max(errs))
        xs = x[..., :k].contiguous()
        ws = quant.k_major(w.data[:k]).unsqueeze(0)
        lq = quant.cast_to_fp8(xs[0], row[0][:, None])
        scale_a = row[0][:, None].contiguous()

        def given():
            ops.fp8_gemm(xs, ws, sw, out_dtype=torch.float32, row_scale=row)

        def dynamic():
            ops.fp8_gemm(xs, ws, sw, out_dtype=torch.float32)

        def library():
            torch._scaled_mm(lq, ws[0], scale_a=scale_a, scale_b=sw,
                             out_dtype=torch.bfloat16)

        iters = 5 if m > 1024 else 50
        t = time_turns(dict(given=given, dynamic=dynamic, library=library),
                       iters)
        eager = time_ms(given, iters)
        plain_ms = time_ms(lambda: ops.fp8_gemm_plain(
            xs, ws, sw, torch.float32, row_scale=row), iters)
        b_ms, b_by = bound(m * k * 2 + k * n + n * 4 + m * 4 + m * n * 4,
                           2.0 * m * n * k, FP8_OPS_PER_S)
        off = max(o["off_exact_kernel"] for o in offs)
        print(f"[kernel] fp8_gemm given scale M={m} K={k} N={n} (f32 out): "
              f"max|diff| {max(errs):.3g} over {GIVEN_RANKS} rank slices, "
              f"payloads the K-slices of one rank's bit for bit, off "
              f"{off:.4%}; given {t['given']:.4f} ms, dynamic mode "
              f"{t['dynamic']:.4f} ms, plain {plain_ms:.4f} ms, "
              f"torch._scaled_mm (bf16 out) {t['library']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}) (device times, CUDA graphs); eager "
              f"{eager:.4f} ms")
        shapes.append(dict(
            shape=f"M={m} K={k} N={n}", path="row-parallel o_proj shard",
            timer="cuda_graph", ms=t["given"], dynamic_ms=t["dynamic"],
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=t["library"], eager_ms=eager, max_abs_err=max(errs),
            off_exact_kernel=off,
            off_exact_plain=max(o["off_exact_plain"] for o in offs)))
        del x, w, xh_full
    records["fp8_gemm_given"] = dict(shapes[0], max_abs_err=worst,
                                     shapes=shapes)


def _rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def _top8_overlap(a, b) -> float:
    """Mean share of each row's 8 largest ids that the two agree on."""
    import torch
    ta = torch.topk(a.float(), 8, dim=-1).indices
    tb = torch.topk(b.float(), 8, dim=-1).indices
    hits = (ta[:, :, None] == tb[:, None, :]).any(-1).float()
    return hits.mean().item()


def _layer_gap(dev, full, laid, mesh):
    """Layer 0's q/k/v products (column-parallel) and o_proj
    (row-parallel) on one random bf16 input, the laid-out params' output
    against world 1's on this rank's part: max |diff| in bf16 ulps of the
    largest output (``TOL``)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch import tree as tree_util
    from repro_torch.core import quant
    from repro_torch.distributed import sharding as sh
    g = torch.Generator(device=dev).manual_seed(11)
    w1 = tree_util.index(full["backbone"]["stacks"]["0"]["p0"]["attn"], 0)
    tp = tree_util.index(laid["backbone"]["stacks"]["0"]["p0"]["attn"], 0)
    d = w1["q_proj"]["kernel"].data.shape[0]
    rep = [Replicate()] * mesh.ndim
    x = torch.randn(GAP_ROWS, d, generator=g, device=dev).to(torch.bfloat16)
    gaps = {}
    for name in ("q_proj", "k_proj", "v_proj"):
        ref = quant.matmul_any(x, w1[name]["kernel"])
        got = quant.matmul_any(DTensor.from_local(x, mesh, rep),
                               tp[name]["kernel"])
        off, n = sh.shard_range(mesh, got.placements, 1, got.shape[1])
        gaps[name] = _max_ulps(got.to_local(), ref[:, off:off + n])
    hd = w1["o_proj"]["kernel"].data.shape[0]
    h = torch.randn(GAP_ROWS, hd, generator=g, device=dev).to(torch.bfloat16)
    ref = quant.matmul_any(h, w1["o_proj"]["kernel"])
    places = [Shard(1) if a == "model" else Replicate()
              for a in mesh.mesh_dim_names]
    off, n = sh.shard_range(mesh, places, 1, hd)
    got = quant.matmul_any(DTensor.from_local(
        h[:, off:off + n].contiguous(), mesh, places), tp["o_proj"]["kernel"])
    gaps["o_proj"] = _max_ulps(got.to_local(), ref)
    return gaps, _own_ulps(got.to_local(), ref)


def _own_ulps(got, ref) -> float:
    """max |got - ref| over the nonzero outputs, each in bf16 ulps of its
    own |ref|."""
    import torch
    ref = ref.float()
    nz = ref != 0
    ulp = torch.exp2(torch.floor(torch.log2(ref[nz].abs())) - 7)
    return ((got.float()[nz] - ref[nz]).abs() / ulp).max().item()


def _max_ulps(got, ref) -> float:
    """max |got - ref| in bf16 ulps of the largest |ref|."""
    ref = ref.float()
    return ((got.float() - ref).abs().max() / (TOL * ref.abs().max())
            ).item()


@contextlib.contextmanager
def _timed_collectives(dev, stats):
    """Each ``all_reduce`` and ``all_gather_into_tensor`` in the block
    synchronized and timed apart, by the first caller outside the
    collective helpers: ``stats[(op, caller)] = [calls, bytes, s]``."""
    import torch.distributed as dist
    helpers = ("sharding.py", "distributed_c10d.py", "c10d_logger.py")
    names = ("all_reduce", "all_gather_into_tensor")
    orig = {n: getattr(dist, n) for n in names}

    def wrap(name):
        def timed(*args, **kwargs):
            f = sys._getframe(1)
            while f.f_code.co_filename.endswith(helpers):
                f = f.f_back
            held = args[0]
            _sync(dev)
            t0 = time.perf_counter()
            out = orig[name](*args, **kwargs)
            _sync(dev)
            s = stats.setdefault((name, f.f_code.co_name), [0, 0, 0.0])
            s[0] += 1
            s[1] += held.numel() * held.element_size()
            s[2] += time.perf_counter() - t0
            return out
        return timed

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        yield stats
    finally:
        for n in names:
            setattr(dist, n, orig[n])


def tp_serving(dev, rank, cfg, rows, layer0, first, out):
    """(v) in one rank: params from seed 0 (the prefill_b32 bundle's,
    PTQ'd layer by layer) laid out on each mesh by ``steps.shard_args``,
    layer 0's products against world 1's; then on each mesh the prefill
    step (checked, rerun, timed, once more with each collective timed),
    the serve_b32 step with ``use_attention_kernel`` off and on (and
    rerun), a decode step over the cache the prefill filled, its tokens
    ``first[mesh]`` (world 1's first item tokens), with the kernel off and
    on, and ``generate_items`` with ``radix_topk`` (world 1's config: its
    items compare with world 1's); launch counts of each; the first
    layer's output against world 1's ``layer0`` (all rows, or each half
    alone for a data shard of (2, 2))."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs.onerec_v2 import SHAPES
    from repro_torch.core.stats import capture_taps
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels.radix_topk.ops import radix_topk
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import onerec
    wrappers = _wrappers()
    gemm = wrappers["fp8_gemm"]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    pre = steps.onerec_bundle("onerec-v2", cfg, dataclasses.replace(
        SHAPES["prefill_b32"], global_batch=rows), fp8=True, device=dev)
    dec = steps.onerec_bundle("onerec-v2", cfg, dataclasses.replace(
        SHAPES["serve_b32"], global_batch=rows), fp8=True, device="meta")
    _sync(dev)
    init_s = time.perf_counter() - t0
    meshes, laid = {}, {}
    for n_data, n_model in TP_MESHES:
        mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                        device_type=dev.type)
        meshes[n_data, n_model] = mesh
        laid[n_data, n_model] = steps.shard_args(pre, mesh, sh.INFER_RULES)
    gaps = {key: _layer_gap(dev, pre.args[0], laid[key][0], mesh)
            for key, mesh in meshes.items()}
    held_full = sum(t.numel() * t.element_size() for t in
                    _tensors(pre.args[0]))
    pre.args = (None, None)              # the full params go
    tok = _decode_tokens(dev, cfg, rows)
    index = dec.args[3]

    def launches():
        got = {k: w.launches for k, w in wrappers.items()}
        got["fp8_gemm_given"] = gemm.given_launches
        return got

    def zero():
        _zero(wrappers)
        gemm.given_launches = 0

    for (n_data, n_model), mesh in meshes.items():
        tag = f"({n_data}, {n_model})"
        params, batch = laid[n_data, n_model]
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        res = dict(coord=list(mesh.get_coordinate()), gaps=gaps[
            n_data, n_model][0], own=gaps[n_data, n_model][1],
            init_s=init_s, held_full=held_full,
            held_bytes=sum(t.to_local().numel() * t.to_local().element_size()
                           for t in _tensors(params)))
        with sh.use_mesh(mesh, sh.INFER_RULES):
            zero()
            with capture_taps() as taps:
                logits, filled = pre.fn(params, batch)
            _sync(dev)
            res["prefill_launches"] = launches()
            lo, n = sh.shard_range(mesh, logits.placements, 0, rows)
            want = layer0["all"][lo:lo + n] if n_data == 1 else \
                layer0[mesh.get_coordinate()[0]]
            res["layer0"] = _rel_l2(taps["layer_out/p0"].to_local().cpu(),
                                    want)
            del taps
            times = []
            for _ in range(2):
                dist.barrier()
                t1 = time.perf_counter()
                again = pre.fn(params, batch)[0]
                _sync(dev)
                times.append((time.perf_counter() - t1) * 1e3)
            res["prefill_ms"] = times
            res["prefill_rerun_equal"] = torch.equal(again.to_local(),
                                                     logits.to_local())
            stats = {}
            dist.barrier()
            with _timed_collectives(dev, stats):
                pre.fn(params, batch)
            res["collectives"] = stats
            res["logits"] = logits.to_local().cpu()
            res["rows"] = lo, n
            res["decode"] = {}
            for on in (False, True):
                kcfg = _with_kernel(cfg, on)
                outs, ms = [], []
                for _ in range(2):
                    cache = onerec.init_cache(kcfg, rows, device=dev)
                    args = (sh.lay_out_tree(cache, dec.arg_axes[1]),
                            sh.lay_out_tree({"tokens": tok},
                                            dec.arg_axes[2]))
                    zero()
                    dist.barrier()
                    t1 = time.perf_counter()
                    dl = onerec.decode_step(params, args[1]["tokens"], kcfg,
                                            args[0], index)[0]
                    _sync(dev)
                    ms.append((time.perf_counter() - t1) * 1e3)
                    outs.append(dl)
                full = sh.constrain(outs[0], ("batch", None)).to_local()
                res["decode"][on] = dict(
                    ms=ms, launches=launches(), local=outs[0].to_local().cpu(),
                    full=full.cpu(), cols=sh.shard_range(
                        mesh, outs[0].placements, 1, outs[0].shape[1]),
                    rerun_equal=torch.equal(outs[1].to_local(),
                                            outs[0].to_local()))
            res["filled"] = {}
            tok1 = sh.lay_out_tree({"tokens": first[n_data, n_model].to(dev)},
                                   dec.arg_axes[2])["tokens"]
            for on in (False, True):
                zero()
                fl = _filled_decode(params, tok1, cfg, filled, on,
                                    batch["tokens"].shape[1] + 1)
                _sync(dev)
                res["filled"][on] = dict(
                    launches=launches(), local=fl.to_local().cpu(),
                    full=sh.constrain(fl, ("batch", None)).to_local().cpu(),
                    cols=sh.shard_range(mesh, fl.placements, 1,
                                        fl.shape[1]))
            del filled
            zero()
            items = onerec.generate_items(params, batch, cfg,
                                          topk_fn=radix_topk)
            _sync(dev)
            res["generate_launches"] = launches()
            res["items"] = items.to_local().cpu()
        res["peak"] = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
        out[tag] = res
        del logits, again
    return out


def _phase9_rank(rank, world, tmpdir, device, cfg, rows, layer0, first):
    """One spawned rank of phase 9 (as ``_phase8_rank``)."""
    import datetime
    import torch
    import torch.distributed as dist
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    torch.set_num_threads(2)
    if device == "cuda":
        torch.cuda.set_device(0)
    dev = resolve_device(device)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmpdir, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=EP_TIMEOUT_S))
    try:
        out = {"rank": rank,
               "v": tp_serving(dev, rank, cfg, rows, layer0, first, {})}
        if build.BUILDS:
            raise AssertionError(f"rank {rank} ran nvcc {build.BUILDS} "
                                 f"times: it must load the parent's builds")
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def tp_phase(dev, world1, cfg=None, rows=32):
    """Phase 9 (N9e.1): (v) full-width OneRec-V2 served tensor and expert
    parallel in ``EP_WORLD`` gloo ranks sharing the card, against
    ``world1`` (``_world1``'s).  Returns the path's launch counts (rank 0
    of (1, 4): a prefill, two decode steps and a generation)."""
    import tempfile
    import torch
    from repro_torch.configs.onerec_v2 import CONFIG
    t_phase = time.perf_counter()
    cfg = cfg or CONFIG
    n_layers = cfg.transformer.n_layers
    ref = world1[0]
    shutil.rmtree(TP_DIR, ignore_errors=True)
    os.makedirs(TP_DIR)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    tmp = tempfile.mkdtemp(dir=TP_DIR)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    layer0 = {k: ref[k]["layer0"] for k in ("all", 0, 1)}
    # the first item token of each row, as world 1 generated it for the
    # rows a mesh's data shard holds
    first = {(1, 4): ref["all"]["items"][:, :1],
             (2, 2): torch.cat([ref[0]["items"][:, :1],
                                ref[1]["items"][:, :1]])}
    torch.multiprocessing.spawn(_phase9_rank, args=(
        EP_WORLD, tmp, dev.type, cfg, rows, layer0, first),
        nprocs=EP_WORLD)
    ranks_s = time.perf_counter() - t0
    outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(EP_WORLD)]
    per_prefill = {"fp8_gemm": 4 * n_layers, "fp8_gemm_given": n_layers,
                   "fp8_grouped_gemm": 3 * n_layers, "batch_attention": 0,
                   "radix_topk": 0}
    per_decode = {True: dict(per_prefill, batch_attention=n_layers),
                  False: per_prefill}
    steps_n = 1 + cfg.decode_len
    per_generate = {k: v * steps_n for k, v in per_prefill.items()}
    per_generate.update(radix_topk=cfg.decode_len)
    worst = dict(prefill=0.0, decode=0.0, filled=0.0, gap=0.0, layer0=0.0,
                 own=0.0)
    items_equal = 1.0
    plain = ref["plain"]
    floor = {"prefill": _rel_l2(plain["prefill"], ref["all"]["logits"])}
    for on in (False, True):
        floor[on] = _rel_l2(plain[on], ref["decode"]["all", on])
        floor["filled", on] = _rel_l2(plain["filled", on],
                                      ref["filled"]["all", on])
    plain_items = (plain["items"] == ref["all"]["items"]).all(-1)
    print(f"[tp] (v) world 1's GEMM kernels against their plain versions "
          f"(the same payloads, f32 sums in another order): prefill logits "
          f"rel L2 {floor['prefill']:.3e}, top-8 overlap "
          f"{_top8_overlap(plain['prefill'], ref['all']['logits']):.3f}; "
          f"decode {floor[False]:.3e} (kernel on {floor[True]:.3e}); "
          f"decode over the filled cache {floor['filled', False]:.3e} "
          f"(kernel on {floor['filled', True]:.3e}), top-8 overlap "
          f"{_top8_overlap(plain['filled', False], ref['filled']['all', False]):.3f}"
          f"; items equal {plain_items.float().mean().item():.3f}.  "
          f"Bounds: prefill and filled-cache logits rel L2 "
          f"{TP_LOGITS_REL_L2}, empty-cache decode {TP_DECODE_REL_L2}, "
          f"top-8 overlap {CPU_TOP8_OVERLAP}, items equal {TP_ITEMS_EQUAL}")
    failures = []
    for n_data, n_model in TP_MESHES:
        tag = f"({n_data}, {n_model})"
        for o in outs:
            r = o["v"][tag]
            d, m = r["coord"]
            key = "all" if n_data == 1 else d
            lo, n = r["rows"]
            want = ref[key]["logits"] if n_data > 1 else \
                ref["all"]["logits"][lo:lo + n]
            rel = _rel_l2(r["logits"], want)
            over = _top8_overlap(r["logits"], want)
            who = f"(v) {tag} rank {o['rank']}"
            if not r["layer0"] <= TP_REL_L2:
                failures.append(f"{who}: layer 0's output rel L2 "
                                f"{r['layer0']:.3e} > {TP_REL_L2}")
            if not rel <= TP_LOGITS_REL_L2:
                failures.append(f"{who}: prefill logits rel L2 {rel:.3e} > "
                                f"{TP_LOGITS_REL_L2}")
            if not over >= CPU_TOP8_OVERLAP:
                failures.append(f"{who}: prefill top-8 overlap {over:.3f} "
                                f"< {CPU_TOP8_OVERLAP}")
            if not r["prefill_rerun_equal"]:
                failures.append(f"{who}: a rerun of the prefill differs")
            worst["prefill"] = max(worst["prefill"], rel)
            worst["layer0"] = max(worst["layer0"], r["layer0"])
            dec_line = []
            for what, want_all, bound in (
                    ("decode", ref["decode"], TP_DECODE_REL_L2),
                    ("filled", ref["filled"], TP_LOGITS_REL_L2)):
                for on, dres in r[what].items():
                    want_d = want_all[key, on]
                    if n_data == 1:
                        want_d = want_d[lo:lo + n]
                    c0, cn = dres["cols"]
                    rel_d = _rel_l2(dres["local"], want_d[:, c0:c0 + cn])
                    over_d = _top8_overlap(dres["full"], want_d)
                    if not (rel_d <= bound and over_d >= CPU_TOP8_OVERLAP):
                        failures.append(
                            f"{who}: {what} decode (kernel {on}) rel L2 "
                            f"{rel_d:.3e} (bound {bound}), top-8 overlap "
                            f"{over_d:.3f}")
                    if "rerun_equal" in dres and not dres["rerun_equal"]:
                        failures.append(f"{who}: a rerun of the decode "
                                        f"step (kernel {on}) differs")
                    worst[what] = max(worst[what], rel_d)
                    dec_line.append(
                        f"{'empty' if what == 'decode' else 'filled'} cache"
                        f", kernel {'on' if on else 'off'}: rel L2 "
                        f"{rel_d:.2e} top-8 {over_d:.3f}" + (
                            f" {dres['ms'][0]:.1f} / {dres['ms'][1]:.1f} ms"
                            if "ms" in dres else ""))
                    if dev.type == "cuda" and dres["launches"] != dict(
                            dres["launches"], **per_decode[on]):
                        failures.append(f"{who}: {what} decode launches "
                                        f"{dres['launches']}, not "
                                        f"{per_decode[on]}")
            for name, ulps in r["gaps"].items():
                if not ulps <= TP_GAP_ULPS:
                    failures.append(f"{who}: layer 0 {name} {ulps} bf16 ulps"
                                    f" off world 1 (bound {TP_GAP_ULPS})")
                worst["gap"] = max(worst["gap"], ulps)
            worst["own"] = max(worst["own"], r["own"])
            for launched, expect, what in (
                    (r["prefill_launches"], per_prefill, "a prefill"),
                    (r["generate_launches"], per_generate,
                     "a generation")):
                if dev.type == "cuda" and launched != dict(launched,
                                                           **expect):
                    failures.append(f"{who}: {what} launched {launched}, "
                                    f"not {expect}")
            items = ref[key]["items"] if n_data > 1 else \
                ref["all"]["items"][lo:lo + n]
            same = (r["items"] == items).all(-1).float().mean().item()
            if not same >= TP_ITEMS_EQUAL:
                failures.append(f"{who}: items equal to world 1's on "
                                f"{same:.3f} of the rows < {TP_ITEMS_EQUAL}")
            items_equal = min(items_equal, same)
            coll = "; ".join(
                f"{op} in {site} {c} x, {b / 1e6:.1f} MB, {s * 1e3:.1f} ms"
                for (op, site), (c, b, s) in sorted(r["collectives"].items()))
            print(f"[tp] (v) {tag} rank {o['rank']} (data {d}, model {m}): "
                  f"params {r['held_bytes'] / 1e9:.3f} GB laid out (full "
                  f"{r['held_full'] / 1e9:.3f} GB, made in {r['init_s']:.1f}"
                  f" s), peak {r['peak'] / 2**30:.2f} GiB; prefill of "
                  f"{rows} x 385 tokens (rows {lo}-{lo + n - 1}) "
                  f"{r['prefill_ms'][0]:.1f} / {r['prefill_ms'][1]:.1f} ms, "
                  f"layer 0's output rel L2 {r['layer0']:.2e}, logits rel "
                  f"L2 {rel:.2e}, top-8 overlap {over:.3f}, rerun "
                  f"bit-identical {r['prefill_rerun_equal']}; decode: "
                  f"{'; '.join(dec_line)}; items "
                  f"equal to world 1's {same:.3f}; layer 0's products off "
                  f"world 1's in bf16 ulps of the largest output "
                  f"{ {k: round(v, 2) for k, v in r['gaps'].items()} } "
                  f"(o_proj in an output's own ulps {r['own']:.2f}); "
                  f"launches a prefill {r['prefill_launches']}, a "
                  f"generation {r['generate_launches']}; collectives of a "
                  f"prefill (gloo through host memory, ranks time-sliced "
                  f"on one card): {coll}")
    if failures:
        fail("; ".join(failures))
    print(f"[tp] (v) every rank: layer 0's output within rel L2 "
          f"{worst['layer0']:.2e} of world 1's (bound {TP_REL_L2}), its "
          f"products within {worst['gap']:.2f} bf16 ulps of the largest "
          f"output (o_proj's largest gap in an output's own ulps "
          f"{worst['own']:.2f}, not held); logits within rel L2 "
          f"{worst['prefill']:.2e} (prefill), {worst['filled']:.2e} "
          f"(decode over the filled cache; bound {TP_LOGITS_REL_L2}) and "
          f"{worst['decode']:.2e} (empty-cache decode; bound "
          f"{TP_DECODE_REL_L2}) of world 1, top-8 overlap >= "
          f"{CPU_TOP8_OVERLAP}; items equal on >= {items_equal:.3f} of "
          f"the rows (bound {TP_ITEMS_EQUAL}); reruns bit-identical, no "
          f"nvcc in any rank")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    r0 = outs[0]["v"]["(1, 4)"]
    tp = {k: r0["prefill_launches"][k] + r0["generate_launches"][k]
          + sum(dres["launches"][k] for what in ("decode", "filled")
                for dres in r0[what].values())
          for k in r0["prefill_launches"]}
    print(f"[tp] ranks {ranks_s:.1f} s; phase 9 took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"tp": tp}


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
                if "registers" in ln or "spill" in ln or "C7517" in ln]
        print(f"[setup] ptxas {name}: " + " | ".join(regs))

    records = {}
    check_fp8_gemm(dev, records)
    check_fp8_gemm_given(dev, records)
    check_fp8_gemm_recsys(dev, records)
    check_fp8_grouped_gemm(dev, records)
    check_int8_product(dev, records)
    check_raw_products(dev, records)
    check_paged_decode(dev, records)
    check_radix_topk(dev, records)
    check_batch_attention(dev, records)
    check_batch_attention_zoo(dev, records)
    for case in ("paged", "paged-unfused", "paged-policy", "paged-return",
                 "paged-ptq", "contiguous", "fixed"):
        card_vs_cpu(dev, case)
    card_vs_cpu_tree(dev)
    card_vs_cpu_generate(dev)
    for case in ("lm-gemma", "lm-moe"):
        card_vs_cpu_lm(dev, case)
    for arch in RECSYS:
        card_vs_cpu_recsys(dev, arch)
    by_path, paged_outs = full_width(dev)
    distribution_phase(dev)
    training_phase(dev)
    checkpoint_phase(dev, paged_outs, by_path["paged"])
    from repro_torch.configs.onerec_v2 import CONFIG
    world1 = _world1(dev, CONFIG, 32)        # phases 8 and 9 hold to it
    by_path.update(ep_phase(dev, world1=world1))
    by_path.update(tp_phase(dev, world1))

    # (TPU kernel it replaces, the main path whose run it is counted in);
    # the given-scale mode of fp8_gemm is counted in phase 9's run
    replaces = {
        "fp8_gemm": ("src/repro/kernels/fp8_gemm/kernel.py:27", "paged"),
        "fp8_gemm_given": ("src/repro/kernels/fp8_gemm/kernel.py:27 (the "
                           "row-parallel products XLA partitions)", "tp"),
        "fp8_grouped_gemm":
            ("src/repro/kernels/fp8_grouped_gemm/kernel.py:27", "paged"),
        "paged_decode":
            ("src/repro/kernels/paged_decode/kernel.py:43", "paged"),
        "radix_topk": ("src/repro/kernels/radix_topk/kernel.py:42 "
                       "(+ :93 _emit_kernel)", "contiguous"),
        "batch_attention":
            ("src/repro/kernels/batch_attention/kernel.py:28",
             "contiguous")}
    kernels = []
    for name, (tpu, path) in replaces.items():
        r = records[name]
        source = build.SOURCES["fp8_gemm" if name == "fp8_gemm_given"
                               else name]
        # the given-scale mode is counted in phase 9's run alone
        counted = [(path, by_path[path])] if name == "fp8_gemm_given" \
            else by_path.items()
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": tpu, "launches": by_path[path][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"], "timer": r["timer"], "counted_in": path,
            **{key: r[key] for key in ("shapes", "dequant_ms", "eager_ms",
                                       "library_eager_ms", "threshold",
                                       "tree_ms", "tree_rows", "floor_ms",
                                       "cases_ms", "beam", "zoo",
                                       "recsys")
               if key in r},
            "launches_by_path": {p: c[name] for p, c in counted}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
