"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip on a machine without one.  They import
neither JAX nor the JAX package, so they run where only PyTorch is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 1 bf16 ulp (``2**-7`` relative to the largest output for the
GEMMs and ``batch_attention``, absolute for paged attention outputs of
order one); the fp8 payloads and scales are bit-identical, only f32
summation order (and online vs one-block softmax) differs.  ``radix_topk``
is exact: identical values and indices.
"""

import math

import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels.batch_attention import ops as attn_ops
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
from repro_torch.kernels.paged_decode import ops as decode_ops
from repro_torch.kernels.radix_topk import ops as topk_ops

ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: run on the card")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _close(out, ref):
    torch.testing.assert_close(out.float().cpu(), ref.float().cpu(),
                               rtol=ULP, atol=ULP * ref.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,N", [
    (1, 32, 2048, 2048),     # decode q/o: swap-AB, split K
    (1, 32, 2048, 512),      # decode k/v
    (3, 70, 256, 200),       # ragged M and N, batch of 3
    (2, 5, 272, 96),         # a ragged last 128-deep chunk
    (1, 32, 4096, 256),      # rows too long to hold in registers
    (1, 4100, 2048, 2048),   # prefill: TMA + wgmma, ragged last row tile
    (2, 300, 384, 200),      # prefill, batch of 2, ragged M and N
    (1, 4, 2048, 10944),     # deepseek-moe-16b's dense gate at decode
    (1, 4, 10944, 2048),     # its down: K not a multiple of 128
    (1, 600, 2048, 10944),   # prefill: the last 128-wide tile 64 columns
    (1, 600, 10944, 2048),   # prefill: a half-empty last 128-deep chunk
    (1, 4, 1152, 256),       # gemma3-1b's k/v: one KV head of 256
])
def test_fp8_gemm_kernel_matches_plain(cuda, E, M, K, N):
    """K-major weights from quantize_per_channel, through the decode
    (M < 256) and prefill paths."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(E, M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_per_channel(
        torch.randn(E, K, N, device=cuda, generator=g))
    assert wq.data.stride(-2) == 1
    sw = wq.scale.reshape(E, N).contiguous()
    before = gemm_ops.fp8_gemm.launches
    out = gemm_ops.fp8_gemm(x, wq.data, sw)
    assert gemm_ops.fp8_gemm.launches == before + 1
    _close(out, gemm_ops.fp8_gemm_plain(x, wq.data, sw))


@pytest.mark.cuda
def test_fp8_gemm_kernel_refuses_a_row_major_weight(cuda):
    """The kernel reads the weight K-major and never transposes per call:
    an (E, K, N) row-major payload raises, and launches nothing."""
    x = torch.randn(1, 32, 256, device=cuda).to(torch.bfloat16)
    wq = quant.quantize_per_channel(torch.randn(1, 256, 128, device=cuda))
    sw = wq.scale.reshape(1, 128).contiguous()
    before = gemm_ops.fp8_gemm.launches
    with pytest.raises(ValueError, match="K-major"):
        gemm_ops.fp8_gemm(x, wq.data.contiguous(), sw)
    assert gemm_ops.fp8_gemm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N", [
    (16, 8, 2048, 4096),     # decode gate/up: swapped operands, 8-row tiles
    (16, 8, 4096, 2048),     # decode down
    (3, 13, 256, 384),       # 16-row decode tiles, ragged C
    (2, 27, 384, 128),       # 32-row decode tiles
    (2, 100, 256, 128),      # prefill: TMA + wgmma, one ragged row tile
    (3, 45, 384, 256),       # prefill, C % 4 != 0: sx rows padded
    (4, 200, 256, 384),      # prefill, ragged last row tile, 3 column tiles
    (16, 520, 2048, 4096),   # prefill at full width, 5 row tiles
    (1, 300, 128, 128),      # prefill, one expert, one 128-deep chunk
    (2, 256, 384, 256),      # prefill, C a multiple of 128
    (1, 5, 128, 128),        # decode, one expert, one chunk
    (64, 8, 2048, 1408),     # the zoo's MoE (60 padded to 64, 64) decode
    (64, 8, 1408, 2048),     # its down
    (64, 40, 2048, 1408),    # prefill, ragged row tiles
])
def test_fp8_grouped_gemm_kernel_matches_plain(cuda, E, C, K, N):
    """K-major block weights from quantize_blockwise, through the decode
    (C <= 32) and prefill paths."""
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(E, C, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_blockwise(
        torch.randn(E, K, N, device=cuda, generator=g) / math.sqrt(K))
    assert wq.data.stride(-2) == 1
    before = grouped_ops.fp8_grouped_gemm.launches
    out = grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale)
    assert grouped_ops.fp8_grouped_gemm.launches == before + 1
    _close(out, grouped_ops.fp8_grouped_gemm_plain(x, wq.data, wq.scale))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [8, 24, 32, 64])
def test_fp8_grouped_gemm_both_paths_agree(cuda, C):
    """Around the path threshold, the decode and the prefill path forced on
    the same call: both within 1 bf16 ulp of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(C)
    e, k, n = 4, 512, 256
    x = torch.randn(e, C, k, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_blockwise(
        torch.randn(e, k, n, device=cuda, generator=g) / math.sqrt(k))
    ref = grouped_ops.fp8_grouped_gemm_plain(x, wq.data, wq.scale)
    xq, sx = grouped_ops.scratch(x)
    grouped_ops.quantize_pass(x, xq, sx)
    bc = 8 if C <= 8 else 32
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for p in (grouped_ops.prefill_plan(e, C, n, sms),
              grouped_ops.decode_plan(e, C, n, bc)):
        out = torch.empty_like(ref)
        grouped_ops.gemm_pass(xq, sx, wq.data, wq.scale, out, p)
        _close(out, ref)


@pytest.mark.cuda
def test_fp8_grouped_gemm_kernel_refuses_a_row_major_weight(cuda):
    """An (E, K, N) row-major block payload raises, and launches nothing."""
    x = torch.randn(2, 8, 256, device=cuda).to(torch.bfloat16)
    wq = quant.quantize_blockwise(torch.randn(2, 256, 128, device=cuda))
    before = grouped_ops.fp8_grouped_gemm.launches
    with pytest.raises(ValueError, match="K-major"):
        grouped_ops.fp8_grouped_gemm(x, wq.data.contiguous(), wq.scale)
    assert grouped_ops.fp8_grouped_gemm.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "fp8kv"])
@pytest.mark.parametrize("ps,hd", [(8, 128), (32, 128), (64, 128), (16, 64),
                                   (32, 256)])
def test_paged_decode_kernel_matches_plain(cuda, quantized, ps, hd):
    """Shuffled pages, sentinel entries, empty rows and page-boundary
    lengths; GQA groups of 4 at head_dim 64, 128 and 256."""
    g = torch.Generator().manual_seed(ps + hd)
    kv, grp = 4, 4
    lengths = [0, 1, ps - 1, ps, ps + 1, 3 * ps, 0, 5 * ps - 1]
    n_p = max(ln // ps + 1 for ln in lengths)
    need = [0 if ln == 0 else ln // ps + 1 for ln in lengths]
    n_pages = sum(need) + 2
    perm = torch.randperm(n_pages, generator=g).tolist()
    tables = torch.full((len(lengths), n_p), n_pages, dtype=torch.int32)
    pos = torch.full(((n_pages + 1) * ps,), -1, dtype=torch.int32)
    for i, ln in enumerate(lengths):
        for e in range(need[i]):
            page = perm.pop()
            tables[i, e] = page
            for o in range(ps):
                if e * ps + o <= ln:
                    pos[page * ps + o] = e * ps + o
    k = torch.randn(pos.shape[0], kv, hd, generator=g)
    v = torch.randn(pos.shape[0], kv, hd, generator=g)
    cache = {"pos": pos}
    if quantized:
        cache["k"], cache["k_scale"] = quant.quantize_kv(k)
        cache["v"], cache["v_scale"] = quant.quantize_kv(v)
    else:
        cache["k"], cache["v"] = k.to(torch.bfloat16), v.to(torch.bfloat16)
    q = torch.randn(len(lengths), 1, kv * grp, hd, generator=g).to(
        torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32)
    ref = decode_ops.paged_decode_attention(q, cache, tables, lens,
                                            page_size=ps)
    out = decode_ops.paged_decode_attention(
        q.to(cuda), {n: t.to(cuda) for n, t in cache.items()},
        tables.to(cuda), lens.to(cuda), page_size=ps)
    torch.testing.assert_close(out.float().cpu(), ref.float(), rtol=ULP,
                               atol=ULP)
    assert out[0].abs().max().item() == 0 and out[6].abs().max().item() == 0


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "fp8kv"])
@pytest.mark.parametrize("n_branches", [2, 4, 8, 10, 16])
def test_paged_decode_kernel_matches_plain_tree(cuda, quantized, n_branches):
    """Tree decode, the kernel's whole function: ``starts`` and a branch
    stride (a row sees the shared prefix and its own branch's span), C*G =
    8, 16, 32, 40 or 64 rows per KV head (one, two or four m16 row tiles,
    40 with a part-empty last tile), an empty slot, a start on a page
    boundary."""
    g = torch.Generator().manual_seed(n_branches)
    kv, grp, hd, ps, stride = 4, 4, 128, 32, 3
    starts = torch.tensor([100, 0, 64, 37, 250, 5], dtype=torch.int32)
    lengths = starts + n_branches * stride - 1
    lengths[1] = 0
    b = len(starts)
    n_p = int(lengths.max()) // ps + 1
    need = [0 if i == 1 else int(ln) // ps + 1 for i, ln in enumerate(lengths)]
    n_pages = sum(need) + 2
    perm = torch.randperm(n_pages, generator=g).tolist()
    tables = torch.full((b, n_p), n_pages, dtype=torch.int32)
    pos = torch.full(((n_pages + 1) * ps,), -1, dtype=torch.int32)
    for i in range(b):
        for e in range(need[i]):
            page = perm.pop()
            tables[i, e] = page
            for o in range(ps):
                if e * ps + o <= lengths[i]:
                    pos[page * ps + o] = e * ps + o
    k = torch.randn(pos.shape[0], kv, hd, generator=g)
    v = torch.randn(pos.shape[0], kv, hd, generator=g)
    if quantized:
        (k, ks), (v, vs) = quant.quantize_kv(k), quant.quantize_kv(v)
    else:
        k, v, ks, vs = k.to(torch.bfloat16), v.to(torch.bfloat16), None, None
    q = torch.randn(b, kv, n_branches * grp, hd, generator=g).to(
        torch.bfloat16)
    args = [q, k, v, pos, ks, vs, tables, lengths, starts]
    kw = dict(page_size=ps, group=grp, branch_stride=stride,
              scale=1.0 / math.sqrt(hd))
    ref = decode_ops.paged_decode_plain(*args, **kw)
    before = decode_ops.paged_decode.launches
    out = decode_ops.paged_decode(
        *[a.to(cuda) if a is not None else None for a in args], **kw)
    assert decode_ops.paged_decode.launches == before + 1
    torch.testing.assert_close(out.float().cpu(), ref.float(), rtol=ULP,
                               atol=ULP)
    assert out[1].abs().max().item() == 0


@pytest.mark.cuda
def test_paged_decode_kernel_refuses_more_rows_than_it_holds(cuda):
    """Above ``MAX_ROWS`` query rows per KV head the wrapper raises before
    any launch."""
    kv, hd, ps, rows = 2, 128, 32, decode_ops.MAX_ROWS + 4
    n_pos = 2 * ps
    q = torch.zeros(1, kv, rows, hd, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(n_pos, kv, hd, dtype=torch.bfloat16, device=cuda)
    ints = dict(dtype=torch.int32, device=cuda)
    before = decode_ops.paged_decode.launches
    with pytest.raises(ValueError, match="rows per head"):
        decode_ops.paged_decode(
            q, k, k.clone(), torch.full((n_pos,), -1, **ints), None, None,
            torch.ones(1, 1, **ints), torch.zeros(1, **ints),
            torch.zeros(1, **ints), page_size=ps, group=4, branch_stride=2,
            scale=1.0 / math.sqrt(hd))
    assert decode_ops.paged_decode.launches == before


def _topk_rows(B, V, dtype):
    """Random rows plus, where B allows, a row of ties, a row of +-0.0 and
    negatives, and a row of equal values (the candidate list overflows)."""
    g = torch.Generator().manual_seed(V)
    x = torch.randn(B, V, generator=g) * 7
    if B > 0:
        x[0] = torch.randint(-3, 4, (V,), generator=g).float()      # ties
    if B > 1:
        # -0.0 and negatives with a few +0.0 columns: the k-th key falls
        # among the -0.0 ties (keys rank -0.0 below +0.0)
        x[1] = -torch.randint(0, 3, (V,), generator=g).float()
        x[1, ::1500] = 0.0
    if B > 2:
        x[2] = 1.5
    return x.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("B,V,k,dtype", [
    (32, 8256, 8, torch.float32),      # the engine's select
    (16, 8192, 64, torch.float32),
    (8, 4000, 16, torch.bfloat16),
    (3, 257, 4, torch.float32),        # f32 V = 257: scalar loads
    (4, 8256, 1024, torch.float32),    # k = MAX_K
    (3, 257, 257, torch.float32),      # k = V
    (5, 4001, 16, torch.bfloat16),     # odd V in bf16: scalar loads
    (4, 2049, 8, torch.float32),       # 1 column past a block, 2047 pad
    (3, 65536, 32, torch.float32),     # past two blocks' registers: tiles
    (3, 20000, 8, torch.bfloat16),     # two tiles
    (1, 32768, 8, torch.float32),      # two tiles, one row
    (1, 8256, 8, torch.float32),       # B = 1
    (128, 8256, 8, torch.float32),     # more rows than SMs
    (2, 5, 3, torch.float32),          # rows shorter than a warp's keys
    (3, 1, 1, torch.bfloat16),
    (4, 33, 33, torch.float32),
])
def test_radix_topk_kernel_matches_plain(cuda, B, V, k, dtype):
    """Random rows plus a row of ties, a row of +-0.0 and negatives and a
    row of equal values: identical values and indices."""
    x = _topk_rows(B, V, dtype)
    before = topk_ops.radix_topk.launches
    vals, idx = topk_ops.radix_topk(x.to(cuda), k)
    assert topk_ops.radix_topk.launches == before + 1
    ref_v, ref_i = topk_ops.radix_topk_plain(x, k)
    assert torch.equal(idx.cpu(), ref_i)
    assert torch.equal(vals.cpu().view(torch.int32), ref_v.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_radix_topk_kernel_unaligned_rows(cuda, dtype):
    """Rows that start off a 16-byte boundary take scalar loads."""
    x = _topk_rows(4, 8256, dtype)
    flat = torch.cat([x.flatten()[:1], x.flatten()]).to(cuda)
    xu = flat[1:].view(4, 8256)
    assert xu.data_ptr() % 16 != 0
    assert not topk_ops.plan(4, 8256, dtype, False).vec
    vals, idx = topk_ops.radix_topk(xu, 8)
    ref_v, ref_i = topk_ops.radix_topk_plain(x, 8)
    assert torch.equal(idx.cpu(), ref_i)
    assert torch.equal(vals.cpu().view(torch.int32), ref_v.view(torch.int32))


def _attn_fp8(k, v, fp8):
    """``batch_attention``'s K/V arguments: bf16 K/V, or (``fp8``) their
    e4m3 payloads with the scales as keywords."""
    if not fp8:
        return k, v, {}
    k8, ks = quant.quantize_kv(k.float())
    v8, vs = quant.quantize_kv(v.float())
    return k8, v8, dict(k_scale=ks, v_scale=vs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Kv,hd,S,window,fp8,splits,layout", [
    (32, 1, 16, 4, 128, 388, 0, False, None, "ragged"),  # engine's decode
    (2, 64, 16, 4, 128, 96, 0, False, None, "ragged"),   # prefill-shaped
    (4, 1, 8, 2, 64, 300, 48, False, None, "ragged"),    # windowed decode
    (4, 64, 16, 4, 128, 388, 0, False, None, "ragged"),  # T = 64, full width
    (32, 1, 16, 4, 128, 388, 64, False, None, "ragged"),  # windowed, engine
    (3, 2, 8, 2, 256, 200, 0, False, None, "ragged"),    # hd 256: 64-key tiles
    (32, 1, 16, 4, 128, 388, 0, True, None, "ragged"),   # fp8 cache, engine
    (4, 64, 16, 4, 128, 388, 0, True, None, "ragged"),   # fp8, T = 64
    (3, 2, 8, 2, 256, 200, 0, True, None, "ragged"),     # fp8, hd 256
    (32, 1, 16, 4, 128, 388, 0, False, 2, "ragged"),     # 2 splits
    (32, 1, 16, 4, 128, 388, 0, True, 4, "ragged"),      # fp8, 4 splits
    (4, 1, 8, 2, 64, 1000, 0, False, 4, "short"),        # splits of empty keys
    (4, 1, 8, 2, 64, 1000, 0, True, 8, "short"),         # the same, fp8
    (4, 1, 8, 2, 64, 256, 64, False, 2, "ring"),         # window over a split
    (4, 1, 8, 2, 64, 256, 64, True, 2, "ring"),          # boundary, fp8
])
def test_batch_attention_kernel_matches_plain(cuda, B, T, H, Kv, hd, S,
                                              window, fp8, splits, layout):
    """Ragged occupancy (empty keys, an empty row) against the plain
    version's one-block softmax: 1 bf16 ulp of the largest output; over
    bf16 K/V or an fp8 cache's payload and scales (the plain version
    dequantizes with ``dequantize_kv``), with the plan's key splits or
    forced ones: rows shorter than a third of S (``short``: the last
    splits hold only empty keys), and a shared ring wrapped past S whose
    window of keys straddles the split boundary (``ring``)."""
    g = torch.Generator().manual_seed(S)
    q = torch.randn(B, T, H, hd, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Kv, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Kv, hd, generator=g).to(torch.bfloat16)
    if layout == "ring":          # newest slot 150: the window holds 87..150
        last = 3 * S + 150
        pos = last - (last - torch.arange(S)) % S
        k_pos = pos.to(torch.int32)[None].expand(B, S).contiguous()
        q_pos = torch.full((B, T), last, dtype=torch.int32)
        seen = last - pos < window
        assert seen[:S // 2].any() and seen[S // 2:].any()
    else:
        top = S // 3 if layout == "short" else S
        lengths = torch.randint(1, top, (B,), generator=g)
        lengths[0] = 0
        k_pos = torch.arange(S)[None].expand(B, S)
        k_pos = torch.where(k_pos < lengths[:, None], k_pos,
                            -1).to(torch.int32)
        q_pos = (lengths[:, None] - T + torch.arange(T)[None]).clamp_min(-1)
        q_pos = q_pos.to(torch.int32).contiguous()
        k_pos = k_pos.contiguous()
    if splits is not None:
        p = attn_ops.plan(B, T, H, Kv, S, hd, 132, splits)
        assert p.splits == splits
        if layout == "short":
            assert p.ranges()[-1][0] * p.tile >= S // 3
    k, v, scales = _attn_fp8(k, v, fp8)
    scale = 1.0 / math.sqrt(hd)
    ref = attn_ops.batch_attention_plain(q, k, v, q_pos, k_pos, scale=scale,
                                         window=window, **scales)
    before = attn_ops.batch_attention.launches
    out = attn_ops.batch_attention(
        q.to(cuda), k.to(cuda), v.to(cuda), q_pos.to(cuda), k_pos.to(cuda),
        scale=scale, window=window, splits=splits,
        **{n: t.to(cuda) for n, t in scales.items()})
    assert attn_ops.batch_attention.launches == before + 1
    assert out.shape == (B, T, H * hd) and out.dtype == torch.bfloat16
    if layout != "ring":
        assert out[0].abs().max().item() == 0
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("fp8", [False, True])
def test_batch_attention_split_is_identical_across_calls(cuda, fp8):
    """llama3-8b's decode shape (S = 4112: 4 key splits on 132 SMs, at
    least 2 on any card): 20 eager calls and a CUDA-graph replay of one
    call give outputs bit-identical to the first (the splits combine in a
    fixed order, with no float atomics), and the split counters are left
    zero, so the replay combines like an eager call."""
    B, H, Kv, hd, S = 4, 32, 8, 128, 4112
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(B, 1, H, hd, device=cuda, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Kv, hd, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Kv, hd, device=cuda, generator=g).to(torch.bfloat16)
    k, v, scales = _attn_fp8(k, v, fp8)
    k_pos = torch.arange(S, dtype=torch.int32, device=cuda)[None].expand(
        B, S).contiguous()
    q_pos = torch.full((B, 1), S - 1, dtype=torch.int32, device=cuda)
    assert attn_ops.plan(B, 1, H, Kv, S, hd, gemm_ops.sm_count(cuda)).splits \
        >= 2

    def call():
        return attn_ops.batch_attention(q, k, v, q_pos, k_pos,
                                        scale=hd ** -0.5, **scales)

    assert _repeat_identical(call, 20) == 0
    first = call()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured.view(torch.int16), first.view(torch.int16))
    assert torch.equal(call().view(torch.int16), first.view(torch.int16))
    _close(first, attn_ops.batch_attention_plain(q, k, v, q_pos, k_pos,
                                                 scale=hd ** -0.5, **scales))


@pytest.mark.cuda
def test_contiguous_decode_reads_fp8_in_the_kernel(cuda, monkeypatch):
    """A decode step of the contiguous layout on the card under
    ``use_attention_kernel`` over an fp8 cache: ``batch_attention`` reads
    the payload and scales in its tile load, so the step runs
    ``dequantize_kv`` 0 times and launches the kernel once a layer, with
    finite logits."""
    import numpy as np
    from repro_torch.configs.base import OneRecConfig, TransformerConfig
    from repro_torch.layers import attention
    from repro_torch.models import onerec
    from repro_torch.serving.executor import PhaseExecutor
    cfg = OneRecConfig(     # head_dim 64
        name="onerec-fp8-read-test", history_len=8,
        transformer=TransformerConfig(
            name="onerec-fp8-read-test-backbone",
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
            d_ff=256, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=128, capacity_factor=64.0, ep_degree=4,
            max_seq_len=64, remat=False, use_attention_kernel=True),
        serve_batch=4, beam_width=4)
    ex = PhaseExecutor(onerec.init_onerec(0, cfg, device=cuda), cfg,
                       n_slots=4, device=cuda, paged=False,
                       kv_dtype="float8_e4m3fn")
    rng = np.random.default_rng(3)
    hists = [rng.integers(0, 192, size=n * cfg.n_codebooks).astype(np.int32)
             for n in (8, 3, 5)]
    profs = [rng.normal(size=onerec.PROFILE_DIM).astype(np.float32)
             for _ in hists]
    logits = ex.prefill_insert(hists, profs, [2, 0, 3])
    calls = []
    real = quant.dequantize_kv

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(quant, "dequantize_kv", counted)
    monkeypatch.setattr(attention, "dequantize_kv", counted)
    lengths = np.zeros(4, np.int32)
    lengths[[2, 0, 3]] = [len(h) + 1 for h in hists]
    toks = np.zeros((4, 1), np.int32)
    toks[[2, 0, 3], 0] = logits.float().argmax(-1).cpu().numpy()[:3]
    before = attn_ops.batch_attention.launches
    out = ex.decode(toks, lengths)
    assert calls == []
    assert attn_ops.batch_attention.launches \
        == before + cfg.transformer.n_layers
    assert torch.isfinite(out.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Kv,hd,S,window,last", [
    (4, 4, 1, 256, 512, 512, 4101),    # gemma3-1b local: a wrapped ring
    (4, 4, 1, 256, 4112, 0, 4101),     # gemma3-1b global
    (4, 16, 16, 128, 4112, 0, 4100),   # qwen2 / deepseek-moe: G = 1
    (4, 56, 8, 128, 4112, 0, 4111),    # deepseek-coder-33b: G = 7
])
def test_batch_attention_kernel_at_zoo_shapes(cuda, B, H, Kv, hd, S, window,
                                             last):
    """The shared-index decode of the zoo: one query at position ``last``
    over a shared cache whose slot s holds position p with p % S == s (a
    ring wrapped past S when ``last`` >= S; slots past ``last`` empty
    otherwise), against the plain version's blocks of the JAX wrapper."""
    g = torch.Generator().manual_seed(S + hd)
    q = torch.randn(B, 1, H, hd, generator=g).to(torch.bfloat16)
    k = torch.randn(B, S, Kv, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(B, S, Kv, hd, generator=g).to(torch.bfloat16)
    slot = torch.arange(S)
    pos = last - (last - slot) % S                  # the newest p % S == s
    k_pos = torch.where(pos >= 0, pos, -1).to(torch.int32)[None].expand(
        B, S).contiguous()
    q_pos = torch.full((B, 1), last, dtype=torch.int32)
    assert window == 0 or bool((k_pos[0, 1:] < k_pos[0, :-1]).any())
    scale = 1.0 / math.sqrt(hd)
    ref = attn_ops.batch_attention_plain(q, k, v, q_pos, k_pos, scale=scale,
                                         window=window)
    out = attn_ops.batch_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                                   q_pos.to(cuda), k_pos.to(cuda),
                                   scale=scale, window=window)
    _close(out, ref)


# ---------------------------------------------------------------------------
# Run-to-run identity (ROADMAP C3)
# ---------------------------------------------------------------------------


def _repeat_identical(fn, n):
    """``n`` calls of ``fn`` give outputs bit-identical to the first; the
    count of those that do not."""
    first = fn()
    bad = 0
    for _ in range(n - 1):
        bad += not torch.equal(fn().view(torch.int16), first.view(torch.int16))
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape,n", [
    ("fp8_gemm", (1, 512, 256, 512), 500),        # phase 3's q/o prefill
    ("fp8_gemm", (1, 32, 2048, 2048), 500),       # decode, split K
    ("fp8_gemm", (1, 12320, 2048, 2048), 50),     # a full-width prefill
    ("fp8_grouped_gemm", (8, 256, 256, 256), 500),
    ("fp8_grouped_gemm", (16, 8, 2048, 4096), 500),
    ("fp8_grouped_gemm", (16, 3080, 2048, 4096), 20),
])
def test_gemm_kernel_repeats_are_bit_identical(cuda, kernel, shape, n):
    """The same inputs through a GEMM kernel ``n`` times: every output
    bit-identical to the first.  A pipeline stage read before its load
    landed, or a read of memory nobody wrote, would break this."""
    e, m, k, n_out = shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(e, m, k, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(e, k, n_out, device=cuda, generator=g) / math.sqrt(k)
    if kernel == "fp8_gemm":
        wq = quant.quantize_per_channel(w)
        sw = wq.scale.reshape(e, n_out).contiguous()
        assert _repeat_identical(
            lambda: gemm_ops.fp8_gemm(x, wq.data, sw), n) == 0
    else:
        wq = quant.quantize_blockwise(w)
        assert _repeat_identical(
            lambda: grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale),
            n) == 0


def _chip_smoke():
    """``chip_smoke.py`` (the repo root on the path), for phase 3's
    setup."""
    import os
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _fill_free_blocks(device, seed):
    """Leave the caching allocator's free blocks, small and large, holding
    random bytes."""
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = torch.randint(256, 1 << 20, (2000,), generator=torch.Generator(
    ).manual_seed(seed)).tolist() + [64 << 20] * 4
    held = [torch.empty(s, dtype=torch.uint8, device=device).random_(
        0, 256, generator=g) for s in sizes]
    torch.cuda.synchronize(device)
    del held


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["paged", "paged-return"])
def test_phase3_case_is_run_to_run_identical(cuda, case):
    """``chip_smoke.py`` phase 3's first case and its return-visit case
    served six times in one process, the allocator's free blocks refilled
    with random bytes before each: the items and the top-2 first-token
    logits of every request are bit-identical across the six."""
    from repro_torch.serving import EngineConfig, ServingEngine
    cs = _chip_smoke()
    cfg, params, reqs, ecfg = cs._phase3_setup(case)
    runs = []
    for i in range(6):
        _fill_free_blocks(cuda, i)
        engine = ServingEngine(params, cfg, EngineConfig(**ecfg),
                               device=cuda)
        seeds = cs._record_seeds(engine)
        outs, _ = cs._serve_case(engine, case, cfg, reqs)
        runs.append(([o.tolist() for o in outs], seeds))
    assert all(r == runs[0] for r in runs[1:])


# ---------------------------------------------------------------------------
# The static mode of fp8_gemm, the int8 product, and the GEMMs' f32 sums
# (ROADMAP C2)
# ---------------------------------------------------------------------------


# the recsys family's per-channel fp8 kernels under the paper's policy
# (K, N): two-tower's towers, MIND's proj tower, DIN's and DIEN's score MLPs
RECSYS_GEMMS = [(2304, 1024), (1024, 512), (512, 256), (256, 1024),
                (576, 64), (180, 200), (200, 80), (80, 1), (270, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [100, 512], ids=["decode", "prefill"])
@pytest.mark.parametrize("K,N", RECSYS_GEMMS)
def test_fp8_gemm_at_recsys_shapes(cuda, K, N, M):
    """Any K and N (C5): PTQ's padded K-major payload, dynamic and static
    scales, through the decode (split K) and prefill paths."""
    g = torch.Generator(device=cuda).manual_seed(K + N)
    x = torch.randn(1, M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_per_channel(
        torch.randn(1, K, N, device=cuda, generator=g) / math.sqrt(K))
    sw = wq.scale.reshape(1, N).contiguous()
    _close(gemm_ops.fp8_gemm(x, wq.data, sw),
           gemm_ops.fp8_gemm_plain(x, wq.data, sw))
    s = (x.float().abs().max() / 448.0).reshape(1, 1)
    _close(gemm_ops.fp8_gemm(x, wq.data, sw, act_scale=s),
           gemm_ops.fp8_gemm_plain(x, wq.data, sw, act_scale=s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [5, 300], ids=["decode", "prefill"])
@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("K", [1, 7, 180])
def test_fp8_gemm_any_k_and_n_on_unaligned_rows(cuda, K, N, M):
    """K and N far from any tile (C5), x starting 2 bytes past a 16-byte
    boundary, so no row is read with 16-byte loads; batch of 2."""
    g = torch.Generator(device=cuda).manual_seed(K * N + M)
    buf = torch.randn(2 * M * K + 1, device=cuda, generator=g).to(
        torch.bfloat16)
    x = buf[1:].view(2, M, K)
    assert x.data_ptr() % 16 == 2
    wq = quant.quantize_per_channel(
        torch.randn(2, K, N, device=cuda, generator=g))
    sw = wq.scale.reshape(2, N).contiguous()
    out = gemm_ops.fp8_gemm(x, wq.data, sw)
    assert out.shape == (2, M, N)
    _close(out, gemm_ops.fp8_gemm_plain(x, wq.data, sw))


@pytest.mark.cuda
@pytest.mark.parametrize("E,M,K,N", [
    (1, 32, 2048, 2048),     # decode
    (1, 32, 272, 96),        # a ragged last 128-deep chunk
    (1, 4100, 2048, 512),    # prefill
])
def test_fp8_gemm_static_mode_matches_plain(cuda, E, M, K, N):
    """One calibrated scale for every row: the kernel's static mode against
    its plain version (the cast with the scale, ``(acc * s) * sw``)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(E, M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_per_channel(
        torch.randn(E, K, N, device=cuda, generator=g))
    sw = wq.scale.reshape(E, N).contiguous()
    s = (x.float().abs().max() / 300.0).reshape(1, 1)   # some rows clip
    out = gemm_ops.fp8_gemm(x, wq.data, sw, act_scale=s)
    ref = gemm_ops.fp8_gemm_plain(x, wq.data, sw, act_scale=s)
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (32, 512, 2048),         # o_proj's row-parallel K-slice at decode
    (12320, 512, 2048),      # ... and at the prefill_b32 step
    (300, 180, 200),         # an unaligned K (rows off a 16-byte boundary)
])
def test_fp8_gemm_given_scale_mode_matches_plain(cuda, M, K, N):
    """The given-scale mode (row scales read, not reduced: tensor
    parallelism's row-parallel products) on a K-slice with the whole rows'
    scales, f32 and bf16 out, against the plain version; its quantized
    payload is the K-slice of the whole rows' dynamic-mode payload."""
    g = torch.Generator(device=cuda).manual_seed(25)
    x = torch.randn(1, M, 4 * K, device=cuda, generator=g).to(torch.bfloat16)
    rows = quant.amax_to_scale(x.float().abs().amax(-1))
    xs = x[..., K:2 * K].contiguous()
    wq = quant.quantize_per_channel(
        torch.randn(1, K, N, device=cuda, generator=g) / math.sqrt(K))
    sw = wq.scale.reshape(1, N).contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        out = gemm_ops.fp8_gemm(xs, wq.data, sw, out_dtype=dtype,
                                row_scale=rows)
        _close(out, gemm_ops.fp8_gemm_plain(xs, wq.data, sw, dtype,
                                            row_scale=rows))
    if K % 128 == 0:
        _, _, xh, sx, _, _ = gemm_ops.scratch(xs, wq.data)
        gemm_ops.quantize_pass(xs, xh, sx, row_scale=rows)
        _, _, xh_all, sx_all, _, _ = gemm_ops.scratch(x, torch.empty(
            (1, 4 * K, N), dtype=torch.float8_e4m3fn, device=cuda))
        gemm_ops.quantize_pass(x, xh_all, sx_all)
        assert torch.equal(sx, sx_all)
        assert torch.equal(xh, xh_all[..., K:2 * K])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(32, 2048, 8256), (300, 256, 200)])
def test_fp8_gemm_f32_output_matches_plain(cuda, M, K, N):
    """An fp8 logits head (f32 output, OneRec-V2's vocabulary at decode):
    the epilogue's f32 store against the plain version."""
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(1, M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_per_channel(
        torch.randn(1, K, N, device=cuda, generator=g))
    sw = wq.scale.reshape(1, N).contiguous()
    out = gemm_ops.fp8_gemm(x, wq.data, sw, out_dtype=torch.float32)
    ref = gemm_ops.fp8_gemm_plain(x, wq.data, sw, torch.float32)
    assert out.dtype == torch.float32
    _close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(8, 256, 128), (32, 2048, 512),
                                   (300, 384, 200)])
def test_int8_linear_on_the_card_equals_the_cpu(cuda, M, K, N):
    """``torch._int_mm`` sums exactly, so the card's W8A8 product equals
    the CPU's bit for bit (8 rows: padded above 16 for ``_int_mm``)."""
    import dataclasses
    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(2, M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = quant.quantize_per_channel_int8(
        torch.randn(K, N, device=cuda, generator=g))
    out = quant.int8_linear(x, w)
    ref = quant.int8_linear(x.cpu(), dataclasses.replace(
        w, data=w.data.cpu(), scale=w.scale.cpu()))
    assert torch.equal(out.cpu().view(torch.int16), ref.view(torch.int16))


def _off_exact(out, exact):
    e = exact.float().to(torch.bfloat16)
    return (out != e).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,shape", [
    ("fp8_gemm", (1, 32, 2048, 2048)),
    ("fp8_gemm", (1, 4100, 2048, 2048)),
    ("fp8_grouped_gemm", (16, 8, 2048, 4096)),
    ("fp8_grouped_gemm", (8, 300, 256, 512)),
])
def test_gemm_kernels_sum_in_f32(cuda, kernel, shape):
    """At most 0.1% of the kernels' bf16 outputs differ from the same
    function summed in float64 and rounded once (the f32 sums of the Pallas
    kernels; e4m3 wgmma sums put 2.4-6.8% off)."""
    e, m, k, n = shape
    g = torch.Generator(device=cuda).manual_seed(8)
    x = torch.randn(e, m, k, device=cuda, generator=g).to(torch.bfloat16)
    w = torch.randn(e, k, n, device=cuda, generator=g) / math.sqrt(k)
    if kernel == "fp8_gemm":
        wq = quant.quantize_per_channel(w)
        sw = wq.scale.reshape(e, n).contiguous()
        out = gemm_ops.fp8_gemm(x, wq.data, sw)
        xq = quant.quantize_per_token(x)
        exact = (xq.data.double() @ wq.data.double()) * xq.scale.double() \
            * sw.double()[:, None, :]
    else:
        wq = quant.quantize_blockwise(w)
        out = grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale)
        xq = quant.quantize_blockwise(x, act=True)
        xd = xq.data.double().reshape(e, m, k // 128, 128)
        wd = wq.data.double().reshape(e, k // 128, 128, n)
        swn = wq.scale.double().repeat_interleave(128, dim=-1)
        exact = torch.zeros(e, m, n, dtype=torch.float64, device=cuda)
        for kb in range(k // 128):
            exact += (xd[:, :, kb] @ wd[:, kb]) \
                * xq.scale[:, :, kb, None].double() * swn[:, None, kb]
    assert _off_exact(out, exact) <= 1e-3


_PAGED_CASE = """
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
sys.path.insert(0, {src!r})
import chip_smoke as cs
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.executor import PhaseExecutor
dev = torch.device("cuda")
cfg, params, reqs, ecfg = cs._phase3_setup("paged")
engine = ServingEngine(params, cfg, EngineConfig(**ecfg), device=dev)
seeds = cs._record_seeds(engine)
outs, _ = cs._serve_case(engine, "paged", cfg, reqs)
ex = PhaseExecutor(params, cfg, n_slots=8, device=dev,
                   kv_dtype="float8_e4m3fn", page_size=32, n_pages=16)
hists = [np.asarray(r["tokens"]) for r in reqs[:8]]
for s, h in enumerate(hists):
    assert ex.grant_slot(s, len(h) + 3)
logits = ex.prefill_insert(hists, [np.asarray(r["profile"]) for r in
                                   reqs[:8]], list(range(8)))
lengths = np.asarray([len(h) + 1 for h in hists], np.int32)
steps = [hashlib.sha256(logits.float().cpu().numpy().tobytes()).hexdigest()]
for _ in range(cfg.decode_len - 1):
    toks = np.argmax(logits.float().cpu().numpy(), -1).astype(np.int32)
    logits = ex.decode(toks[:, None], lengths)
    lengths = lengths + 1
    steps.append(hashlib.sha256(
        logits.float().cpu().numpy().tobytes()).hexdigest())
print(json.dumps(dict(items=[o.tolist() for o in outs],
                      seeds={{str(k): v for k, v in seeds.items()}},
                      logits=steps)))
"""


def paged_case_difference(a: dict, b: dict):
    """Where two runs of ``_PAGED_CASE`` first differ: the field (items,
    the top-2 first-token logits, the teacher-forced logits) and the
    request or step; None where they agree."""
    for k, (x, y) in enumerate(zip(a["items"], b["items"])):
        if x != y:
            return f"items of request {k}: {x} != {y}"
    if len(a["items"]) != len(b["items"]):
        return "the number of requests served"
    for key in sorted(set(a["seeds"]) | set(b["seeds"])):
        if a["seeds"].get(key) != b["seeds"].get(key):
            return (f"top-2 first-token logits of request {key}: "
                    f"{a['seeds'].get(key)} != {b['seeds'].get(key)}")
    for step, (x, y) in enumerate(zip(a["logits"], b["logits"])):
        if x != y:
            what = "the prefill" if step == 0 else f"decode step {step}"
            return f"teacher-forced logits of {what}"
    return None


def run_paged_case(root: str):
    """One fresh process serving ``_PAGED_CASE``; returns its record."""
    import json
    import os
    import subprocess
    import sys
    code = _PAGED_CASE.format(root=root, src=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, timeout=600)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_phase3_paged_case_is_identical_across_processes(cuda):
    """ROADMAP C3: ``chip_smoke.py`` phase 3's ``paged`` case served in
    three fresh processes of the port: the items, the top-2 first-token
    logits and the teacher-forced logits (prefill and decode steps) are
    bit-identical across them.  Each run's record is kept under
    ``build/c9/``; a difference is reported by field and request or step
    (ROADMAP C9)."""
    import json
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    keep = os.path.join(root, "build", "c9")
    os.makedirs(keep, exist_ok=True)
    runs = []
    for i in range(3):
        runs.append(run_paged_case(root))
        with open(os.path.join(keep, f"run{i}.json"), "w") as f:
            json.dump(runs[-1], f)
    for i, r in enumerate(runs[1:], 1):
        where = paged_case_difference(runs[0], r)
        assert where is None, (f"run {i} differs from run 0 in {where} "
                               f"(records under {keep})")


# ---------------------------------------------------------------------------
# Raw products on the tensor cores (ROADMAP C6), fixed-order segment sums
# (C7), the steady-state guard and the distribution statistics (N9a, N10a)
# ---------------------------------------------------------------------------


def _off_exact(out, exact):
    """Share of outputs off the bf16 rounding of the float64 product."""
    ref = exact.float().to(torch.bfloat16)
    return (out.to(torch.bfloat16) != ref).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,f32_out", [
    (32, 2048, 8256, True),       # OneRec-V2's lm_head at a decode step
    (4100, 2048, 16, True),       # its router
    (4, 4096, 32000, True),       # an LM head at 4 decode rows
    (3000, 2304, 1024, False),    # two-tower's user tower
    (5000, 72, 80, False),        # DIN's attention MLP
])
def test_raw_products_run_on_the_tensor_cores(cuda, M, K, N, f32_out):
    """``matmul_any`` of a raw bf16 weight on the card: bf16 operands (no
    f32 copies), the output dtype asked for, at most 0.1% of outputs off
    the bf16 rounding of the float64 product (the GEMM kernels' bound)."""
    g = torch.Generator(device=cuda).manual_seed(M + N)
    x = torch.randn(M, K, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(K, N, device=cuda, generator=g) / math.sqrt(K)).to(
        torch.bfloat16)
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    out = quant.matmul_any(x, w, out_dtype=out_dtype)
    assert out.dtype == out_dtype and out.shape == (M, N)
    assert _off_exact(out, x.double() @ w.double()) <= 1e-3
    x3 = x.reshape(2, M // 2, K)
    out3 = quant.matmul_any(x3, w, out_dtype=out_dtype)
    assert torch.equal(out3.reshape(M, N), out)


@pytest.mark.cuda
def test_raw_expert_path(cuda):
    """The raw grouped expert product (``moe._grouped_matmul``) within the
    off-exact bound, and a whole raw MoE layer on the card within 1 bf16
    ulp of its CPU result (the CPU's f32 product of the same values)."""
    from repro_torch import tree
    from repro_torch.layers import moe
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4, 96, 512, device=cuda, generator=g).to(torch.bfloat16)
    w = (torch.randn(4, 512, 256, device=cuda, generator=g) / 512 ** 0.5
         ).to(torch.bfloat16)
    out = moe._grouped_matmul(x, w)
    assert out.dtype == torch.bfloat16
    assert _off_exact(out, torch.bmm(x.double(), w.double())) <= 1e-3
    spec = moe.make_moe_spec(8, 2, 256, 512, capacity_factor=4.0,
                             ep_degree=8)
    params = moe.init_moe(torch.Generator(device=cuda).manual_seed(6), spec,
                          device=cuda)
    h = torch.randn(2, 64, 256, device=cuda, generator=g).to(torch.bfloat16)
    card = moe.apply_moe(params, h, spec)
    cpu = moe.apply_moe(tree.map_with_path(lambda _, t: t.cpu(), params),
                        h.cpu(), spec)
    _close(card, cpu)


@pytest.mark.cuda
def test_egnn_forwards_and_bags_are_bit_identical(cuda):
    """Segment sums in a fixed order (C7): two EGNN forwards of one input
    are bit-identical, and so are two ``sum`` / ``mean`` bag calls, which
    also equal the CPU's (``index_add_`` adds each segment in row order
    there, as the sort + ``segment_reduce`` does on the card)."""
    from repro_torch.configs import registry
    from repro_torch.data import graph
    from repro_torch.layers import embedding
    from repro_torch.models import gnn
    cfg = registry.get_arch("egnn").reduced_config()
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in graph.graph_batch(
        graph.random_geometric_graph(500, 8, 12, seed=0)).items()}
    params = gnn.init_egnn(torch.Generator(device=cuda).manual_seed(0), cfg,
                           12, 16, device=cuda)
    h_a, x_a = gnn.egnn_forward(params, batch, cfg)
    h_b, x_b = gnn.egnn_forward(params, batch, cfg)
    assert torch.equal(h_a, h_b) and torch.equal(x_a, x_b)
    g = torch.Generator(device=cuda).manual_seed(1)
    table = torch.randn(5000, 64, device=cuda, generator=g)
    ids = torch.randint(0, 5000, (20000,), device=cuda, generator=g)
    seg = torch.randint(0, 700, (20000,), device=cuda, generator=g)
    for mode in ("sum", "mean"):
        def call(t, i, s):
            return embedding.embedding_bag({"table": t}, i, s, n_bags=700,
                                           mode=mode,
                                           compute_dtype=torch.float32)
        first = call(table, ids, seg)
        assert torch.equal(first, call(table, ids, seg))
        assert torch.equal(first.cpu(), call(table.cpu(), ids.cpu(),
                                             seg.cpu()))


@pytest.mark.cuda
def test_guard_over_a_replayed_paged_engine(cuda):
    """The port-side form of ``tests/test_steady_state.py`` on the card: a
    paged fp8-KV engine with fused decode, warmed on the requests it
    replays, steps >= 8 times under ``steady_state()`` with no
    unsanctioned host sync and no kernel build, and gives the warmup's
    items again; a stray ``.item()`` under the guard raises, and the sync
    debug mode is restored after it."""
    import numpy as np
    from repro_torch.configs.base import OneRecConfig, TransformerConfig
    from repro_torch.models import onerec
    from repro_torch.serving import EngineConfig, ServingEngine
    from repro_torch.serving.requests import make_request
    cfg = OneRecConfig(     # head_dim 64: the kernel's smallest
        name="onerec-steady-test", history_len=8,
        transformer=TransformerConfig(
            name="onerec-steady-test-backbone",
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
            d_ff=256, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=128, capacity_factor=64.0, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)
    rng = np.random.default_rng(31)
    reqs = [make_request(rng.integers(0, 192, size=int(rng.integers(
        2, cfg.history_len + 1)) * cfg.n_codebooks),
        rng.normal(size=onerec.PROFILE_DIM)) for _ in range(12)]
    engine = ServingEngine(onerec.init_onerec(0, cfg, device=cuda), cfg,
                           EngineConfig(batch_size=4, n_slots=3,
                                        kv_dtype="float8_e4m3fn",
                                        page_size=8), device=cuda)
    warm, _ = engine.serve_requests(reqs)
    before = torch.cuda.get_sync_debug_mode()
    with engine.steady_state() as mon:
        out, stats = engine.serve_requests(reqs)
    assert stats["decode_steps"] >= 8
    assert stats["fused_decode_steps"] == stats["decode_steps"]
    assert mon.builds == 0 and mon.sanctioned > 0
    for a, b in zip(out, warm):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with engine.steady_state():
            torch.ones(4, device=cuda).sum().item()
    assert torch.cuda.get_sync_debug_mode() == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1000, 123457, 1 << 22])
def test_tensor_stats_on_the_card_match_the_cpu(cuda, n):
    """``core.stats.tensor_stats`` on the card: ``absmax`` and ``absp99``
    equal to the CPU's, the float64-summed variance within 1e-9."""
    from repro_torch.core import stats
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn(n, device=cuda, generator=g) * 3
    x[: n // 3] = x[: n // 3].round()                       # ties
    card, cpu = stats.tensor_stats("x", x), stats.tensor_stats("x", x.cpu())
    assert (card.numel, card.absmax, card.absp99) == \
        (cpu.numel, cpu.absmax, cpu.absp99)
    assert card.variance == pytest.approx(cpu.variance, rel=1e-9)


# ---------------------------------------------------------------------------
# Gradients, AdamW and the train step (N9b)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,f32_out", [
    ((700, 2048, 1100), False),     # both backward products chunked
    ((4100, 2048, 16), True),       # the router: f32 cotangent
    ((96, 300, 200), False),        # K, N within one chunk
    ((4, 96, 1024, 600), False),    # 3-D: the raw expert product
    ((16, 700, 128, 520), True),    # 3-D, f32 out (attention scores)
])
def test_raw_matmul_backward_matches_the_f64_transpose(cuda, shape,
                                                       f32_out):
    """``raw_matmul``'s backward on the card (``_CardProduct``): dA = dY
    Bᵀ and dB = Aᵀ dY in the operands' dtype, each at most 0.1% of its
    elements off the bf16 rounding of the float64 product."""
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    lead, k, n = shape[:-2], shape[-2], shape[-1]
    a = torch.randn(*lead, k, device=cuda, generator=g).to(torch.bfloat16)
    b = (torch.randn(*lead[:-1], k, n, device=cuda, generator=g)
         / math.sqrt(k)).to(torch.bfloat16)
    a.requires_grad_()
    b.requires_grad_()
    out_dtype = torch.float32 if f32_out else torch.bfloat16
    y = quant.raw_matmul(a, b, out_dtype)
    dy = torch.randn(y.shape, device=cuda, generator=g).to(out_dtype)
    y.backward(dy)
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    da = dy.double() @ b.detach().double().transpose(-1, -2)
    if b.ndim == 3:
        db = a.detach().double().transpose(-1, -2) @ dy.double()
    else:
        db = a.detach().double().reshape(-1, k).T @ dy.double().reshape(
            -1, n)
    assert _off_exact(a.grad, da) <= 1e-3
    assert _off_exact(b.grad, db) <= 1e-3


def _two_grads(fn, *leaves):
    """The gradients of ``fn(*leaves).sum()`` (scaled by a fixed random
    cotangent) twice: each backward's gradients."""
    out = []
    for _ in range(2):
        xs = [t.detach().clone().requires_grad_() for t in leaves]
        y = fn(*xs)
        ct = torch.randn(y.shape, device=y.device,
                         generator=torch.Generator(device=y.device
                                                   ).manual_seed(9))
        torch.autograd.backward(y, ct.to(y.dtype))
        out.append([x.grad for x in xs])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["gather_rows", "embed_tokens", "moe",
                                  "token_nll", "egnn", "egnn_chunked"])
def test_gather_backwards_are_bit_identical(cuda, site):
    """Every gather of the train path adds its backward in a fixed order
    (``gather_rows``: ``segment_sum``), so two backward passes give the
    same bits: the embedding tables, the MoE dispatch and combine, the
    loss's ``take_along_dim`` (one entry a row), the EGNN's edge gathers,
    and theirs in 10 chunks of 4096 edges (the gathers' sums carried
    across the chunks, ``RowGrads``, each chunk recomputed)."""
    from repro_torch.configs import registry
    from repro_torch.layers import embedding, moe
    from repro_torch.models import gnn
    from repro_torch.models import transformer as tfm
    g = torch.Generator(device=cuda).manual_seed(1)
    if site == "gather_rows":
        table = torch.randn(97, 64, device=cuda, generator=g)
        ids = torch.randint(0, 97, (20000,), device=cuda, generator=g)
        runs = _two_grads(lambda t: embedding.gather_rows(t, ids), table)
    elif site == "embed_tokens":
        cfg = registry.get_arch("llama3-8b").reduced_config()
        table = torch.randn(cfg.vocab_size, cfg.d_model, device=cuda,
                            generator=g)
        tok = torch.randint(0, 8, (16, 512), device=cuda, generator=g)
        runs = _two_grads(lambda t: tfm.embed_tokens(
            {"embed": {"table": t}}, tok, cfg), table)
    elif site == "moe":
        spec = moe.make_moe_spec(8, 4, 256, 512, capacity_factor=1.0,
                                 ep_degree=8)
        params = moe.init_moe(torch.Generator(device=cuda).manual_seed(2),
                              spec, device=cuda)
        x = torch.randn(4, 512, 256, device=cuda, generator=g).to(
            torch.bfloat16)
        runs = _two_grads(lambda h, r: moe.apply_moe(
            {**params, "router": {"kernel": r}}, h, spec), x,
            params["router"]["kernel"])
    elif site == "token_nll":
        logits = torch.randn(8, 300, 1000, device=cuda, generator=g)
        labels = torch.randint(-1, 1000, (8, 300), device=cuda, generator=g)
        runs = _two_grads(lambda z: tfm.token_nll(z, labels)[None], logits)
    else:
        cfg = registry.get_arch("egnn").CONFIG
        n, e = 3000, 40000
        batch = {"feat": torch.randn(n, 16, device=cuda, generator=g),
                 "coord": torch.randn(n, 3, device=cuda, generator=g),
                 "edges": torch.randint(0, n, (e, 2), device=cuda,
                                        generator=g),
                 "node_mask": torch.ones(n, device=cuda),
                 "labels": torch.randint(0, 16, (n,), device=cuda,
                                         generator=g)}
        params = gnn.init_egnn(torch.Generator(device=cuda).manual_seed(3),
                               cfg, 16, 16, device=cuda)
        w = params["layers"]["0"]["edge_mlp"]["tower"]["0"]["kernel"]

        def loss(kernel, feat):
            params["layers"]["0"]["edge_mlp"]["tower"]["0"]["kernel"] = \
                kernel
            return gnn.train_loss(params, dict(batch, feat=feat), cfg,
                                  edge_chunk=4096 if site == "egnn_chunked"
                                  else gnn.EDGE_CHUNK)[None]
        runs = _two_grads(loss, w, batch["feat"])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("clip_norm", [0.0, 1.0])
def test_adamw_on_the_card_equals_the_cpu(cuda, clip_norm):
    """Three AdamW steps from equal gradients on the card and the CPU:
    ``mu`` and ``nu`` bit-identical without clipping (the elementwise f32
    steps, divisions by device tensors); params and, with clipping (the
    global norm's reduction order), all three within 2 f32 ulps."""
    from repro_torch import tree
    from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          clip_norm=clip_norm)
    g = torch.Generator().manual_seed(0)
    shapes = {"w": (3, 64, 48), "b": (48,), "k": (64, 64)}
    cpu = {name: torch.randn(s, generator=g) for name, s in shapes.items()}
    card = tree.map_with_path(lambda _, t: t.to(cuda), cpu)
    s_cpu, s_card = adamw_init(cpu), adamw_init(card)
    for _ in range(3):
        grads = {name: 3 * torch.randn(s, generator=g)
                 for name, s in shapes.items()}
        cpu, s_cpu, _ = adamw_update(cpu, tree.map_with_path(
            lambda _, t: t.clone(), grads), s_cpu, cfg)
        card, s_card, _ = adamw_update(card, tree.map_with_path(
            lambda _, t: t.to(cuda), grads), s_card, cfg)

    def ulps(a, b):
        return int((a.cpu().view(torch.int32).long()
                    - b.view(torch.int32).long()).abs().max())

    for name in shapes:
        for got, ref in ((card[name], cpu[name]),
                         (s_card["mu"][name], s_cpu["mu"][name]),
                         (s_card["nu"][name], s_cpu["nu"][name])):
            assert ulps(got, ref) <= 2, name
        if not clip_norm:
            assert torch.equal(s_card["mu"][name].cpu(), s_cpu["mu"][name])
            assert torch.equal(s_card["nu"][name].cpu(), s_cpu["nu"][name])


@pytest.mark.cuda
def test_train_steps_are_run_to_run_identical(cuda):
    """Two runs of three train steps of reduced OneRec-V2 (``remat`` on)
    from one seed on the card: bit-identical losses and params."""
    import dataclasses
    from repro_torch import tree
    from repro_torch.configs import registry
    from repro_torch.launch import steps
    cfg = registry.get_arch("onerec-v2").reduced_config()
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, remat=True))
    shape = steps.SMOKE_SHAPES["onerec"]["train"]
    runs = []
    for _ in range(2):
        b = steps.onerec_bundle("onerec-v2", cfg, shape, fp8=False,
                                device=cuda)
        params, opt, batch = b.args
        losses = []
        for _ in range(3):
            loss, params, opt = b.fn(params, opt, batch)
            losses.append(loss.item())
        runs.append((losses, params))
    assert runs[0][0] == runs[1][0]
    for (path, a), (_, c) in zip(tree.leaves_with_path(runs[0][1]),
                                 tree.leaves_with_path(runs[1][1])):
        assert torch.equal(a, c), path


@pytest.mark.cuda
@pytest.mark.parametrize("C,K,N", [(8, 2048, 4096), (3080, 2048, 4096),
                                   (8, 4096, 2048), (3080, 4096, 2048)])
def test_grouped_gemm_on_four_experts_gives_the_rows_of_sixteen(cuda, C, K,
                                                                 N):
    """A rank of a (1, 4) expert-parallel mesh runs kernel
    ``fp8_grouped_gemm`` on its cloned 4-expert slice of OneRec-V2's 16:
    the same bits as those experts' rows of the E = 16 call."""
    from repro_torch import tree
    g = torch.Generator(device=cuda).manual_seed(24)
    x = torch.randn(16, C, K, device=cuda, generator=g).to(torch.bfloat16)
    w = quant.quantize_blockwise(
        torch.randn(16, K, N, device=cuda, generator=g) / math.sqrt(K))
    full = grouped_ops.fp8_grouped_gemm(x, w.data, w.scale)
    for r in range(4):
        part = w.data[4 * r:4 * r + 4]
        part = tree.empty_like(part).copy_(part)
        out = grouped_ops.fp8_grouped_gemm(
            x[4 * r:4 * r + 4].contiguous(), part,
            w.scale[4 * r:4 * r + 4].contiguous())
        assert torch.equal(out, full[4 * r:4 * r + 4]), r


@pytest.mark.cuda
def test_expert_parallel_two_ranks_on_the_card(cuda, tmp_path):
    """Reduced OneRec-V2 over two gloo ranks on card 0 (a (1, 2) mesh),
    raw and FP8: layer 0's ``apply_moe``, the prefill's logits and
    ``generate_items`` bit-identical to one rank on the card."""
    import numpy as np
    import _torch_dist as td
    from repro_torch.configs import onerec_v2
    from repro_torch.core.ptq import quantize_params
    from repro_torch.models import onerec
    from repro_torch.models import transformer as tfm
    cfg = onerec_v2.reduced_config()
    spec = tfm.moe_spec_for(cfg.transformer)
    rng = np.random.default_rng(0)
    s = cfg.history_len * cfg.n_codebooks + 1
    x = torch.from_numpy(rng.normal(size=(4, s, cfg.transformer.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab_size, size=(4, s - 1)).astype(np.int32)),
             "profile": torch.from_numpy(rng.normal(
                 size=(4, onerec.PROFILE_DIM)).astype(np.float32))}
    outs = td.run(2, td.ep_job, (((1, 2),), x, batch, "cuda"),
                  str(tmp_path), device="cuda")
    for fp8 in (False, True):
        params = onerec.init_onerec(0, cfg, device=cuda)
        if fp8:
            params = quantize_params(params)
        ref = td.ep_outputs(params, cfg, x.to(cuda),
                            {k: v.to(cuda) for k, v in batch.items()}, spec)
        for rank, out in enumerate(outs):
            for key, want in ref.items():
                assert torch.equal(out[(1, 2, fp8)][key], want.cpu()), \
                    (fp8, rank, key)
