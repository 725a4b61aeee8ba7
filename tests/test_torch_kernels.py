"""The port's kernels against the JAX package's, on the CPU: each plain
PyTorch version against the Pallas kernel (interpret mode) and its ``ref.py``
on the same numpy-seeded inputs.  The CUDA kernels themselves are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.

Tolerances (outputs are bf16; the fp8 payloads and scales are
bit-identical, only f32 summation order differs):
  * fp8_gemm / fp8_grouped_gemm vs ``ref.py``: 1 bf16 ulp,
    ``rtol = atol/max = 2**-7``; vs the interpret-mode Pallas kernel the JAX
    suite's own bound (``tests/test_kernels.py``), ``rtol = atol/max =
    2e-2``: on the CPU the interpreter's fp8 dot is not exact in f32 (the
    grouped kernel lands up to 5% off ``ref.py`` on single elements).
  * fp8_grouped_gemm vs the JAX engine's bf16-folded ``fp8_grouped_matmul``:
    relative L2 error below 1e-2 (the fold rounds each scaled operand to
    bf16, ~2**-9 relative per element).
  * paged_decode vs the interpret kernel, single-token and tree decode:
    2**-7 relative + 2**-7 absolute (online vs dense softmax changes f32
    rounding before the bf16 cast).
  * radix_topk vs the interpret kernels: exact, values bit for bit and
    indices.
  * batch_attention vs the interpret kernel at one S block (the JAX
    interpreter run op by op; over an fp8 cache the interpret kernel on
    ``repro.core.quant.dequantize_kv`` of the payload): 1 bf16 ulp of the
    largest |out|, f32 summation order only; its launch plan exactly (each
    key tile in one split); vs multi-block interpret runs and ``ref.py`` the
    JAX suite's absolute 0.05 (``tests/test_kernels.py``): the online
    softmax rounds p against a running max, ``ref.py`` does not round p.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jax_quant
from repro.kernels.batch_attention import ops as jax_attn
from repro.kernels.batch_attention.ref import batch_attention_ref
from repro.kernels.fp8_gemm.kernel import fp8_gemm_pallas
from repro.kernels.fp8_gemm.ref import fp8_gemm_ref
from repro.kernels.fp8_grouped_gemm.kernel import fp8_grouped_gemm_pallas
from repro.kernels.fp8_grouped_gemm.ref import fp8_grouped_gemm_ref
from repro.kernels.paged_decode import paged_decode_attention as jax_paged
from repro.kernels.radix_topk import radix_topk as jax_radix_topk
from repro_torch.core import quant
from repro_torch.kernels.batch_attention import ops as attn_ops
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
from repro_torch.kernels.paged_decode import ops as decode_ops
from repro_torch.kernels.radix_topk import ops as topk_ops
from repro_torch.weights import tensor_from_numpy

ULP = 2.0 ** -7
PALLAS_TOL = 2e-2     # tests/test_kernels.py's bound for the interpreter


def _t(a):
    return tensor_from_numpy(np.asarray(a))


def _f32(t):
    return t.to(torch.float32).numpy()


def _close(ours, theirs, rtol=ULP):
    theirs = np.asarray(theirs, np.float32)
    np.testing.assert_allclose(ours, theirs, rtol=rtol,
                               atol=rtol * np.abs(theirs).max())


@pytest.mark.parametrize("M,K,N", [(32, 256, 128), (64, 512, 384),
                                   (8, 128, 256)])
def test_fp8_gemm_plain_matches_pallas_and_ref(M, K, N):
    rng = np.random.default_rng(M + K + N)
    x = jnp.asarray(rng.normal(size=(M, K)) * 3, jnp.bfloat16)
    wq = jax_quant.quantize_per_channel(
        jnp.asarray(rng.normal(size=(K, N)), jnp.float32))
    sw = wq.scale.reshape(1, -1)
    ref = fp8_gemm_ref(x, wq.data, sw)
    pallas = fp8_gemm_pallas(x, wq.data, sw, block_m=min(M, 128),
                             interpret=True)
    ours = _f32(gemm_ops.fp8_gemm(_t(x)[None], _t(wq.data)[None],
                                  _t(sw))[0])
    _close(ours, ref)
    _close(ours, pallas, PALLAS_TOL)


def test_fp8_linear_matches_jax():
    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.normal(size=(2, 5, 128)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(128, 96)), jnp.float32)
    theirs = jax_quant.fp8_linear(x, jax_quant.quantize_per_channel(w))
    ours = quant.fp8_linear(_t(x), quant.quantize_per_channel(_t(w)))
    assert ours.shape == (2, 5, 96) and ours.dtype == torch.bfloat16
    _close(_f32(ours), theirs)


def test_fp8_grouped_linear_matches_jax():
    """Per-channel experts (the non-128-aligned fallback) through kernel
    fp8_gemm's batch dim."""
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(4, 8, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(4, 64, 96)), jnp.float32)
    theirs = jax_quant.fp8_grouped_linear(x, jax_quant.quantize_per_channel(w))
    ours = quant.fp8_grouped_linear(_t(x), quant.quantize_per_channel(_t(w)))
    _close(_f32(ours), theirs)


def test_fp8_linear_on_ptq_layer_slices_matches_jax():
    """Every per-channel leaf of the reduced OneRec-V2 after each package's
    PTQ, layer by layer: ``fp8_linear`` (q/k/v/o) and ``fp8_grouped_linear``
    (the non-128-aligned experts) on the port's K-major slices against JAX
    on its own."""
    from repro.configs import onerec_v2 as jax_onerec_v2
    from repro.core.ptq import quantize_params as jax_ptq
    from repro.models import onerec as jax_onerec
    from repro_torch.core.ptq import quantize_params
    from repro_torch.tree import leaves_with_path
    from repro_torch.weights import params_from_numpy
    params = jax_onerec.init_onerec(jax.random.PRNGKey(7),
                                    jax_onerec_v2.reduced_config())
    theirs = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                theirs[p] = v
    walk(jax_ptq(params))
    ours = quantize_params(params_from_numpy(jax.tree.map(np.asarray,
                                                          params)))
    rng = np.random.default_rng(8)
    n_linear = n_grouped = 0
    for path, w in leaves_with_path(ours):
        if not isinstance(w, quant.QuantizedTensor) \
                or w.granularity != "per_channel":
            continue
        for i in range(w.data.shape[0]):
            jw = jax.tree.map(lambda a, i=i: a[i], theirs[path])
            k, n = w.data.shape[-2:]
            if w.data.ndim == 3:
                x = jnp.asarray(rng.normal(size=(2, 3, k)), jnp.bfloat16)
                theirs_out = jax_quant.fp8_linear(x, jw)
                ours_out = quant.fp8_linear(_t(x), w[i])
                n_linear += 1
            else:
                e = w.data.shape[1]
                x = jnp.asarray(rng.normal(size=(e, 4, k)), jnp.bfloat16)
                theirs_out = jax_quant.fp8_grouped_linear(x, jw)
                ours_out = quant.fp8_grouped_linear(_t(x), w[i])
                n_grouped += 1
            assert w[i].data.stride(-2) == 1
            _close(_f32(ours_out), theirs_out)
    assert n_linear >= 8 and n_grouped >= 6


@pytest.mark.parametrize("E,M,K,N", [(1, 32, 2048, 2048), (1, 32, 2048, 512),
                                     (3, 70, 256, 200), (1, 1, 64, 32),
                                     (16, 8, 2048, 4096)])
def test_fp8_gemm_decode_plan_covers_k_and_fills_the_card(E, M, K, N):
    """The decode path's split of K: every 128-deep chunk in exactly one
    split, no empty split, and a block on at least three quarters of the
    132 SMs wherever K has the chunks for it (the plan aims at one block
    per SM; rounding the chunks per split up can leave a few SMs idle)."""
    splits, cps = gemm_ops.plan(E, M, N, K, 132)
    chunks = -(-K // gemm_ops.CHUNK)
    assert splits >= 1 and (splits - 1) * cps < chunks <= splits * cps
    tiles = E * -(-M // 32) * -(-N // 64)
    assert 4 * tiles * splits >= 3 * min(132, tiles * chunks)


def test_fp8_gemm_prefill_plan():
    assert gemm_ops.plan(1, 12320, 2048, 2048, 132) == (0, 0)
    assert gemm_ops.plan(1, 255, 2048, 2048, 132)[0] >= 1


@pytest.mark.parametrize("case", ["row-major", "k-ragged", "dtype",
                                  "shape"])
def test_fp8_gemm_kernel_layout_checks(case):
    """What the CUDA kernel refuses, named before any launch: a row-major
    weight (the kernel reads it K-major and never transposes per call), a
    K-major weight whose rows are not padded to 16 bytes (TMA's row
    strides; PTQ's payload at K = 72 is padded and accepted), other dtypes
    and shapes.  ``check_layout`` is pure Python, so it runs here on CPU
    tensors."""
    k = 80 if case == "k-ragged" else 64
    x = torch.randn(1, 4, k).to(torch.bfloat16)
    wq = quant.quantize_per_channel(torch.randn(1, k, 48))
    sw = wq.scale.reshape(1, 48).contiguous()
    w = wq.data
    gemm_ops.check_layout(x, w, sw, torch.bfloat16)     # K-major: accepted
    if case == "row-major":
        w, err, match = w.contiguous(), ValueError, "K-major"
    elif case == "k-ragged":
        x = torch.randn(1, 4, 72).to(torch.bfloat16)
        w = quant.quantize_per_channel(torch.randn(1, 72, 48)).data
        assert w.stride() == (48 * 80, 1, 80)
        gemm_ops.check_layout(x, w, sw, torch.bfloat16)
        w, err, match = w.mT.contiguous().mT, ValueError, "K-major"
    elif case == "dtype":
        x, err, match = x.float(), TypeError, "bf16 x"
    else:
        sw, err, match = sw[:, :40].contiguous(), ValueError, "shapes"
    with pytest.raises(err, match=match):
        gemm_ops.check_layout(x, w, sw, torch.bfloat16)


@pytest.mark.parametrize("E,C,K,N", [(2, 8, 256, 128), (3, 32, 384, 256),
                                     (2, 13, 256, 256)])
def test_fp8_grouped_gemm_plain_matches_pallas_and_ref(E, C, K, N):
    """The port's own PTQ payload (K-major, the layout the CUDA kernel
    reads, with the JAX bytes and scales) through the plain version against
    the Pallas kernel and ``ref.py`` on JAX's row-major payload; C = 13 is
    not a multiple of 8."""
    rng = np.random.default_rng(E * C + K)
    x = jnp.asarray(rng.normal(size=(E, C, K)) * 2, jnp.bfloat16)
    w = rng.normal(size=(E, K, N)) * 0.7
    wq = jax_quant.quantize_blockwise(jnp.asarray(w, jnp.float32))
    ref = fp8_grouped_gemm_ref(x, wq.data, wq.scale)
    pallas = fp8_grouped_gemm_pallas(x, wq.data, wq.scale, interpret=True)
    tq = quant.quantize_blockwise(_t(jnp.asarray(w, jnp.float32)))
    assert tq.data.stride(-2) == 1 and tq.data.mT.is_contiguous()
    np.testing.assert_array_equal(tq.data.view(torch.uint8).numpy(),
                                  np.asarray(wq.data).view(np.uint8))
    ours = _f32(grouped_ops.fp8_grouped_gemm(_t(x), tq.data, tq.scale))
    _close(ours, ref)
    _close(ours, pallas, PALLAS_TOL)
    # the JAX engine's XLA path folds the block scales into bf16 operands
    folded = np.asarray(jax_quant.fp8_grouped_matmul(x, wq), np.float32)
    rel = np.linalg.norm(ours - folded) / np.linalg.norm(folded)
    assert rel < 1e-2, rel


def _grouped_tiles(p, e: int, c: int, n: int):
    """Per block of plan ``p``, in ``blockIdx`` order, the (expert, first
    row, first column, rows, columns) of every output tile the CUDA kernels
    give it: a persistent prefill block b takes tiles b, b + grid, .. of
    the (expert, row tile, column tile) order, column tiles fastest; a
    decode block (x, y, z) is columns 64 x, expert y, rows bc z."""
    gx, gy, gz = p.grid
    if p.bc == 0:
        t_n, t_m = n // 128, -(-c // 128)
        for b in range(gx):
            yield [(t // t_n // t_m, t // t_n % t_m * 128, t % t_n * 128,
                    128, 128) for t in range(b, t_n * t_m * e, gx)]
        return
    for x in range(gx):
        for y in range(gy):
            for z in range(gz):
                yield [(y, z * p.bc, x * 64, p.bc, 64)]


@pytest.mark.parametrize("E,C,N", [(16, 8, 4096), (16, 8, 2048),
                                   (16, 3080, 4096), (16, 3080, 2048),
                                   (3, 1, 256), (4, 13, 384), (4, 32, 128),
                                   (4, 33, 384), (2, 200, 128)])
def test_fp8_grouped_gemm_plan_covers_every_tile_once(E, C, N):
    """The launch plan the CUDA kernel takes its grid from: every (expert,
    row, column) of the output in exactly one tile of one block (each tile
    walks all of K's 128-deep chunks), the decode path (swapped operands,
    the expert's rows as wgmma's N of 8, 16 or 32) up to 32 rows per
    expert, the prefill path's persistent blocks (at most one per SM, none
    idle) over 128 x 128 tiles above."""
    p = grouped_ops.plan(E, C, N, 132)
    assert (p.bc == 0) == (C > grouped_ops.DECODE_MAX_C)
    assert p.bc in (0, 8, 16, 32) and (p.bc == 0 or p.bc >= min(C, 32))
    covered = np.zeros((E, C, N), np.int32)
    blocks = list(_grouped_tiles(p, E, C, N))
    assert len(blocks) == p.grid[0] * p.grid[1] * p.grid[2]
    if p.bc == 0:
        assert p.grid[0] <= 132 and all(blocks)
    for block in blocks:
        for e, r0, c0, rows, cols in block:
            assert c0 % 128 + cols <= 128  # one 128-column scale block
            covered[e, r0:r0 + rows, c0:c0 + cols] += 1
    np.testing.assert_array_equal(covered, 1)


@pytest.mark.parametrize("case", ["row-major", "k-ragged", "dtype", "shape",
                                  "scales"])
def test_fp8_grouped_gemm_kernel_layout_checks(case):
    """What the CUDA kernel refuses, named before any launch: a row-major
    weight (the kernel reads it K-major and never transposes per call), K
    or N not a multiple of 128 (the block scales), other dtypes and
    shapes.  ``check_layout`` is pure Python, so it runs here."""
    x = torch.randn(2, 8, 256).to(torch.bfloat16)
    wq = quant.quantize_blockwise(torch.randn(2, 256, 128))
    w, sw = wq.data, wq.scale
    grouped_ops.check_layout(x, w, sw, torch.bfloat16)   # K-major: accepted
    if case == "row-major":
        w, err, match = w.contiguous(), ValueError, "K-major"
    elif case == "k-ragged":
        x = torch.randn(2, 8, 192).to(torch.bfloat16)
        w = quant.k_major(torch.zeros(2, 192, 128).to(quant.E4M3))
        sw = torch.ones(2, 1, 1)
        err, match = ValueError, "multiples of 128"
    elif case == "dtype":
        x, err, match = x.float(), TypeError, "bf16 x"
    elif case == "shape":
        x, err, match = x[:1].contiguous(), ValueError, "shapes"
    else:
        sw, err, match = sw.double(), TypeError, "f32 scales"
    with pytest.raises(err, match=match):
        grouped_ops.check_layout(x, w, sw, torch.bfloat16)


# ---------------------------------------------------------------------------
# paged_decode
# ---------------------------------------------------------------------------

PS, N_PAGES, KV, H, HD = 8, 7, 2, 4, 32


def _decode_case(quantized: bool, seed: int = 0):
    """A pool with shuffled page tables, sentinel entries, an empty row and
    lengths on and beside page boundaries."""
    rng = np.random.default_rng(seed)
    n_pos = (N_PAGES + 1) * PS                      # + the sentinel page
    lengths = np.asarray([10, 15, 0, 16], np.int32)  # row 2: empty slot
    b, p_max = len(lengths), 3
    perm = rng.permutation(N_PAGES)
    tables = np.full((b, p_max), N_PAGES, np.int32)  # sentinel = unmapped
    pos = np.full((n_pos,), -1, np.int32)
    nxt = 0
    for i, ln in enumerate(lengths):
        if ln == 0:
            continue
        for e in range(ln // PS + 1):
            page = int(perm[nxt])
            nxt += 1
            tables[i, e] = page
            for o in range(PS):
                logical = e * PS + o
                if logical <= ln:
                    pos[page * PS + o] = logical
    k = rng.normal(size=(n_pos, KV, HD)).astype(np.float32)
    v = rng.normal(size=(n_pos, KV, HD)).astype(np.float32)
    cache = {"pos": jnp.asarray(pos)}
    if quantized:
        cache["k"], cache["k_scale"] = jax_quant.quantize_kv(jnp.asarray(k))
        cache["v"], cache["v_scale"] = jax_quant.quantize_kv(jnp.asarray(v))
    else:
        cache["k"] = jnp.asarray(k, jnp.bfloat16)
        cache["v"] = jnp.asarray(v, jnp.bfloat16)
    q = jnp.asarray(rng.normal(size=(b, 1, H, HD)), jnp.bfloat16)
    return q, cache, jnp.asarray(tables), jnp.asarray(lengths)


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "fp8kv"])
def test_paged_decode_plain_matches_pallas(quantized):
    q, cache, tables, lengths = _decode_case(quantized)
    theirs = np.asarray(jax_paged(q, cache, tables, lengths, page_size=PS,
                                  interpret=True), np.float32)
    ours = decode_ops.paged_decode_attention(
        _t(q), {k: _t(v) for k, v in cache.items()}, _t(tables),
        _t(lengths), page_size=PS)
    ours = _f32(ours)
    assert ours.shape == theirs.shape == (4, 1, H * HD)
    np.testing.assert_array_equal(ours[2], 0.0)      # empty row -> zeros
    np.testing.assert_allclose(ours, theirs, rtol=ULP, atol=ULP)


def _tree_case(n_branches: int, seed: int):
    """Tree decode: each slot holds a shared prefix of ``start`` positions,
    then ``n_branches`` spans of ``stride`` positions (branch c at
    ``start + c * stride``), on shuffled pages; rows r = c * G + g.  One
    slot is empty, one has its start on a page boundary."""
    rng = np.random.default_rng(seed)
    kv, g, hd, ps, stride = 2, 4, 32, 8, 3
    starts = np.asarray([5, 0, 16, 11], np.int32)     # slot 1 empty
    lengths = starts + n_branches * stride - 1
    lengths[1] = 0
    b = len(starts)
    n_p = int(lengths.max()) // ps + 1
    need = [0 if i == 1 else int(ln) // ps + 1 for i, ln in enumerate(lengths)]
    n_pages = sum(need) + 2
    perm = rng.permutation(n_pages)
    tables = np.full((b, n_p), n_pages, np.int32)     # sentinel = unmapped
    pos = np.full(((n_pages + 1) * ps,), -1, np.int32)
    nxt = 0
    for i in range(b):
        for e in range(need[i]):
            page = int(perm[nxt])
            nxt += 1
            tables[i, e] = page
            for o in range(ps):
                if e * ps + o <= lengths[i]:
                    pos[page * ps + o] = e * ps + o
    n_pos = pos.shape[0]
    k = rng.normal(size=(n_pos, kv, hd)).astype(np.float32)
    v = rng.normal(size=(n_pos, kv, hd)).astype(np.float32)
    kq, ks = jax_quant.quantize_kv(jnp.asarray(k))
    vq, vs = jax_quant.quantize_kv(jnp.asarray(v))
    q = jnp.asarray(rng.normal(size=(b, kv, n_branches * g, hd)),
                    jnp.bfloat16)
    return dict(q=q, k=kq, v=vq, pos=jnp.asarray(pos), k_scale=ks,
                v_scale=vs, tables=jnp.asarray(tables),
                lengths=jnp.asarray(lengths), starts=jnp.asarray(starts)), \
        dict(page_size=ps, group=g, branch_stride=stride,
             scale=1.0 / np.sqrt(hd))


@pytest.mark.parametrize("n_branches", [2, 3, 4])
def test_paged_decode_plain_matches_pallas_tree(n_branches):
    """The kernel layout's whole function: ``starts`` and a branch stride
    (each row sees the shared prefix and its own branch's span only), C*G
    = 8..16 rows per KV head, fp8 K/V, an empty slot; the plain version
    against the Pallas kernel in interpret mode, 2**-7 relative + 2**-7
    absolute (online vs dense softmax)."""
    from repro.kernels.paged_decode.kernel import paged_decode_pallas
    args, kw = _tree_case(n_branches, seed=n_branches)
    ps = kw["page_size"]
    jargs = dict(args, pos=args["pos"].reshape(-1, ps))
    theirs = np.asarray(paged_decode_pallas(**jargs, **kw, interpret=True),
                        np.float32)
    ours = _f32(decode_ops.paged_decode(**{n: _t(a) for n, a in
                                           args.items()}, **kw))
    assert ours.shape == theirs.shape == (4, 2, 4 * n_branches, 32)
    np.testing.assert_array_equal(ours[1], 0.0)      # empty slot -> zeros
    np.testing.assert_allclose(ours, theirs, rtol=ULP, atol=ULP)
    # the branch mask is live: without it every row would see all keys
    flat = decode_ops.paged_decode(**{n: _t(a) for n, a in args.items()},
                                   **dict(kw, branch_stride=64))
    assert not np.allclose(_f32(flat), ours, atol=ULP)


# ---------------------------------------------------------------------------
# radix_topk
# ---------------------------------------------------------------------------


def _topk_equal(x: np.ndarray, k: int) -> None:
    """Port plain vs the JAX kernels: values bit for bit, indices equal."""
    jv, ji = jax_radix_topk(jnp.asarray(x), k)
    tv, ti = topk_ops.radix_topk(_t(jnp.asarray(x)), k)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv, np.float32).view(np.int32))


@pytest.mark.parametrize("B,V,k", [(4, 1024, 8), (8, 4000, 16), (2, 257, 4),
                                   (16, 8192, 64), (32, 8256, 8)])
def test_radix_topk_plain_matches_pallas(B, V, k):
    """``tests/test_kernels.py``'s four shapes and the engine's select
    (32 rows of vocab 8256, padded to 10240 columns, k = 8)."""
    x = np.random.default_rng(B + V).normal(size=(B, V)) * 7
    _topk_equal(x.astype(np.float32), k)


def _edge_row(kind: str, B: int, V: int) -> np.ndarray:
    rng = np.random.default_rng(B * V)
    if kind == "equal":          # every key ties: the kernel's list overflows
        return np.full((B, V), 1.5, np.float32)
    x = rng.normal(size=(B, V)) * 7
    if kind == "mixed":          # a row of ties, a row of equal values
        x[0] = rng.integers(-3, 4, size=V)
        x[1] = 2.0
    return x.astype(np.float32)


@pytest.mark.parametrize("kind,B,V,k,dtype", [
    ("equal", 2, 4000, 8, jnp.float32),    # all-equal rows, pad ties
    ("equal", 2, 1500, 1024, jnp.float32),  # k = MAX_K, no pad
    ("normal", 2, 257, 257, jnp.float32),   # k = V
    ("mixed", 3, 2049, 8, jnp.float32),     # 1 column past a block, 2047 pad
    ("normal", 2, 2048, 1024, jnp.float32),  # k = MAX_K
    ("mixed", 3, 4001, 16, jnp.bfloat16),   # odd V in bf16: unaligned rows
])
def test_radix_topk_plain_matches_pallas_edges(kind, B, V, k, dtype):
    """The card's edge cases (``tests/test_torch_cuda.py``) that the
    interpreter takes in reasonable time: plain vs Pallas, exact."""
    x = jnp.asarray(_edge_row(kind, B, V), dtype)
    jv, ji = jax_radix_topk(x, k)
    tv, ti = topk_ops.radix_topk(_t(x), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv, np.float32).view(np.int32))


@pytest.mark.parametrize("B,V,dtype,aligned,expect", [
    # the engine's select: one block of 544 threads, 16 keys each
    (32, 8256, torch.float32, True, (16, 544, 1, True)),
    (32, 8192, torch.float32, True, (8, 1024, 1, True)),
    (3, 257, torch.float32, True, (4, 96, 1, False)),        # odd V
    (4, 2049, torch.float32, True, (4, 544, 1, False)),
    (5, 4001, torch.bfloat16, True, (4, 1024, 1, False)),
    (8, 4000, torch.bfloat16, True, (4, 1024, 1, True)),
    (4, 8256, torch.float32, False, (16, 544, 1, False)),    # offset start
    (2, 1, torch.bfloat16, True, (4, 32, 1, False)),
    # one block's registers hold 1024 x 16 columns; past them, tiles
    (1, 16384, torch.float32, True, (16, 1024, 1, True)),
    (1, 16385, torch.float32, True, (16, 1024, 2, False)),
    (2, 20000, torch.bfloat16, True, (16, 1024, 2, True)),
    (1, 32768, torch.float32, True, (16, 1024, 2, True)),
    (1, 65536, torch.float32, True, (16, 1024, 4, True)),
    (2, 100000, torch.float32, True, (16, 1024, 7, True)),
])
def test_radix_topk_plan(B, V, dtype, aligned, expect):
    """The launch plan covers the row and obeys the kernel's limits."""
    p = topk_ops.plan(B, V, dtype, aligned)
    assert tuple(p) == expect
    assert p.threads % 32 == 0 and p.threads <= topk_ops.MAX_THREADS
    assert p.threads * p.kpt * p.tiles >= V


def test_radix_topk_plan_leaves_no_warp_idle():
    """Over a sweep of row lengths the plan's one block covers the row,
    with every warp of a row read once holding a real column, no tile
    empty, and the fewest keys a thread that fit."""
    for v in list(range(1, 300)) + list(range(300, 70000, 97)):
        p = topk_ops.plan(1, v, torch.float32, True)
        assert p.threads * p.kpt * p.tiles >= v
        if p.tiles == 1:
            assert (p.threads - 32) * p.kpt < v
        else:
            assert p.threads == topk_ops.MAX_THREADS
            assert (p.tiles - 1) * p.threads * p.kpt < v
        if p.kpt > topk_ops.KEYS_PER_THREAD[0] and p.tiles == 1:
            smaller = topk_ops.KEYS_PER_THREAD[
                topk_ops.KEYS_PER_THREAD.index(p.kpt) - 1]
            assert topk_ops.MAX_THREADS * smaller < v


def test_radix_topk_plain_ties_negatives_and_signed_zeros():
    _topk_equal(np.asarray([[5.0, -1.0, 5.0, 5.0, 2.0, -3.0, 2.0, 0.0]],
                           np.float32), 5)
    rng = np.random.default_rng(0)
    _topk_equal(-np.abs(rng.normal(size=(3, 513))).astype(np.float32), 7)
    # +0.0 keys rank above -0.0 keys whatever their indices; equal values
    # come out in index order and a selected -0.0 as +0.0
    z = np.zeros((4, 64), np.float32)
    z[:, 1::2] = -0.0
    z[1, ::5] = -1.0
    z[2, 3::7] = 2.0
    z[3] = rng.integers(-2, 3, size=64)
    for k in (3, 8, 40):
        _topk_equal(z, k)
    # bf16 rows: the pad columns are float32 min cast to bf16 (-inf)
    xb = jnp.asarray(rng.normal(size=(8, 4000)) * 7, jnp.bfloat16)
    jv, ji = jax_radix_topk(xb, 16)
    tv, ti = topk_ops.radix_topk(_t(xb), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv, np.float32))


# ---------------------------------------------------------------------------
# batch_attention
# ---------------------------------------------------------------------------

SWEEP = [(4, 1, 8, 2, 64, 256, 0),       # GQA decode
         (2, 1, 4, 4, 32, 512, 0),       # MHA decode
         (2, 64, 8, 2, 64, 64, 0),       # short prefill
         (2, 1, 4, 1, 64, 512, 64)]      # windowed decode


def _attn_case(B, T, H, Kv, hd, S, seed=0):
    rng = np.random.default_rng(seed + S)
    q = jnp.asarray(rng.normal(size=(B, T, H, hd)), jnp.bfloat16)
    k = jnp.asarray(rng.normal(size=(B, S, Kv, hd)), jnp.bfloat16)
    v = jnp.asarray(rng.normal(size=(B, S, Kv, hd)), jnp.bfloat16)
    if T == 1:
        q_pos = np.full((B, 1), S // 2, np.int32)
    else:
        q_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    k_pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return q, k, v, jnp.asarray(q_pos), jnp.asarray(k_pos)


def _port_attn(q, k, v, q_pos, k_pos, window, hd):
    return _f32(attn_ops.batch_attention(
        _t(q), _t(k), _t(v), _t(q_pos), _t(k_pos),
        scale=1.0 / np.sqrt(hd), window=window))


@pytest.mark.parametrize("B,T,H,Kv,hd,S,window", SWEEP)
def test_batch_attention_plain_matches_pallas_one_block(B, T, H, Kv, hd, S,
                                                        window):
    q, k, v, q_pos, k_pos = _attn_case(B, T, H, Kv, hd, S)
    with jax.disable_jit():
        theirs = np.asarray(jax_attn.batch_attention(
            q, k, v, q_pos, k_pos, window=window), np.float32)
    ours = _port_attn(q, k, v, q_pos, k_pos, window, hd)
    assert ours.shape == theirs.shape == (B, T, H * hd)
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=ULP * np.abs(theirs).max())


@pytest.mark.parametrize("B,T,H,Kv,hd,S,window", SWEEP)
def test_batch_attention_plain_matches_multi_block_and_ref(B, T, H, Kv, hd,
                                                           S, window):
    q, k, v, q_pos, k_pos = _attn_case(B, T, H, Kv, hd, S, seed=1)
    ours = _port_attn(q, k, v, q_pos, k_pos, window, hd)
    multi = jax_attn.batch_attention(q, k, v, q_pos, k_pos, window=window,
                                     block_s=128)
    G = H // Kv
    qr = q.reshape(B, T, Kv, G, hd).transpose(0, 2, 3, 1, 4)
    ref = batch_attention_ref(qr, k.transpose(0, 2, 1, 3),
                              v.transpose(0, 2, 1, 3), q_pos, k_pos,
                              scale=1 / np.sqrt(hd), window=window)
    ref = ref.transpose(0, 3, 1, 2, 4).reshape(B, T, H * hd)
    for theirs in (multi, ref):
        np.testing.assert_allclose(ours, np.asarray(theirs, np.float32),
                                   atol=0.05)


def test_batch_attention_plain_ring_buffer_mask():
    """Empty slots (pos = -1) do not contribute: zeroing them changes
    nothing, and the result holds against the two-block interpret run."""
    B, S, Kv, hd = 2, 128, 2, 32
    q, k, v, _, _ = _attn_case(B, 1, 4, Kv, hd, S)
    kp = np.where(np.arange(S) % 2 == 0, -1, np.arange(S)).astype(np.int32)
    k_pos = jnp.asarray(np.broadcast_to(kp[None], (B, S)))
    q_pos = jnp.full((B, 1), S, jnp.int32)
    mask = jnp.asarray((kp >= 0)[None, :, None, None], k.dtype)
    ours = _port_attn(q, k, v, q_pos, k_pos, 0, hd)
    zeroed = _port_attn(q, k * mask, v * mask, q_pos, k_pos, 0, hd)
    np.testing.assert_array_equal(ours, zeroed)
    theirs = jax_attn.batch_attention(q, k, v, q_pos, k_pos, block_s=64)
    np.testing.assert_allclose(ours, np.asarray(theirs, np.float32),
                               atol=0.02)


@pytest.mark.parametrize("B,T,H,Kv,hd,S,window", SWEEP[:1] + SWEEP[3:])
def test_batch_attention_plain_fp8_matches_pallas(B, T, H, Kv, hd, S,
                                                  window):
    """An fp8 cache: the port's plain version over the e4m3 payload and
    its scales against the JAX package's read, ``dequantize_kv`` then the
    Pallas kernel in interpret mode, at one S block (1 bf16 ulp), and bit
    for bit against the port's own bf16 path over ``dequantize_kv``."""
    q, k, v, q_pos, k_pos = _attn_case(B, T, H, Kv, hd, S, seed=2)
    k8, ks = jax_quant.quantize_kv(k.astype(jnp.float32))
    v8, vs = jax_quant.quantize_kv(v.astype(jnp.float32))
    with jax.disable_jit():
        theirs = np.asarray(jax_attn.batch_attention(
            q, jax_quant.dequantize_kv(k8, ks), jax_quant.dequantize_kv(
                v8, vs), q_pos, k_pos, window=window), np.float32)
    tk8, tks, tv8, tvs = (_t(x) for x in (k8, ks, v8, vs))
    kw = dict(scale=1.0 / np.sqrt(hd), window=window)
    ours = attn_ops.batch_attention(_t(q), tk8, tv8, _t(q_pos), _t(k_pos),
                                    k_scale=tks, v_scale=tvs, **kw)
    assert ours.shape == theirs.shape == (B, T, H * hd)
    np.testing.assert_allclose(_f32(ours), theirs, rtol=0,
                               atol=ULP * np.abs(theirs).max())
    bf16 = attn_ops.batch_attention_plain(
        _t(q), quant.dequantize_kv(tk8, tks), quant.dequantize_kv(tv8, tvs),
        _t(q_pos), _t(k_pos), **kw)
    assert torch.equal(ours.view(torch.int16), bf16.view(torch.int16))


# (B, T, H, Kv, hd, S): chip_smoke.py phase 2's OneRec shapes (decode,
# prefill T = 64), its ZOO_ATTENTION (the 512-slot gemma3-1b ring, then S =
# 4112), T = 64 at llama3-8b's widths, and the card tests' window ring
PLAN_SHAPES = [(32, 1, 16, 4, 128, 388), (4, 64, 16, 4, 128, 388),
               (4, 1, 4, 1, 256, 512), (4, 1, 4, 1, 256, 4112),
               (4, 1, 32, 8, 128, 4112), (4, 1, 16, 16, 128, 4112),
               (4, 1, 56, 8, 128, 4112), (4, 64, 32, 8, 128, 4112),
               (2, 64, 16, 4, 128, 96), (4, 1, 8, 2, 64, 256)]


@pytest.mark.parametrize("B,T,H,Kv,hd,S", PLAN_SHAPES)
def test_batch_attention_plan_covers_every_tile_once(B, T, H, Kv, hd, S):
    """The CUDA kernel's launch plan on 132 SMs: every key tile in exactly
    one split, no split empty, at most two waves of blocks, and the grid
    on at least three quarters of the SMs wherever the tiles allow it;
    OneRec's decode (128 blocks) keeps one split, and a forced count is
    clipped to the tiles."""
    p = attn_ops.plan(B, T, H, Kv, S, hd, 132)
    assert p.tile == (128 if hd <= 128 else 64)
    assert p.n_tiles == -(-S // p.tile)
    assert p.row_blocks == -(-(H // Kv) * T // 16)
    covered = np.zeros(p.n_tiles, np.int32)
    for t0, t1 in p.ranges():
        assert t0 < t1 <= t0 + p.per_split
        covered[t0:t1] += 1
    np.testing.assert_array_equal(covered, 1)
    base = Kv * B * p.row_blocks
    slots = 132 * (2 if hd <= 64 else 1)
    assert p.splits == 1 or base * p.splits <= 2 * slots
    assert 4 * base * p.splits >= 3 * min(132, base * p.n_tiles)
    if (B, T, H, Kv, hd, S) == (32, 1, 16, 4, 128, 388):
        assert p.splits == 1
    forced = attn_ops.plan(B, T, H, Kv, S, hd, 132, 10 ** 6)
    assert forced.splits == p.n_tiles and forced.per_split == 1


def test_batch_attention_meta_tallies_fp8_bytes():
    """The dry run's ``meta`` call over an fp8 cache: the output's shape
    and dtype, and the e4m3 payload and f32 scales counted as read."""
    from repro_torch.analysis import tally
    B, T, H, Kv, hd, S = 2, 1, 8, 2, 64, 96
    meta = dict(device="meta")
    q = torch.empty(B, T, H, hd, dtype=torch.bfloat16, **meta)
    k8 = torch.empty(B, S, Kv, hd, dtype=torch.float8_e4m3fn, **meta)
    sc = torch.empty(B, S, Kv, dtype=torch.float32, **meta)
    qp = torch.empty(B, T, dtype=torch.int32, **meta)
    kp = torch.empty(B, S, dtype=torch.int32, **meta)
    with tally.counting() as t:
        out = attn_ops.batch_attention(q, k8, k8, qp, kp, scale=0.125,
                                       k_scale=sc, v_scale=sc)
    assert out.device.type == "meta" and out.dtype == torch.bfloat16
    assert tuple(out.shape) == (B, T, H * hd)
    assert t["calls"]["batch_attention"] == 1
    assert t["flops"] == 4 * B * T * H * hd * S
    assert t["bytes"] == (2 * B * T * H * hd * 2 + 2 * B * S * Kv * hd
                          + 2 * B * S * Kv * 4 + B * T * 4 + B * S * 4)
