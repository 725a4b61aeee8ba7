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
  * paged_decode vs the interpret kernel: 2**-7 relative + 2**-7 absolute
    (online vs dense softmax changes f32 rounding before the bf16 cast).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jax_quant
from repro.kernels.fp8_gemm.kernel import fp8_gemm_pallas
from repro.kernels.fp8_gemm.ref import fp8_gemm_ref
from repro.kernels.fp8_grouped_gemm.kernel import fp8_grouped_gemm_pallas
from repro.kernels.fp8_grouped_gemm.ref import fp8_grouped_gemm_ref
from repro.kernels.paged_decode import paged_decode_attention as jax_paged
from repro_torch.core import quant
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
from repro_torch.kernels.paged_decode import ops as decode_ops
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


@pytest.mark.parametrize("E,C,K,N", [(2, 8, 256, 128), (3, 32, 384, 256)])
def test_fp8_grouped_gemm_plain_matches_pallas_and_ref(E, C, K, N):
    rng = np.random.default_rng(E * C + K)
    x = jnp.asarray(rng.normal(size=(E, C, K)) * 2, jnp.bfloat16)
    wq = jax_quant.quantize_blockwise(
        jnp.asarray(rng.normal(size=(E, K, N)) * 0.7, jnp.float32))
    ref = fp8_grouped_gemm_ref(x, wq.data, wq.scale)
    pallas = fp8_grouped_gemm_pallas(x, wq.data, wq.scale, interpret=True)
    ours = _f32(grouped_ops.fp8_grouped_gemm(_t(x), _t(wq.data),
                                             _t(wq.scale)))
    _close(ours, ref)
    _close(ours, pallas, PALLAS_TOL)
    # the JAX engine's XLA path folds the block scales into bf16 operands
    folded = np.asarray(jax_quant.fp8_grouped_matmul(x, wq), np.float32)
    rel = np.linalg.norm(ours - folded) / np.linalg.norm(folded)
    assert rel < 1e-2, rel


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
