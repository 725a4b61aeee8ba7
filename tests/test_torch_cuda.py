"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: they skip on a machine without one.  They import
neither JAX nor the JAX package, so they run where only PyTorch is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: 1 bf16 ulp (``2**-7`` relative to the largest output for the
GEMMs, absolute for attention outputs of order one); the fp8 payloads and
scales are bit-identical, only f32 summation order differs.
"""

import math

import pytest
import torch

from repro_torch.core import quant
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
from repro_torch.kernels.paged_decode import ops as decode_ops

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
@pytest.mark.parametrize("E,M,K,N", [(1, 32, 2048, 512), (3, 70, 256, 200)])
def test_fp8_gemm_kernel_matches_plain(cuda, E, M, K, N):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(E, M, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_per_channel(
        torch.randn(E, K, N, device=cuda, generator=g))
    sw = wq.scale.reshape(E, N).contiguous()
    before = gemm_ops.fp8_gemm.launches
    out = gemm_ops.fp8_gemm(x, wq.data, sw)
    assert gemm_ops.fp8_gemm.launches == before + 1
    _close(out, gemm_ops.fp8_gemm_plain(x, wq.data, sw))


@pytest.mark.cuda
@pytest.mark.parametrize("E,C,K,N", [(16, 8, 2048, 4096), (2, 100, 256, 128)])
def test_fp8_grouped_gemm_kernel_matches_plain(cuda, E, C, K, N):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(E, C, K, device=cuda, generator=g).to(torch.bfloat16)
    wq = quant.quantize_blockwise(
        torch.randn(E, K, N, device=cuda, generator=g) / math.sqrt(K))
    out = grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale)
    _close(out, grouped_ops.fp8_grouped_gemm_plain(x, wq.data, wq.scale))


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "fp8kv"])
@pytest.mark.parametrize("ps", [8, 32])
def test_paged_decode_kernel_matches_plain(cuda, quantized, ps):
    """Shuffled pages, sentinel entries, empty rows and page-boundary
    lengths; GQA groups of 4 at head_dim 128."""
    g = torch.Generator().manual_seed(ps)
    kv, grp, hd = 4, 4, 128
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
