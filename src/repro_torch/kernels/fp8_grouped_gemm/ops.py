"""Kernel ``fp8_grouped_gemm``: block-scaled fp8 grouped GEMM (the MoE
experts), 1 x 128 activation scales computed per K slice, 128 x 128 weight
scales, each 128-deep partial scaled and accumulated in f32.

Replaces ``repro/kernels/fp8_grouped_gemm/kernel.py``
(``fp8_grouped_gemm_pallas``); the CUDA source is
``src/repro_torch/csrc/fp8_grouped_gemm.cu`` (one call launches the 1 x 128
quantization pass and the tensor-core GEMM, see ``csrc/fp8_mma.cuh``).  The wrapper dispatches on
the tensor's device: a CPU tensor runs the plain version (the port of
``repro/kernels/fp8_grouped_gemm/ref.py``), a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

B = 128  # the paper's block granularity
_VP, _I = ctypes.c_void_p, ctypes.c_int


def fp8_grouped_gemm_plain(x: torch.Tensor, wq: torch.Tensor,
                           sw: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) @ (wq (E, K, N) e4m3, sw (E, K/B, N/B)) -> (E, C, N):
    ``out = sum_kb (Xq_kb . Wq_kb) * s_x[c, kb] * s_w[kb, nb]`` in f32,
    accumulated over kb in order."""
    e, c, k = x.shape
    n = wq.shape[-1]
    xq = quant.quantize_blockwise(x, block=B, act=True)      # scale (E, C, kb)
    xd = xq.data.reshape(e, c, k // B, B).to(torch.float32)
    wd = wq.reshape(e, k // B, B, n).to(torch.float32)
    swn = sw.repeat_interleave(B, dim=-1)                     # (E, kb, N)
    acc = torch.zeros((e, c, n), dtype=torch.float32, device=x.device)
    for kb in range(k // B):
        part = torch.matmul(xd[:, :, kb], wd[:, kb])         # (E, C, N)
        acc += part * xq.scale[:, :, kb, None] * swn[:, None, kb]
    return acc.to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("fp8_grouped_gemm")
    fn = lib.fp8_grouped_gemm_launch
    fn.argtypes = [_VP] * 6 + [_I] * 4 + [_VP]
    fn.restype = _I
    return lib


def fp8_grouped_gemm(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) bf16 @ (wq (E, K, N) e4m3, sw (E, K/128, N/128) f32)."""
    e, c, k = x.shape
    n = wq.shape[-1]
    if k % B or n % B:
        raise ValueError(f"fp8_grouped_gemm needs K, N multiples of {B}, "
                         f"got K={k} N={n}")
    if x.device.type == "cpu":
        return fp8_grouped_gemm_plain(x, wq, sw, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fp8_grouped_gemm: unsupported device {x.device}")
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.float8_e4m3fn
            or sw.dtype != torch.float32 or out_dtype != torch.bfloat16):
        raise TypeError(f"fp8_grouped_gemm kernel takes bf16 x, e4m3 w, f32 "
                        f"scales and bf16 out; got {x.dtype}, {wq.dtype}, "
                        f"{sw.dtype} -> {out_dtype}")
    if (tuple(wq.shape) != (e, k, n)
            or tuple(sw.shape) != (e, k // B, n // B)):
        raise ValueError(f"fp8_grouped_gemm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, sw {tuple(sw.shape)}")
    for t in (x, wq, sw):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("fp8_grouped_gemm takes contiguous tensors on "
                             "one device")
    out = torch.empty((e, c, n), dtype=torch.bfloat16, device=x.device)
    # scratch: x quantized once per call, and its 1 x 128 block scales
    xq = torch.empty((e, c, k), dtype=torch.uint8, device=x.device)
    sx = torch.empty((e, c, k // B), dtype=torch.float32, device=x.device)
    code = _lib().fp8_grouped_gemm_launch(
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), e, c, n, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fp8_grouped_gemm")
    fp8_grouped_gemm.launches += 1
    return out


fp8_grouped_gemm.launches = 0
