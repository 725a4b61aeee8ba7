"""Kernel ``fp8_gemm``: per-row dynamic fp8 quantization of x, then an fp8
GEMM with f32 accumulation and the ``sx * sw`` epilogue, with a leading
batch dim.

Replaces ``repro/kernels/fp8_gemm/kernel.py`` (``fp8_gemm_pallas``); the
CUDA source is ``src/repro_torch/csrc/fp8_gemm.cu`` (one call launches the
quantization pass and the tensor-core GEMM, see ``csrc/fp8_mma.cuh``).  The wrapper
dispatches on the tensor's device: a CPU tensor runs the plain version
(the port of ``repro/kernels/fp8_gemm/ref.py``, i.e. ``fp8_linear``'s
per-token path), a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

_VP, _I = ctypes.c_void_p, ctypes.c_int


def fp8_gemm_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                   out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, M, K) @ (wq (E, K, N) e4m3, sw (E, N) f32) -> (E, M, N):
    per-token quant of x, fp8 products summed in f32, ``acc * sx * sw``."""
    xq = quant.quantize_per_token(x)
    acc = torch.matmul(xq.data.to(torch.float32), wq.to(torch.float32))
    return (acc * xq.scale * sw[:, None, :]).to(out_dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("fp8_gemm")
    fn = lib.fp8_gemm_launch
    fn.argtypes = [_VP] * 6 + [_I] * 4 + [_VP]
    fn.restype = _I
    return lib


def fp8_gemm(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, *,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, M, K) bf16 @ (wq (E, K, N) e4m3, sw (E, N) f32) -> (E, M, N)."""
    if x.device.type == "cpu":
        return fp8_gemm_plain(x, wq, sw, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fp8_gemm: unsupported device {x.device}")
    e, m, k = x.shape
    n = wq.shape[-1]
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.float8_e4m3fn
            or sw.dtype != torch.float32 or out_dtype != torch.bfloat16):
        raise TypeError(f"fp8_gemm kernel takes bf16 x, e4m3 w, f32 scales "
                        f"and bf16 out; got {x.dtype}, {wq.dtype}, "
                        f"{sw.dtype} -> {out_dtype}")
    if tuple(wq.shape) != (e, k, n) or tuple(sw.shape) != (e, n):
        raise ValueError(f"fp8_gemm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, sw {tuple(sw.shape)}")
    for t in (x, wq, sw):
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError("fp8_gemm takes contiguous tensors on one "
                             "device")
    out = torch.empty((e, m, n), dtype=torch.bfloat16, device=x.device)
    # scratch: x quantized once per call, and its row scales
    xq = torch.empty((e, m, k), dtype=torch.uint8, device=x.device)
    sx = torch.empty((e, m), dtype=torch.float32, device=x.device)
    code = _lib().fp8_gemm_launch(
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(),
        xq.data_ptr(), sx.data_ptr(), e, m, n, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fp8_gemm")
    fp8_gemm.launches += 1
    return out


fp8_gemm.launches = 0
