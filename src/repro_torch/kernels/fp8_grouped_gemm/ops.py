"""Kernel ``fp8_grouped_gemm``: block-scaled fp8 grouped GEMM (the MoE
experts), 1 x 128 activation scales computed per K slice, 128 x 128 weight
scales, each 128-deep partial scaled and accumulated in f32.

Replaces ``repro/kernels/fp8_grouped_gemm/kernel.py``
(``fp8_grouped_gemm_pallas``); the CUDA source is
``src/repro_torch/csrc/fp8_grouped_gemm.cu`` (one call launches the 1 x 128
quantization pass and the TMA + wgmma GEMM, see ``csrc/sm90_fp8.cuh``).
The wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (the port of ``repro/kernels/fp8_grouped_gemm/ref.py``), a CUDA
tensor launches the kernel or raises, a ``meta`` tensor gets the output's
shape and dtype (``analysis.tally``).

The kernel reads the weight K-major: ``wq`` (E, K, N) must be the transpose
view of an (E, N, K) array (``wq.stride(-2) == 1``), the layout
``core.quant.quantize_blockwise`` gives every block payload.  Any other
layout raises: the wrapper never transposes per call.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.core import quant
from repro_torch.analysis import tally
from repro_torch.kernels import build
from repro_torch.kernels.fp8_gemm.ops import expert_stride, sm_count

B = 128  # the paper's block granularity
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

PREFILL_TILE = 128       # output rows and columns of a prefill block
DECODE_TILE_N = 64       # weight rows (output columns) of a decode block
DECODE_TILES_C = (8, 16, 32)   # expert rows of a decode block (wgmma's N)
DECODE_MAX_C = 32        # rows per expert up to which the decode path runs


def fp8_grouped_gemm_plain(x: torch.Tensor, wq: torch.Tensor,
                           sw: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) @ (wq (E, K, N) e4m3, sw (E, K/B, N/B)) -> (E, C, N):
    ``out = sum_kb (Xq_kb . Wq_kb) * s_x[c, kb] * s_w[kb, nb]`` in f32,
    accumulated over kb in order.  ``wq`` may have any layout."""
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


class Plan(NamedTuple):
    """One call's launch: ``bc`` 0 for the prefill path, else the decode
    path's expert rows per block; ``grid`` the CUDA grid (x, y, z)."""
    bc: int
    grid: Tuple[int, int, int]


def prefill_plan(e: int, c: int, n: int, sms: int) -> Plan:
    """Persistent blocks, one per SM (at most one per tile), walking the
    128 x 128 output tiles."""
    n_tiles = (n // PREFILL_TILE) * -(-c // PREFILL_TILE) * e
    return Plan(0, (max(1, min(n_tiles, sms)), 1, 1))


def decode_plan(e: int, c: int, n: int, bc: int) -> Plan:
    """Blocks of 64 columns x ``bc`` rows over (N / 64, E, ceil(C / bc))."""
    return Plan(bc, (n // DECODE_TILE_N, e, -(-c // bc)))


def plan(e: int, c: int, n: int, sms: int) -> Plan:
    """The path and grid of one call: the prefill path above 32 rows per
    expert, else the decode path with ``bc`` the smallest of 8, 16, 32
    that holds C (measured on an H100: the decode path is faster up to 32
    rows, the prefill path from 48, ``PERF.md``)."""
    if c > DECODE_MAX_C:
        return prefill_plan(e, c, n, sms)
    return decode_plan(e, c, n, next(t for t in DECODE_TILES_C if t >= c))


def check_layout(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                 out_dtype) -> None:
    """Raise on what the kernel does not take (types, shapes, layout)."""
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.float8_e4m3fn
            or sw.dtype != torch.float32 or out_dtype != torch.bfloat16):
        raise TypeError(f"fp8_grouped_gemm kernel takes bf16 x, e4m3 w, f32 "
                        f"scales and bf16 out; got {x.dtype}, {wq.dtype}, "
                        f"{sw.dtype} -> {out_dtype}")
    if x.ndim != 3 or wq.ndim != 3:
        raise ValueError(f"fp8_grouped_gemm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}")
    e, _, k = x.shape
    n = wq.shape[-1]
    if (tuple(wq.shape) != (e, k, n)
            or tuple(sw.shape) != (e, k // B, n // B)):
        raise ValueError(f"fp8_grouped_gemm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, sw {tuple(sw.shape)}")
    if k % B or n % B:
        raise ValueError(f"fp8_grouped_gemm needs K, N multiples of {B}, "
                         f"got K={k} N={n}")
    se, sk, sn = wq.stride()
    if sk != 1 or sn % 16 or (e > 1 and se % 16):
        raise ValueError(
            f"fp8_grouped_gemm kernel takes the weight K-major: wq (E, K, N) "
            f"as the transpose view of an (E, N, K) array, wq.stride(-2) == "
            f"1 and the other strides multiples of 16 (the layout "
            f"quant.quantize_blockwise gives); got strides {wq.stride()}")
    if not (x.is_contiguous() and sw.is_contiguous()):
        raise ValueError("fp8_grouped_gemm takes contiguous x and sw")
    if x.device != wq.device or sw.device != x.device:
        raise ValueError("fp8_grouped_gemm takes tensors on one device")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("fp8_grouped_gemm takes 16-byte aligned x and wq")


_FNS: Dict[str, Any] = {}


def _fns() -> Dict[str, Any]:
    """The library's entry points, typed once."""
    if not _FNS:
        lib = build.load("fp8_grouped_gemm")
        for name, ptrs in (("fp8_grouped_gemm_launch", 6),
                           ("fp8_grouped_gemm_mma_launch", 5)):
            fn = getattr(lib, name)
            fn.argtypes = [_VP] * ptrs + [_I] * 4 + [_LL] * 2 + [_I] * 4 \
                + [_VP]
            fn.restype = _I
            _FNS[name] = fn
        fn = lib.fp8_grouped_gemm_quantize_launch
        fn.argtypes = [_VP] * 3 + [_I] * 3 + [_VP]
        fn.restype = _I
        _FNS["quantize"] = fn
    return _FNS


def _layout(e: int, c: int, k: int):
    """The scratch of one call in one allocation: byte offsets of xh
    (E, C, K) f16 (the e4m3 activations as the GEMM reads them, in the
    chunks' k order, ``csrc/sm90_fp8.cuh``) and sx (E, K/128, Cp) f32,
    Cp = C rounded up to a multiple of 4 (the prefill path's TMA reads sx
    rows at 16-byte strides), each 16-byte aligned.  Returns (offsets,
    total bytes)."""
    cp = -(-c // 4) * 4
    sizes = [-(-size // 16) * 16
             for size in (e * c * k * 2, e * (k // B) * cp * 4)]
    return [0, sizes[0]], sum(sizes)


def scratch(x: torch.Tensor):
    """The call's scratch as tensors, for running the two passes apart:
    (xh (E, C, K) f16, sx (E, K/128, C) f32, a view with row stride Cp)."""
    e, c, k = x.shape
    cp = -(-c // 4) * 4
    offs, total = _layout(e, c, k)
    buf = torch.empty(total, dtype=torch.uint8, device=x.device)
    xq = buf[:e * c * k * 2].view(torch.float16).view(e, c, k)
    sx = buf[offs[1]:offs[1] + e * (k // B) * cp * 4].view(
        torch.float32).view(e, k // B, cp)[:, :, :c]
    return xq, sx


def fp8_grouped_gemm(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                     *, out_dtype=torch.bfloat16) -> torch.Tensor:
    """x (E, C, K) bf16 @ (wq (E, K, N) e4m3 K-major, sw (E, K/128, N/128)
    f32) -> (E, C, N)."""
    k, n = x.shape[-1], wq.shape[-1]
    if k % B or n % B:
        raise ValueError(f"fp8_grouped_gemm needs K, N multiples of {B}, "
                         f"got K={k} N={n}")
    if x.device.type == "cpu":
        return fp8_grouped_gemm_plain(x, wq, sw, out_dtype)
    if x.device.type == "meta":
        out = x.new_empty((*x.shape[:2], n), dtype=out_dtype)
        tally.add("fp8_grouped_gemm", 2 * x.numel() * n,
                  tally.nbytes(x, wq, sw, out))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"fp8_grouped_gemm: unsupported device {x.device}")
    check_layout(x, wq, sw, out_dtype)
    e, c, _ = x.shape
    out = torch.empty((e, c, n), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(e, c, n, sm_count(x.device))
    offs, total = _layout(e, c, k)
    # one allocation, passed as raw pointers
    buf = torch.empty(total, dtype=torch.uint8, device=x.device)
    xq, sx = (buf.data_ptr() + off for off in offs)
    code = _fns()["fp8_grouped_gemm_launch"](
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(), xq, sx,
        e, c, n, k, wq.stride(-1), expert_stride(wq), p.bc, *p.grid,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fp8_grouped_gemm")
    fp8_grouped_gemm.launches += 1
    return out


fp8_grouped_gemm.launches = 0


def quantize_pass(x: torch.Tensor, xq: torch.Tensor,
                  sx: torch.Tensor) -> None:
    """The 1 x 128 quantization pass of ``fp8_grouped_gemm`` alone, into
    ``xq`` (f16), ``sx`` (for timing it apart from the GEMM; not a path of the
    port)."""
    e, c, k = x.shape
    build.check(_fns()["quantize"](
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), e, c, k,
        torch.cuda.current_stream(x.device).cuda_stream), "fp8_grouped_gemm")


def gemm_pass(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor, out: torch.Tensor, p: Plan) -> None:
    """The GEMM of ``fp8_grouped_gemm`` alone on already quantized
    activations and ``sx`` (E, K/128, C) (for timing it apart; not a path
    of the port): ``xq`` (E, C, K) f16 as the quantization pass writes
    it."""
    e, c, k = xq.shape
    n = wq.shape[-1]
    build.check(_fns()["fp8_grouped_gemm_mma_launch"](
        xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), e, c, n, k, wq.stride(-1), expert_stride(wq), p.bc,
        *p.grid, torch.cuda.current_stream(xq.device).cuda_stream),
        "fp8_grouped_gemm")
