"""Kernel ``fp8_gemm``: per-row fp8 quantization of x (a dynamic scale per
row, one static calibrated scale, or a scale given per row), then an fp8
GEMM with f32 accumulation and the ``sx * sw`` epilogue, with a leading
batch dim.

Replaces ``repro/kernels/fp8_gemm/kernel.py`` (``fp8_gemm_pallas``); the
CUDA source is ``src/repro_torch/csrc/fp8_gemm.cu`` (one call launches the
quantization pass and the TMA + wgmma GEMM, see ``csrc/sm90_fp8.cuh``).
The wrapper dispatches on the tensor's device: a CPU tensor runs the plain
version (the port of ``repro/kernels/fp8_gemm/ref.py``, i.e.
``fp8_linear``'s per-token path, or its static path given ``act_scale``), a
CUDA tensor launches the kernel or raises, and a ``meta`` tensor gets the
output's shape and dtype and nothing else (shape inference for the dry
run: there is no data to compute on).  The given mode (``row_scale``)
serves the row-parallel products of tensor parallelism
(``core.quant.fp8_linear``): a rank holds a K-slice of each row and casts
it with the whole row's scale, reduced over the ranks beforehand.

The kernel reads the weight K-major: ``wq`` (E, K, N) must be the transpose
view of an (E, N, K16) array (``wq.stride(-2) == 1``, rows padded to a
multiple of 16 bytes), the layout ``core.quant.quantize_per_channel`` gives
every per-channel payload.  Any other layout raises: the wrapper never
transposes per call.  K and N may be any size (the recsys towers run K =
180, 200, 270 and N = 1, 80, 200), and x's rows any 2-byte boundary.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import quant
from repro_torch.analysis import tally
from repro_torch.kernels import build

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

CHUNK = 128           # K bytes per pipeline stage (one 128-byte swizzle row)
PREFILL_MIN_M = 256   # rows per batch entry from which the prefill path runs
DECODE_TILE_M, DECODE_TILE_N = 32, 64


def fp8_gemm_plain(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                   out_dtype=torch.bfloat16,
                   act_scale: Optional[torch.Tensor] = None,
                   row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, M, K) @ (wq (E, K, N) e4m3, sw (E, N) f32) -> (E, M, N):
    per-token quant of x (or its cast with the static ``act_scale``, one
    value, or with ``row_scale`` (E, M), one value a row), fp8 products
    summed in f32, ``acc * sx * sw``."""
    if act_scale is not None:
        sx = act_scale.reshape(1, 1, 1)
        xd = quant.cast_to_fp8(x, sx)
    elif row_scale is not None:
        sx = row_scale[..., None]
        xd = quant.cast_to_fp8(x, sx)
    else:
        xq = quant.quantize_per_token(x)
        xd, sx = xq.data, xq.scale
    acc = torch.matmul(xd.to(torch.float32), wq.to(torch.float32))
    return (acc * sx * sw[:, None, :]).to(out_dtype)


def plan(e: int, m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """``(splits, chunks per split)`` of one call: splits 0 is the prefill
    path (M >= 256); else the decode path splits K's 128-deep chunks so
    that about one block per SM streams the weight (fewer splits leave
    fewer partials to add: on an H100 one block per SM beat two at the
    decode q/o shape)."""
    if m >= PREFILL_MIN_M:
        return 0, 0
    chunks = -(-k // CHUNK)
    tiles = e * -(-m // DECODE_TILE_M) * -(-n // DECODE_TILE_N)
    splits = min(chunks, max(1, -(-sms // tiles)))
    cps = -(-chunks // splits)
    return -(-chunks // cps), cps


def check_layout(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                 out_dtype, act_scale: Optional[torch.Tensor] = None,
                 row_scale: Optional[torch.Tensor] = None) -> None:
    """Raise on what the kernel does not take (types, shapes, layout)."""
    if act_scale is not None and row_scale is not None:
        raise ValueError("fp8_gemm takes a static scale or given row "
                         "scales, not both")
    if row_scale is not None and (
            row_scale.dtype != torch.float32
            or tuple(row_scale.shape) != tuple(x.shape[:2])
            or not row_scale.is_contiguous()
            or row_scale.device != x.device):
        raise ValueError(f"fp8_gemm takes given row scales as a contiguous "
                         f"(E, M) = {tuple(x.shape[:2])} f32 tensor on the "
                         f"activations' device; got {row_scale.dtype} "
                         f"{tuple(row_scale.shape)} on {row_scale.device}")
    if act_scale is not None and (
            act_scale.dtype != torch.float32 or act_scale.numel() != 1
            or act_scale.device != x.device):
        raise ValueError(f"fp8_gemm takes a static scale of one f32 value "
                         f"on the activations' device; got "
                         f"{act_scale.dtype} {tuple(act_scale.shape)} on "
                         f"{act_scale.device}")
    e, m, k = x.shape
    n = wq.shape[-1]
    if (x.dtype != torch.bfloat16 or wq.dtype != torch.float8_e4m3fn
            or sw.dtype != torch.float32
            or out_dtype not in (torch.bfloat16, torch.float32)):
        raise TypeError(f"fp8_gemm kernel takes bf16 x, e4m3 w, f32 scales "
                        f"and bf16 or f32 out; got {x.dtype}, {wq.dtype}, "
                        f"{sw.dtype} -> {out_dtype}")
    if tuple(wq.shape) != (e, k, n) or tuple(sw.shape) != (e, n):
        raise ValueError(f"fp8_gemm shapes: x {tuple(x.shape)}, w "
                         f"{tuple(wq.shape)}, sw {tuple(sw.shape)}")
    se, sk, sn = wq.stride()
    if sk != 1 or sn % 16 or (e > 1 and se % 16):
        raise ValueError(
            f"fp8_gemm kernel takes the weight K-major: wq (E, K, N) as the "
            f"transpose view of an (E, N, K16) array (rows padded to 16 "
            f"bytes), wq.stride(-2) == 1 and the other strides multiples of "
            f"16 (the layout quant.quantize_per_channel gives); got strides "
            f"{wq.stride()}")
    if not (x.is_contiguous() and sw.is_contiguous()):
        raise ValueError("fp8_gemm takes contiguous x and sw")
    if x.device != wq.device or sw.device != x.device:
        raise ValueError("fp8_gemm takes tensors on one device")
    if wq.data_ptr() % 16:
        raise ValueError("fp8_gemm takes a 16-byte aligned wq")


_FNS: Dict[str, Any] = {}
_SMS: Dict[int, int] = {}


def _fns() -> Dict[str, Any]:
    """The library's entry points, typed once."""
    if not _FNS:
        lib = build.load("fp8_gemm")
        # the full call ends with its per_row flag, the GEMM alone without
        for name, args, flags in (("fp8_gemm_launch", 9, 4),
                                  ("fp8_gemm_mma_launch", 7, 3)):
            fn = getattr(lib, name)
            fn.argtypes = [_VP] * args + [_I] * 4 + [_LL] * 2 \
                + [_I] * flags + [_VP]
            fn.restype = _I
            _FNS[name] = fn
        fn = lib.fp8_gemm_quantize_launch
        fn.argtypes = [_VP] * 4 + [_LL, _I, _I, _VP]
        fn.restype = _I
        _FNS["quantize"] = fn
    return _FNS


def sm_count(device: torch.device) -> int:
    """The card's SM count (launch plans size their grids by it)."""
    i = device.index if device.index is not None \
        else torch.cuda.current_device()
    if i not in _SMS:
        _SMS[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SMS[i]


def padded(k: int) -> int:
    """The row length of the GEMM's f16 activations: K rounded up to a
    whole 128-deep chunk."""
    return -(-k // CHUNK) * CHUNK


def _layout(e: int, m: int, n: int, k: int, splits: int):
    """The scratch of one call in one allocation: byte offsets of xh
    (E, M, Kp) f16 (the e4m3 activations as the GEMM reads them, in the
    chunks' k order, ``csrc/sm90_fp8.cuh``), sx (E, M) f32, the split-K
    partials (one 64 x 32 f32 tile per split and tile) and the counters (one
    per tile); each region 16-byte aligned.  Returns (offsets, total bytes,
    partial floats, counters)."""
    tiles = e * -(-m // DECODE_TILE_M) * -(-n // DECODE_TILE_N)
    n_part = max(1, splits * tiles * DECODE_TILE_M * DECODE_TILE_N)
    n_count = tiles if splits else 1
    sizes = [e * m * padded(k) * 2, e * m * 4, n_part * 4, n_count * 4]
    sizes = [-(-size // 16) * 16 for size in sizes]
    offs = [sum(sizes[:i]) for i in range(4)]
    return offs, sum(sizes), n_part, n_count


def scratch(x: torch.Tensor, wq: torch.Tensor):
    """The call's plan and scratch as tensors, for running the two passes
    apart: (splits, cps, xh (E, M, Kp) f16, sx (E, M) f32, part f32,
    counters i32)."""
    e, m, k = x.shape
    n = wq.shape[-1]
    kp = padded(k)
    splits, cps = plan(e, m, n, k, sm_count(x.device))
    offs, total, n_part, n_count = _layout(e, m, n, k, splits)
    buf = torch.empty(total, dtype=torch.uint8, device=x.device)
    xq = buf[offs[0]:offs[0] + e * m * kp * 2].view(torch.float16).view(
        e, m, kp)
    sx = buf[offs[1]:offs[1] + e * m * 4].view(torch.float32).view(e, m)
    part = buf[offs[2]:offs[2] + n_part * 4].view(torch.float32)
    counters = buf[offs[3]:offs[3] + n_count * 4].view(torch.int32)
    return splits, cps, xq, sx, part, counters


def fp8_gemm(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor, *,
             out_dtype=torch.bfloat16,
             act_scale: Optional[torch.Tensor] = None,
             row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, M, K) bf16 @ (wq (E, K, N) e4m3 K-major, sw (E, N) f32)
    -> (E, M, N), bf16 or f32 (``out_dtype``); ``act_scale`` (one f32
    value on x's device): the static mode, every row cast with it;
    ``row_scale`` ((E, M) f32 on x's device): the given mode, row m cast
    with ``row_scale[e, m]`` (neither runs an amax reduction or a host
    read)."""
    if x.device.type == "cpu":
        return fp8_gemm_plain(x, wq, sw, out_dtype, act_scale, row_scale)
    if x.device.type == "meta":
        out = x.new_empty((x.shape[0], x.shape[1], wq.shape[-1]),
                          dtype=out_dtype)
        tally.add("fp8_gemm", 2 * x.numel() * wq.shape[-1], tally.nbytes(
            x, wq, sw, out, act_scale, row_scale))
        return out
    if x.device.type != "cuda":
        raise ValueError(f"fp8_gemm: unsupported device {x.device}")
    check_layout(x, wq, sw, out_dtype, act_scale, row_scale)
    e, m, k = x.shape
    n = wq.shape[-1]
    out = torch.empty((e, m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    splits, cps = plan(e, m, n, k, sm_count(x.device))
    offs, total, _, _ = _layout(e, m, n, k, splits)
    # one allocation (its counters are zeroed by the quantization pass)
    buf = torch.empty(total, dtype=torch.uint8, device=x.device)
    xq, sx, part, counters = (buf.data_ptr() + off for off in offs)
    given = act_scale if row_scale is None else row_scale
    code = _fns()["fp8_gemm_launch"](
        x.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(), xq, sx,
        part, counters, None if given is None else given.data_ptr(), e, m,
        n, k, wq.stride(-1), expert_stride(wq), splits, cps,
        int(out_dtype == torch.float32), int(row_scale is not None),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "fp8_gemm")
    fp8_gemm.launches += 1
    if row_scale is not None:
        fp8_gemm.given_launches += 1
    return out


fp8_gemm.launches = 0
fp8_gemm.given_launches = 0     # of them, in the given-scale mode


def expert_stride(wq: torch.Tensor) -> int:
    """Bytes between the leading-dim slices of a K-major e4m3 weight (any
    multiple of 16 for a single slice)."""
    return wq.stride(0) if wq.shape[0] > 1 else wq.shape[-1] * wq.stride(-1)


def quantize_pass(x: torch.Tensor, xh: torch.Tensor, sx: torch.Tensor,
                  act_scale: Optional[torch.Tensor] = None,
                  row_scale: Optional[torch.Tensor] = None) -> None:
    """The quantization pass of ``fp8_gemm`` alone, into ``xh``, ``sx``
    (for timing it apart from the GEMM; not a path of the port)."""
    e, m, k = x.shape
    given = act_scale if row_scale is None else row_scale
    build.check(_fns()["quantize"](
        x.data_ptr(), xh.data_ptr(), sx.data_ptr(),
        None if given is None else given.data_ptr(), e * m, k,
        int(row_scale is not None),
        torch.cuda.current_stream(x.device).cuda_stream), "fp8_gemm")


def gemm_pass(xh: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor, out: torch.Tensor, splits: int, cps: int,
              part: torch.Tensor, counters: torch.Tensor) -> None:
    """The GEMM of ``fp8_gemm`` alone on already quantized activations
    and ``sx`` (for timing it apart; not a path of the port): ``xh``
    (E, M, Kp) f16 as the quantization pass writes it.  ``counters`` must
    hold zeros on the first call; each call leaves them so."""
    e, m, _ = xh.shape
    k, n = wq.shape[-2:]
    build.check(_fns()["fp8_gemm_mma_launch"](
        xh.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
        out.data_ptr(), part.data_ptr(), counters.data_ptr(), e, m, n, k,
        wq.stride(-1), expert_stride(wq), splits, cps,
        int(out.dtype == torch.float32),
        torch.cuda.current_stream(xh.device).cuda_stream), "fp8_gemm")
