"""Kernel ``radix_topk``: row-wise top-k by radix select over an
order-preserving u32 key, the select of the serving engine under
``use_radix_topk``.

Replaces ``repro/kernels/radix_topk/kernel.py`` (``hist_round_pallas``,
``emit_pallas``) and their orchestration in ``repro/kernels/radix_topk/
ops.py`` (``_threshold_scan``, ``_radix_topk``); the CUDA source is
``src/repro_torch/csrc/radix_topk.cu``, where both Pallas kernels are one
kernel.  ``radix_topk`` dispatches on the tensor's device: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises, a
``meta`` tensor gets the output's shape and dtype (``analysis.tally``).
``plan`` is the launch's host-side plan (keys a thread, threads a block,
tiles, vector loads), a plain function of the shape, dtype and
alignment.

The function is the JAX kernel's, which is not ``torch.topk``'s:

  * selection is by ``monotone_u32``, which ranks ``-0.0`` below ``+0.0``,
    with ties to the lowest index;
  * the row is padded, as the JAX wrapper pads it, to a multiple of 2048
    columns when it is longer than 2048, with ``float32`` min cast to x's
    dtype (``-inf`` for bf16); a pad column wins over a real ``-inf``;
  * the output is sorted by value, descending and stable, so equal values
    stay in index order; a selected ``-0.0`` comes out as ``+0.0`` (the
    Pallas emission sums it into a zero accumulator).

Inputs must be finite or ``-inf`` (NaN is unsupported, as in JAX; a
selected ``+inf`` turns the Pallas emission's one-hot product into NaN).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.analysis import tally
from repro_torch.kernels import build

BLOCK_V = 2048      # the JAX wrapper's column block: rows pad to a multiple
MAX_K = 1024        # the kernel's output buffer, one slot a thread at most
MAX_THREADS = 1024  # threads a block
KEYS_PER_THREAD = (4, 8, 16)    # the kernel's instantiations
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_F32_MIN = float(torch.finfo(torch.float32).min)


class Plan(NamedTuple):
    """How the kernel's one block a row covers it: ``kpt`` keys a thread
    in registers, ``threads`` a block, ``tiles`` tiles of ``threads * kpt``
    columns (1: the row is read once), ``vec`` 16-byte loads."""
    kpt: int
    threads: int
    tiles: int
    vec: bool


@functools.lru_cache(maxsize=256)
def plan(b: int, v: int, dtype: torch.dtype, aligned: bool) -> Plan:
    """The launch plan of a (b, v) row block of ``dtype`` whose data starts
    on a 16-byte boundary when ``aligned``: the fewest keys a thread that
    let one block hold the row in registers, and past 1024 x 16 columns
    tiles of that size, re-read from L2 in each pass."""
    kpt = next((p for p in KEYS_PER_THREAD if v <= MAX_THREADS * p),
               KEYS_PER_THREAD[-1])
    threads = min(MAX_THREADS, 32 * -(-v // (32 * kpt)))
    tiles = -(-v // (threads * kpt))
    itemsize = 2 if dtype == torch.bfloat16 else 4
    return Plan(kpt, threads, tiles, aligned and v * itemsize % 16 == 0)


def monotone_u32(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving f32 -> u32 key, held in int64 (PyTorch's uint32
    has few operations): negatives flip every bit, the rest set the sign
    bit."""
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (bits >> 31) == 1
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | 0x80000000)


def padded_len(v: int) -> int:
    """Row length after the JAX wrapper's padding to ``BLOCK_V``."""
    bv = min(BLOCK_V, v)
    return v + (-v) % bv


@functools.lru_cache(maxsize=None)
def pad_value(dtype: torch.dtype) -> float:
    """The pad column's value: float32 min, cast to the input's dtype."""
    return float(torch.tensor(_F32_MIN, dtype=dtype).to(torch.float32))


def radix_topk_plain(x: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, V) -> (values (B, k) f32, indices (B, k) int32)."""
    b, v = x.shape
    vp = padded_len(v)
    xf = x.to(torch.float32)
    if vp > v:
        xf = torch.cat([xf, xf.new_full((b, vp - v), pad_value(x.dtype))], 1)
    # the k largest keys, ties to the lowest index: a stable sort keeps
    # equal keys in index order
    order = torch.sort(monotone_u32(xf), dim=1, descending=True,
                       stable=True).indices[:, :k]
    idx = torch.sort(order, dim=1).values          # emission: index order
    vals = xf.gather(1, idx) + 0.0                 # -0.0 -> +0.0
    by_val = torch.sort(vals, dim=1, descending=True, stable=True).indices
    return vals.gather(1, by_val), idx.gather(1, by_val).to(torch.int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The kernel's library, its argument types set once."""
    lib = build.load("radix_topk")
    lib.radix_topk_launch.argtypes = ([_VP] * 3 + [_I] * 5 + [_F]
                                      + [_I] * 4 + [_VP])
    lib.radix_topk_launch.restype = _I
    lib.radix_topk_empty_launch.argtypes = [_I] * 2 + [_VP]
    lib.radix_topk_empty_launch.restype = _I
    return lib


def radix_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise top-k of x (B, V) f32 or bf16 -> (values (B, k) f32,
    indices (B, k) int32); see the module docstring for the order."""
    if x.ndim != 2:
        raise ValueError(f"radix_topk takes (B, V), got {tuple(x.shape)}")
    b, v = x.shape
    if not 1 <= k <= v:
        raise ValueError(f"radix_topk takes 1 <= k <= V, got k={k}, V={v}")
    if x.device.type == "cpu":
        return radix_topk_plain(x, k)
    if x.device.type == "meta":
        vals = x.new_empty((b, k), dtype=torch.float32)
        idx = x.new_empty((b, k), dtype=torch.int32)
        tally.add("radix_topk", 0, tally.nbytes(x, vals, idx))
        return vals, idx
    if x.device.type != "cuda":
        raise ValueError(f"radix_topk: unsupported device {x.device}")
    if k > MAX_K:
        raise ValueError(f"radix_topk kernel takes k <= {MAX_K}, got {k}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"radix_topk kernel takes f32 or bf16, got "
                        f"{x.dtype}")
    x = x.contiguous()
    p = plan(b, v, x.dtype, x.data_ptr() % 16 == 0)
    vals = torch.empty((b, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((b, k), dtype=torch.int32, device=x.device)
    code = _lib().radix_topk_launch(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), b, v,
        padded_len(v) - v, k, int(x.dtype == torch.bfloat16),
        pad_value(x.dtype), p.kpt, p.threads, p.tiles, int(p.vec),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "radix_topk")
    radix_topk.launches += 1
    return vals, idx


def empty_launch(x: torch.Tensor, p: Plan) -> None:
    """An empty kernel on the grid and block of plan ``p`` for x's rows:
    the floor under any launch of that shape."""
    code = _lib().radix_topk_empty_launch(
        x.shape[0], p.threads,
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(code, "radix_topk empty kernel")


radix_topk.launches = 0
