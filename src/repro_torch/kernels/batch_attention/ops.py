"""Kernel ``batch_attention``: GQA attention of a batch of query rows over a
dense per-row KV cache, the decode attention of the contiguous slot-pool
and shared-index layouts under ``use_attention_kernel``.

Replaces ``repro/kernels/batch_attention/kernel.py``
(``batch_attention_pallas``) behind the JAX wrapper's layout
(``repro/kernels/batch_attention/ops.py``); the CUDA source is
``src/repro_torch/csrc/batch_attention.cu``.  ``batch_attention``
dispatches on the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises, a ``meta`` tensor gets the
output's shape and dtype (``analysis.tally``).  K and V are bf16, or an fp8
cache's e4m3 payload with its f32 ``k_scale`` / ``v_scale`` (B, S, Kv):
the function is then the same over ``quant.dequantize_kv`` of the payload,
which the kernel computes in its tile load (the JAX package dequantizes,
then calls the Pallas kernel).

The plain version computes the Pallas kernel's function block by block as
the JAX wrapper runs it: S in blocks of 512 keys, halved until the block
divides S (one block at the engine's S = 388; 257 blocks of 16 at S =
4112), each folded into an online softmax in f32 (running max m, sum l,
accumulator rescaled by ``exp(m_old - m_new)``): f32 scores times
``scale``, masked keys at -2e38, ``p = exp(s - m_new)`` zeroed where
masked, the PV product of p ROUNDED TO V's DTYPE (bf16) summed in f32,
then ``acc / max(l, 1e-20)`` (0 for a row with no valid key) as bf16.  The
kernel folds 128-key tiles (64 above head_dim 128) into the same online
softmax, split over blocks by ``plan`` and combined in split order, so its
p is rounded relative to another running max; the two agree to a bf16 ulp
of the output.  ``repro/kernels/batch_attention/ref.py`` normalises first
and keeps p in f32: it differs from both by the bf16 rounding of p, at
most 2**-9 of the largest |v| (the JAX suite's bound against it is an
absolute 0.05).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import tally
from repro_torch.core import quant
from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
MAX_ROWS = 16          # query rows of a block (one m16 tile)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def block_size(s_len: int, block_s: int = 512) -> int:
    """The JAX wrapper's S block: ``min(block_s, S)``, halved until it
    divides S."""
    bs = min(block_s, s_len)
    while s_len % bs and bs > 1:
        bs //= 2
    return bs


class Plan(NamedTuple):
    """The kernel's launch shape: ``row_blocks`` blocks of at most 16 query
    rows per (KV head, batch row), the cache's ``n_tiles`` tiles of
    ``tile`` keys in ``splits`` key splits of ``per_split`` tiles each."""
    row_blocks: int
    splits: int
    per_split: int
    tile: int
    n_tiles: int

    def ranges(self) -> List[Tuple[int, int]]:
        """Each split's tiles ``[start, stop)``, as the kernel takes them."""
        return [(min(i * self.per_split, self.n_tiles),
                 min((i + 1) * self.per_split, self.n_tiles))
                for i in range(self.splits)]


def plan(b: int, t: int, h: int, kv: int, s_len: int, hd: int, sms: int,
         splits: Optional[int] = None) -> Plan:
    """Split the keys over blocks (flash-decoding) so that the grid of KV
    heads x rows x row blocks x splits fills about one wave of the card.

    A block holds one 128-key tile ring (64-key above head_dim 128) and
    fills an SM's shared memory above head_dim 64, half of it up to 64.
    The time is taken as waves x tiles a split: of the splits with at most
    two waves, the fewest that minimise it.  A grid that already fills the
    card keeps one split (OneRec's decode: 128 blocks).  ``splits`` forces
    a count (clipped to the tiles; the card tests use it)."""
    tile = 128 if hd <= 128 else 64
    n_tiles = -(-s_len // tile)
    row_blocks = -(-(h // kv) * t // MAX_ROWS)
    base = max(1, kv * b * row_blocks)
    slots = sms * (2 if hd <= 64 else 1)          # blocks resident at once
    if splits is None:
        top = max(1, min(n_tiles, -(-2 * slots // base)))
        splits = min(range(1, top + 1), key=lambda s: (
            -(-base * s // slots) * -(-n_tiles // s), s))
    splits = max(1, min(int(splits), n_tiles))
    per_split = -(-n_tiles // splits) if n_tiles else 1
    splits = -(-n_tiles // per_split) if n_tiles else 1
    return Plan(row_blocks, splits, per_split, tile, n_tiles)


def batch_attention_plain(q, k, v, q_pos, k_pos, *, scale: float,
                          window: int = 0, k_scale=None,
                          v_scale=None) -> torch.Tensor:
    """q (B, T, H, hd); k/v (B, S, Kv, hd), or an fp8 payload with f32
    ``k_scale``/``v_scale`` (B, S, Kv); q_pos (B, T) and k_pos (B, S),
    -1 = empty key -> (B, T, H * hd) bf16."""
    if k_scale is not None:
        k = quant.dequantize_kv(k, k_scale, q.dtype)
        v = quant.dequantize_kv(v, v_scale, q.dtype)
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    qh = q.reshape(b, t, kv, h // kv, hd).float()
    qp = q_pos[:, None, None, :, None]                    # (B,1,1,T,1)
    m = torch.full((b, kv, h // kv, t, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, kv, h // kv, t, hd), device=q.device)
    bs = block_size(s_len)
    for s0 in range(0, s_len, bs):
        kb, vb = k[:, s0:s0 + bs], v[:, s0:s0 + bs]
        s = torch.einsum("btkgh,bskh->bkgts", qh, kb.float()) * scale
        kp = k_pos[:, None, None, None, s0:s0 + bs]       # (B,1,1,1,bs)
        valid = (kp >= 0) & (kp <= qp)
        if window:
            valid = valid & (qp - kp < window)
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bkgts,bskh->bkgth", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = torch.where(l > 0, acc / l.clamp_min(1e-20), 0.0)
    return (out.to(torch.bfloat16).permute(0, 3, 1, 2, 4)
            .reshape(b, t, h * hd))


_FNS: Dict[str, Any] = {}
_COUNTERS: Dict[int, torch.Tensor] = {}


def _launch():
    """The library's entry point, typed once."""
    if not _FNS:
        fn = build.load("batch_attention").batch_attention_launch
        fn.argtypes = [_VP] * 10 + [_I] * 6 + [_F] + [_I] * 5 + [_VP]
        fn.restype = _I
        _FNS["launch"] = fn
    return _FNS["launch"]


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's split counters: one persistent zeroed int32 buffer,
    which every launch leaves zero (so a CUDA graph replays it).  It grows
    outside a capture only; calls on one device share it, so they run on
    one stream."""
    buf = _COUNTERS.get(device.index)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("batch_attention: its split counters grow "
                               "outside a CUDA graph capture; call it once "
                               "at this shape before capturing")
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device.index] = buf
    return buf


def _check(q, k, v, q_pos, k_pos, k_scale, v_scale) -> None:
    """What the kernel refuses, named before any launch."""
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    if (k_scale is None) != (v_scale is None):
        raise TypeError("batch_attention takes both k_scale and v_scale or "
                        "neither")
    quantized = k_scale is not None
    kv_dtype = torch.float8_e4m3fn if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype or (quantized and (
                k_scale.dtype != torch.float32
                or v_scale.dtype != torch.float32)):
        raise TypeError(
            f"batch_attention kernel takes bf16 q with bf16 K/V, or with "
            f"float8_e4m3fn K/V and f32 scales; got q {q.dtype}, K/V "
            f"{k.dtype}, {v.dtype}, scales "
            f"{None if k_scale is None else k_scale.dtype}")
    if hd % 32 or hd > MAX_HEAD_DIM or h % kv:
        raise ValueError(f"batch_attention kernel takes head_dim a multiple "
                         f"of 32 up to {MAX_HEAD_DIM} (its ring of K/V "
                         f"tiles fills shared memory) and H a "
                         f"multiple of Kv; got hd={hd}, H={h}, Kv={kv}")
    if (tuple(k.shape) != (b, s_len, kv, hd) or v.shape != k.shape
            or tuple(q_pos.shape) != (b, t)
            or tuple(k_pos.shape) != (b, s_len)
            or (quantized and (tuple(k_scale.shape) != (b, s_len, kv)
                               or v_scale.shape != k_scale.shape))):
        raise ValueError(f"batch_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}"
                         + (f", scales {tuple(k_scale.shape)}, "
                            f"{tuple(v_scale.shape)}" if quantized else ""))
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("batch_attention takes int32 q_pos and k_pos")
    for x in (q, k, v, q_pos, k_pos, k_scale, v_scale):
        if x is not None and (not x.is_contiguous()
                              or x.device != q.device):
            raise ValueError("batch_attention takes contiguous tensors on "
                             "one device")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("batch_attention takes 16-byte aligned q, k and v")


def batch_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    window: int = 0, k_scale=None, v_scale=None,
                    splits: Optional[int] = None) -> torch.Tensor:
    """The JAX wrapper's layout: q (B, T, H, hd), k/v (B, S, Kv, hd) bf16
    or an fp8 payload with f32 ``k_scale``/``v_scale`` (B, S, Kv), q_pos
    (B, T), k_pos (B, S) -> (B, T, H * hd) bf16.  ``splits`` forces the
    kernel's key splits (default: ``plan``'s)."""
    if q.device.type == "cpu":
        return batch_attention_plain(q, k, v, q_pos, k_pos, scale=scale,
                                     window=window, k_scale=k_scale,
                                     v_scale=v_scale)
    if q.device.type == "meta":
        b, t, h, hd = q.shape
        out = q.new_empty((b, t, h * hd), dtype=torch.bfloat16)
        tally.add("batch_attention", 4 * q.numel() * k.shape[1],
                  tally.nbytes(q, k, v, q_pos, k_pos, out, k_scale,
                               v_scale))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"batch_attention: unsupported device {q.device}")
    _check(q, k, v, q_pos, k_pos, k_scale, v_scale)
    from repro_torch.kernels.fp8_gemm.ops import sm_count
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    p = plan(b, t, h, kv, s_len, hd, sm_count(q.device), splits)
    out = torch.empty((b, t, h * hd), dtype=torch.bfloat16, device=q.device)
    part = counters = None
    if p.splits > 1:
        groups = kv * b * p.row_blocks
        part = torch.empty(groups * p.splits * MAX_ROWS * (hd + 2),
                           dtype=torch.float32, device=q.device)
        counters = _counters(q.device, groups)
    quantized = k_scale is not None
    code = _launch()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if counters is None else counters.data_ptr(), b, t, h, kv,
        s_len, hd, float(scale), int(window), int(quantized), p.row_blocks,
        p.splits, p.per_split,
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "batch_attention")
    batch_attention.launches += 1
    return out


batch_attention.launches = 0
