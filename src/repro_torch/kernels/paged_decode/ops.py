"""Kernel ``paged_decode``: fused paged-decode attention over the paged KV
pool (page-table gather, fp8 dequant, GQA rows ``r = c*G + g``, branch-tree
mask, online softmax).

Replaces ``repro/kernels/paged_decode/kernel.py`` (``paged_decode_pallas``);
the CUDA source is ``src/repro_torch/csrc/paged_decode.cu``.  ``paged_decode``
dispatches on the tensor's device: a CPU tensor runs the plain version (a
dense gather through the page table plus a masked f32 softmax, the same
arithmetic as the JAX package's unfused paged path), a CUDA tensor launches
the kernel or raises.  ``paged_decode_attention`` is the layout wrapper of
``repro/kernels/paged_decode/ops.py``: single-token decode, or tree decode
(``starts`` and a branch stride).

The pool's last page is its sentinel (``pos`` -1 throughout), as the
serving pool lays it out: the kernel skips the keys only it holds.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from repro_torch.core import quant
from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_ROWS = 64       # C*G query rows: up to four m16 tiles of the kernel
HEAD_DIMS = (64, 128, 256)   # the kernel's head-dim template
# any logical position is < table_entries * page_size, so a start pushed to
# this value makes the whole row "shared prefix": single-token decode is the
# one-branch tree with a dead span term
FAR_START = 2 ** 30
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def paged_decode_plain(q, k, v, pos, k_scale, v_scale, tables, lengths,
                       starts, *, page_size: int, group: int,
                       branch_stride: int, scale: float) -> torch.Tensor:
    """Kernel layout: q (B, Kv, CG, hd); k/v (NPos, Kv, hd); pos (NPos,);
    k_scale/v_scale (NPos, Kv) or None; tables (B, P); lengths/starts (B,).
    Returns (B, Kv, CG, hd) in q's dtype."""
    bb, kv, cg, hd = q.shape
    n_p = tables.shape[1]
    s_len = n_p * page_size
    offs = torch.arange(page_size, device=q.device)
    flat = (tables.long()[:, :, None] * page_size + offs).reshape(bb, s_len)
    kg, vg = _gather(k, flat), _gather(v, flat)             # (B, S, Kv, hd)
    if k_scale is not None:
        kg = quant.dequantize_kv(kg, k_scale[flat], q.dtype)
        vg = quant.dequantize_kv(vg, v_scale[flat], q.dtype)
    else:
        kg, vg = kg.to(q.dtype), vg.to(q.dtype)
    posg = pos[flat]                                        # (B, S)
    scores = torch.einsum("bkrd,bskd->bkrs", q.float(), kg.float()) * scale
    logical = torch.arange(s_len, device=q.device)
    st = starts.long()[:, None]
    own_lo = (st + (torch.arange(cg, device=q.device) // group)
              * branch_stride)[:, :, None]                  # (B, CG, 1)
    shared = (logical < st)[:, None, :]                     # (B, 1, S)
    own = (logical >= own_lo) & (logical < own_lo + branch_stride)
    valid = ((posg >= 0) & (posg <= lengths.long()[:, None]))[:, None, :] \
        & (shared | own)                                    # (B, CG, S)
    valid = valid[:, None]                                  # (B, 1, CG, S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = torch.where(valid.any(-1, keepdim=True), probs, 0.0)
    out = torch.einsum("bkrs,bskd->bkrd", probs.to(vg.dtype).float(),
                       vg.float())
    return out.to(q.dtype)


def _gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[idx]``; an fp8 payload moves as bytes through the index op."""
    if quant.is_fp8_dtype(t.dtype):
        return t.view(torch.uint8)[idx].view(t.dtype)
    return t[idx]


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_decode")
    fn = lib.paged_decode_launch
    fn.argtypes = [_VP] * 10 + [_I] * 9 + [_F, _I, _VP]
    fn.restype = _I
    return lib


def paged_decode(q, k, v, pos, k_scale, v_scale, tables, lengths, starts,
                 *, page_size: int, group: int, branch_stride: int,
                 scale: float) -> torch.Tensor:
    """Kernel-layout entry point (see ``paged_decode_plain``)."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k, v, pos, k_scale, v_scale, tables,
                                  lengths, starts, page_size=page_size,
                                  group=group, branch_stride=branch_stride,
                                  scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode: unsupported device {q.device}")
    bb, kv, cg, hd = q.shape
    quantized = k_scale is not None
    kv_dtype = torch.float8_e4m3fn if quantized else torch.bfloat16
    if q.dtype != torch.bfloat16 or k.dtype != kv_dtype \
            or v.dtype != kv_dtype:
        raise TypeError(f"paged_decode kernel takes bf16 q and {kv_dtype} "
                        f"K/V; got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS or not 1 <= cg <= MAX_ROWS:
        raise ValueError(f"paged_decode kernel takes head_dim in "
                         f"{HEAD_DIMS} and 1..{MAX_ROWS} rows per head; got "
                         f"hd={hd}, rows={cg}")
    n_pos = k.shape[0]
    if (tuple(k.shape) != (n_pos, kv, hd) or tuple(v.shape) != k.shape
            or tuple(pos.shape) != (n_pos,) or n_pos % page_size):
        raise ValueError(f"paged_decode pool shapes: k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, pos {tuple(pos.shape)}")
    ints = (pos, tables, lengths, starts)
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError("paged_decode takes int32 pos, tables, lengths and "
                        "starts")
    tensors = (q, k, v, *ints) + ((k_scale, v_scale) if quantized else ())
    if quantized and (k_scale.dtype != torch.float32
                      or tuple(k_scale.shape) != (n_pos, kv)
                      or tuple(v_scale.shape) != (n_pos, kv)):
        raise ValueError("paged_decode takes f32 (NPos, Kv) K/V scales")
    for t in tensors:
        if not t.is_contiguous() or t.device != q.device:
            raise ValueError("paged_decode takes contiguous tensors on one "
                             "device")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("paged_decode takes 16-byte aligned q, k and v")
    out = torch.empty_like(q)
    code = _lib().paged_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None,
        tables.data_ptr(), lengths.data_ptr(), starts.data_ptr(),
        out.data_ptr(), bb, kv, cg, hd, tables.shape[1], page_size, group,
        branch_stride, n_pos, float(scale), int(quantized),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "paged_decode")
    paged_decode.launches += 1
    return out


paged_decode.launches = 0


def paged_decode_attention(q: torch.Tensor, cache: Dict[str, torch.Tensor],
                           tables: torch.Tensor, lengths: torch.Tensor,
                           starts: Optional[torch.Tensor] = None, *,
                           page_size: int, branch_stride: int = 1,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (B, C, H, hd) post-RoPE queries (C = 1, or the branch width of a
    tree step); ``cache`` holds one layer's POST-WRITE pool leaves, k/v
    (NPos, Kv, hd), pos (NPos,), plus k_scale/v_scale (NPos, Kv) for an fp8
    pool; ``tables`` (B, P) int32 physical page per logical entry (sentinel
    = unmapped).  ``starts=None`` is single-token decode (every row one
    branch whose mask is position validity); otherwise branch c of row i
    sees logical positions ``< starts[i]`` and its own span ``starts[i] +
    c * branch_stride`` .. ``+ branch_stride``.  Returns (B, C, H * hd)."""
    b, c, h, hd = q.shape
    kv = cache["k"].shape[-2]
    g = h // kv
    qk = (q.reshape(b, c, kv, g, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, kv, c * g, hd).contiguous())
    if starts is None:
        starts = torch.full((b,), FAR_START, dtype=torch.int32,
                            device=q.device)
        branch_stride = 1          # the span term is dead past FAR_START
    out = paged_decode(qk, cache["k"], cache["v"], cache["pos"],
                       cache.get("k_scale"), cache.get("v_scale"), tables,
                       lengths.to(torch.int32), starts.to(torch.int32),
                       page_size=page_size, group=g,
                       branch_stride=max(int(branch_stride), 1),
                       scale=scale or 1.0 / math.sqrt(hd))
    return (out.reshape(b, kv, c, g, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, c, h * hd))
