"""Kernel ``batch_attention``: GQA attention of a batch of query rows over a
dense per-row KV cache, the decode attention of the contiguous slot-pool
layout under ``use_attention_kernel``.

Replaces ``repro/kernels/batch_attention/kernel.py``
(``batch_attention_pallas``) behind the JAX wrapper's layout
(``repro/kernels/batch_attention/ops.py``); the CUDA source is
``src/repro_torch/csrc/batch_attention.cu``.  ``batch_attention``
dispatches on the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises, a ``meta`` tensor gets the
output's shape and dtype (``analysis.tally``).

The plain version computes the Pallas kernel's function block by block as
the JAX wrapper runs it: S in blocks of 512 keys, halved until the block
divides S (one block at the engine's S = 388; 257 blocks of 16 at S =
4112), each folded into an online softmax in f32 (running max m, sum l,
accumulator rescaled by ``exp(m_old - m_new)``): f32 scores times
``scale``, masked keys at -2e38, ``p = exp(s - m_new)`` zeroed where
masked, the PV product of p ROUNDED TO V's DTYPE (bf16) summed in f32,
then ``acc / max(l, 1e-20)`` (0 for a row with no valid key) as bf16.  The
kernel folds 128-key tiles (64 above head_dim 128) into the same online
softmax, so its p is rounded relative to another running max; the two
agree to a bf16 ulp of the output.  ``repro/kernels/batch_attention/ref.py``
normalises first and keeps p in f32: it differs from both by the bf16
rounding of p, at most 2**-9 of the largest |v| (the JAX suite's bound
against it is an absolute 0.05).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from repro_torch.analysis import tally
from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def block_size(s_len: int, block_s: int = 512) -> int:
    """The JAX wrapper's S block: ``min(block_s, S)``, halved until it
    divides S."""
    bs = min(block_s, s_len)
    while s_len % bs and bs > 1:
        bs //= 2
    return bs


def batch_attention_plain(q, k, v, q_pos, k_pos, *, scale: float,
                          window: int = 0) -> torch.Tensor:
    """q (B, T, H, hd); k/v (B, S, Kv, hd); q_pos (B, T) and k_pos (B, S),
    -1 = empty key -> (B, T, H * hd) bf16."""
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


def _launch():
    """The library's entry point, typed once."""
    if not _FNS:
        fn = build.load("batch_attention").batch_attention_launch
        fn.argtypes = [_VP] * 6 + [_I] * 6 + [_F, _I, _VP]
        fn.restype = _I
        _FNS["launch"] = fn
    return _FNS["launch"]


def batch_attention(q, k, v, q_pos, k_pos, *, scale: float,
                    window: int = 0) -> torch.Tensor:
    """The JAX wrapper's layout: q (B, T, H, hd), k/v (B, S, Kv, hd),
    q_pos (B, T), k_pos (B, S) -> (B, T, H * hd) bf16."""
    if q.device.type == "cpu":
        return batch_attention_plain(q, k, v, q_pos, k_pos, scale=scale,
                                     window=window)
    if q.device.type == "meta":
        b, t, h, hd = q.shape
        out = q.new_empty((b, t, h * hd), dtype=torch.bfloat16)
        tally.add("batch_attention", 4 * q.numel() * k.shape[1],
                  tally.nbytes(q, k, v, q_pos, k_pos, out))
        return out
    if q.device.type != "cuda":
        raise ValueError(f"batch_attention: unsupported device {q.device}")
    b, t, h, hd = q.shape
    s_len, kv = k.shape[1], k.shape[2]
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise TypeError(f"batch_attention kernel takes bf16 q, k and v; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd % 32 or hd > MAX_HEAD_DIM or h % kv:
        raise ValueError(f"batch_attention kernel takes head_dim a multiple "
                         f"of 32 up to {MAX_HEAD_DIM} (its ring of bf16 K/V "
                         f"tiles fills shared memory) and H a "
                         f"multiple of Kv; got hd={hd}, H={h}, Kv={kv}")
    if (tuple(k.shape) != (b, s_len, kv, hd) or v.shape != k.shape
            or tuple(q_pos.shape) != (b, t)
            or tuple(k_pos.shape) != (b, s_len)):
        raise ValueError(f"batch_attention shapes: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, q_pos "
                         f"{tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    if q_pos.dtype != torch.int32 or k_pos.dtype != torch.int32:
        raise TypeError("batch_attention takes int32 q_pos and k_pos")
    for x in (q, k, v, q_pos, k_pos):
        if not x.is_contiguous() or x.device != q.device:
            raise ValueError("batch_attention takes contiguous tensors on "
                             "one device")
    out = torch.empty((b, t, h * hd), dtype=torch.bfloat16, device=q.device)
    code = _launch()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), b, t, h, kv, s_len, hd,
        float(scale), int(window),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(code, "batch_attention")
    batch_attention.launches += 1
    return out


batch_attention.launches = 0
