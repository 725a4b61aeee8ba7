"""Kernel ``batch_attention``: GQA attention of a batch of query rows over a
dense per-row KV cache, the decode attention of the contiguous slot-pool
layout under ``use_attention_kernel``.

Replaces ``repro/kernels/batch_attention/kernel.py``
(``batch_attention_pallas``) behind the JAX wrapper's layout
(``repro/kernels/batch_attention/ops.py``); the CUDA source is
``src/repro_torch/csrc/batch_attention.cu``.  ``batch_attention``
dispatches on the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel or raises.

The plain version computes the Pallas kernel's function at one S block,
which is what the JAX wrapper runs for S <= 512 (the engine's S is
``context_len + 1``, 388 at full width): f32 scores times ``scale``,
masked keys at -2e38, ``p = exp(s - max)`` zeroed where masked, ``l`` its
f32 sum, the PV product of p ROUNDED TO V's DTYPE (bf16) summed in f32,
then ``acc / max(l, 1e-20)`` (0 for a row with no valid key) as bf16.  The
kernel folds 128-key tiles (64 above head_dim 128) into an online
softmax, so its p is rounded
relative to the running max; the two agree to a bf16 ulp of the output.
``repro/kernels/batch_attention/ref.py`` normalises first and keeps p in
f32: it differs from both by the bf16 rounding of p, at most 2**-9 of the
largest |v| (the JAX suite's bound against it is an absolute 0.05).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38
MAX_HEAD_DIM = 256
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def batch_attention_plain(q, k, v, q_pos, k_pos, *, scale: float,
                          window: int = 0) -> torch.Tensor:
    """q (B, T, H, hd); k/v (B, S, Kv, hd); q_pos (B, T) and k_pos (B, S),
    -1 = empty key -> (B, T, H * hd) bf16."""
    b, t, h, hd = q.shape
    kv = k.shape[2]
    qh = q.reshape(b, t, kv, h // kv, hd)
    s = torch.einsum("btkgh,bskh->bkgts", qh.float(), k.float()) * scale
    kp, qp = k_pos[:, None, :], q_pos[:, :, None]
    valid = (kp >= 0) & (kp <= qp)                        # (B, T, S)
    if window:
        valid = valid & (qp - kp < window)
    valid = valid[:, None, None]                          # (B, 1, 1, T, S)
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bkgts,bskh->bkgth", p.to(v.dtype).float(),
                       v.float())
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
