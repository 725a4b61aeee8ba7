"""RMSNorm, kept in high precision per the paper's policy."""

from __future__ import annotations

import torch


def rmsnorm_apply(params: dict, x: torch.Tensor, *, eps: float = 1e-6,
                  zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in f32 (``zero_centered`` = gemma-style ``(1 + scale)``)."""
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = params["scale"].to(torch.float32)
    scale = 1.0 + scale if zero_centered else scale
    return (y * scale).to(x.dtype)
