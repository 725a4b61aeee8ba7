"""Rotary position embeddings (RoPE), f32 trig, applied per head."""

from __future__ import annotations

import functools

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, computed on the CPU (true division
    and pow, as in the JAX package) and moved to ``device``."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    return (1.0 / (theta ** exponent)).to(device)


@functools.lru_cache(maxsize=None)
def _cached_frequencies(head_dim: int, theta: float,
                        device: torch.device) -> torch.Tensor:
    """``rope_frequencies``, made and copied to ``device`` once per
    (head_dim, theta, device): a copy to the card waits for it, so a
    decode step must not make one (``analysis.guards``).  Read only."""
    return rope_frequencies(head_dim, theta, device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (seq,) or (batch, seq)."""
    freqs = _cached_frequencies(x.shape[-1], float(theta), x.device)
    angles = positions.to(torch.float32)[..., None] * freqs
    angles = angles[..., None, :]          # broadcast over the head axis
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
