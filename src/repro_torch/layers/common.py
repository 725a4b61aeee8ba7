"""Param initializers.  Every matmul weight is a leaf named ``kernel`` inside
a named module dict in the ``(in, out)`` layout: that naming is the contract
the PTQ policy matches against (``repro_torch/core/policy.py``).  Random init
runs on the target device from a ``torch.Generator``, so a full-width model
never passes through host memory."""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def truncated_normal(shape, stddev: float, gen: torch.Generator,
                     device) -> torch.Tensor:
    """``stddev * N(0, 1)`` truncated to two standard deviations, f32."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                       2.0 * stddev, generator=gen)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               stack: Tuple[int, ...] = (), stddev: Optional[float] = None,
               device=None) -> dict:
    """A linear projection param dict: {"kernel": (*stack, in, out)}."""
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(in_dim)
    return {"kernel": truncated_normal((*stack, in_dim, out_dim), stddev,
                                       gen, device)}
