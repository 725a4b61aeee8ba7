"""Gated-MLP activations (the MoE experts' SwiGLU)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    "silu": lambda x: x * torch.sigmoid(x),    # jax.nn.silu's form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}
