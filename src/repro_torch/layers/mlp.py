"""Dense gated-MLP (SwiGLU / GeGLU) feed-forward blocks, and the gated
activations the MoE experts share."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant import matmul_any
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.common import dense_init

ACTIVATIONS = {
    "silu": lambda x: x * torch.sigmoid(x),    # jax.nn.silu's form
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": torch.relu,
}


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             stack: Tuple[int, ...] = (), dtype=torch.float32,
             device=None) -> dict:
    return {
        "gate": dense_init(gen, d_model, d_ff, stack=stack, dtype=dtype,
                           device=device),
        "up": dense_init(gen, d_model, d_ff, stack=stack, dtype=dtype,
                         device=device),
        "down": dense_init(gen, d_ff, d_model, stack=stack, dtype=dtype,
                           device=device),
    }


def apply_mlp(params: dict, x: torch.Tensor, *,
              act: str = "silu") -> torch.Tensor:
    """``down(act(gate(x)) * up(x))``: the three products through
    ``matmul_any`` (kernel ``fp8_gemm`` for per-channel fp8 weights), the
    activation in f32 rounded back to x's dtype, as in the JAX package."""
    fn = ACTIVATIONS[act]
    g = matmul_any(x, params["gate"]["kernel"])
    u = matmul_any(x, params["up"]["kernel"])
    h = fn(g.to(torch.float32)).to(x.dtype) * u
    h = constrain(h, ("batch", "seq", "mlp"))
    out = matmul_any(h, params["down"]["kernel"])
    return constrain(out, ("batch", "seq", "embed"))
