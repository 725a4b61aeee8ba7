"""Param initializers and the MLP towers.  Every matmul weight is a leaf
named ``kernel`` inside a named module dict in the ``(in, out)`` layout:
that naming is the contract the PTQ policy matches against
(``repro_torch/core/policy.py``), so a quantized tree runs the same apply
functions through ``core.quant.matmul_any``.  Random init runs on the
target device from a ``torch.Generator``, so a full-width model never
passes through host memory."""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core.quant import QuantizedTensor, matmul_any
from repro_torch.tree import leaves_with_path


def truncated_normal(shape, stddev: float, gen: torch.Generator,
                     device, dtype=torch.float32) -> torch.Tensor:
    """``stddev * N(0, 1)`` truncated to two standard deviations, drawn in
    f32 and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t = torch.nn.init.trunc_normal_(t, 0.0, stddev, -2.0 * stddev,
                                    2.0 * stddev, generator=gen)
    return t if dtype == torch.float32 else t.to(dtype)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               stack: Tuple[int, ...] = (), stddev: Optional[float] = None,
               dtype=torch.float32, device=None) -> dict:
    """A linear projection param dict: {"kernel": (*stack, in, out)}."""
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(in_dim)
    return {"kernel": truncated_normal((*stack, in_dim, out_dim), stddev,
                                       gen, device, dtype)}


def split(gen: torch.Generator) -> torch.Generator:
    """A new generator on ``gen``'s device seeded from one draw of ``gen``:
    the port's ``jax.random.split``, so one module's init draws from its own
    stream whatever the others draw."""
    seed = torch.randint(0, 2 ** 62, (), generator=gen, device=gen.device)
    return torch.Generator(device=gen.device).manual_seed(int(seed))


def mlp_stack_init(gen: torch.Generator, dims: Sequence[int], *,
                   dtype=torch.float32, device=None) -> dict:
    """An MLP tower {"0": dense, "1": dense, ...} of ``len(dims) - 1``
    layers, each drawn from its own split of ``gen``, with zero biases."""
    params = {}
    for i in range(len(dims) - 1):
        params[str(i)] = dense_init(split(gen), dims[i], dims[i + 1],
                                    dtype=dtype, device=device)
        params[str(i)]["bias"] = torch.zeros((dims[i + 1],), dtype=dtype,
                                             device=device)
    return params


def mlp_stack_apply(params: dict, x: torch.Tensor, *, act=torch.relu,
                    final_act: bool = False) -> torch.Tensor:
    """Each layer ``x @ kernel + bias`` in x's dtype through ``matmul_any``
    (kernel ``fp8_gemm`` for a per-channel fp8 kernel), ``act`` between
    layers and after the last when ``final_act``."""
    n = len(params)
    for i in range(n):
        p = params[str(i)]
        x = matmul_any(x, p["kernel"], out_dtype=x.dtype) \
            + p["bias"].to(x.dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x


def kernel_shape(w) -> Tuple[int, ...]:
    return tuple(w.data.shape if isinstance(w, QuantizedTensor) else w.shape)


def param_count(params) -> int:
    """Elements over every leaf (a quantized leaf counts its payload)."""
    return sum((leaf.data if isinstance(leaf, QuantizedTensor) else leaf
                ).numel() for _, leaf in leaves_with_path(params))
