"""Sparse MoE with capacity-bounded dispatch and a grouped GEMM expert path
(single device; the JAX package's expert-parallel ``shard_map`` path is a
later slice).

Route in f32 with top-k by a STABLE descending sort (ties to the lowest
expert index, as ``lax.top_k``), dispatch each assignment to a cumsum slot
of its expert's fixed-capacity buffer (assignments past capacity go to a
trash row that is cut off), run the grouped expert FFN over
``(E, capacity, d)`` buffers, and combine the weighted outputs back per
token.  The same arithmetic as ``repro/layers/moe.py`` ``_moe_local``.
Shared experts (``n_shared_experts``) are one dense gated MLP of width
``n_shared_experts * d_expert`` (``params["shared"]``) added to the routed
sum.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.core.quant import (QuantizedTensor, fp8_grouped_linear,
                                    fp8_grouped_matmul, matmul_any,
                                    raw_matmul)
from repro_torch.layers.common import truncated_normal
from repro_torch.layers.mlp import ACTIVATIONS, apply_mlp, init_mlp


class MoESpec(NamedTuple):
    n_experts: int           # logical experts (may be < padded)
    n_experts_padded: int    # padded to a multiple of the EP degree
    top_k: int
    d_model: int
    d_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
    norm_topk_prob: bool = False


def make_moe_spec(n_experts: int, top_k: int, d_model: int, d_expert: int,
                  *, n_shared_experts: int = 0, capacity_factor: float = 1.25,
                  act: str = "silu", norm_topk_prob: bool = False,
                  ep_degree: int = 16) -> MoESpec:
    padded = int(math.ceil(n_experts / ep_degree) * ep_degree)
    return MoESpec(n_experts, padded, top_k, d_model, d_expert,
                   n_shared_experts, capacity_factor, act, norm_topk_prob)


def init_moe(gen: torch.Generator, spec: MoESpec, *,
             stack: Tuple[int, ...] = (), dtype=torch.float32,
             device=None) -> dict:
    e, d, f = spec.n_experts_padded, spec.d_model, spec.d_expert
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def tn(shape, std):
        return truncated_normal(shape, std, gen, device, dtype)

    params = {
        "router": {"kernel": tn((*stack, d, e), std_in)},
        # stacked per-expert kernels == the grouped-GEMM operands
        "experts": {
            "gate": tn((*stack, e, d, f), std_in),
            "up": tn((*stack, e, d, f), std_in),
            "down": tn((*stack, e, f, d), std_out),
        },
    }
    if spec.n_shared_experts:
        params["shared"] = init_mlp(gen, d, spec.n_shared_experts * f,
                                    stack=stack, dtype=dtype, device=device)
    return params


def _grouped_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N); w raw (``raw_matmul``) or a
    QuantizedTensor: block-scaled, or per-channel (fp8 where the dims are
    not 128-aligned, or int8 experts: the exact int8 grouped product)."""
    if isinstance(w, QuantizedTensor):
        if w.granularity == "block":
            return fp8_grouped_matmul(x, w)
        return fp8_grouped_linear(x, w)
    return raw_matmul(x, w.to(x.dtype), x.dtype)


def _grouped_ffn(buf: torch.Tensor, experts: dict, act: str) -> torch.Tensor:
    """The grouped GEMM expert FFN (the paper's quantization target)."""
    fn = ACTIVATIONS[act]
    g = _grouped_matmul(buf, experts["gate"])
    u = _grouped_matmul(buf, experts["up"])
    h = fn(g.to(torch.float32)).to(buf.dtype) * u
    return _grouped_matmul(h, experts["down"])


def _capacity(n_tokens: int, spec: MoESpec) -> int:
    """Static per-expert capacity for the token slab."""
    c = int(math.ceil(n_tokens * spec.top_k * spec.capacity_factor
                      / spec.n_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def _route(router_kernel, xt: torch.Tensor, spec: MoESpec):
    """Router in f32.  Returns (weights (T, k), experts (T, k))."""
    logits = matmul_any(xt, router_kernel, out_dtype=torch.float32)
    if spec.n_experts_padded > spec.n_experts:  # mask padded experts
        bias = torch.zeros(spec.n_experts_padded, dtype=torch.float32,
                           device=xt.device)
        bias[spec.n_experts:] = -1e30
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :spec.top_k], topi[:, :spec.top_k]
    if spec.norm_topk_prob:
        topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    return topv, topi


def apply_moe(params: dict, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """MoE FFN over x (B, S, D): route -> dispatch -> grouped GEMM ->
    combine, all experts on this device."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    t, k, e = b * s, spec.top_k, spec.n_experts_padded
    cap = _capacity(t, spec)
    topv, topi = _route(params["router"]["kernel"], xt, spec)

    flat_e = topi.reshape(-1)                                # (T*k,)
    flat_w = topv.reshape(-1)
    token_id = torch.arange(t, device=x.device).repeat_interleave(k)
    # position of each assignment within its expert, in flat order
    oh = torch.nn.functional.one_hot(flat_e, e)             # (T*k, E)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=1)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, e * cap)   # e*cap = trash

    # dispatch into the fixed (E*C [+1 trash], D) buffer
    buf = torch.zeros((e * cap + 1, d), dtype=xt.dtype, device=x.device)
    buf[slot] = xt[token_id]
    h = _grouped_ffn(buf[:-1].reshape(e, cap, d), params["experts"], spec.act)

    # combine: gather each kept assignment's output, weight, and add a
    # token's k contributions in order, each sum rounded to the activation
    # dtype: the JAX scatter-add's order on the CPU (top-k > 2 makes the
    # order matter), deterministic on the card (no atomics)
    contrib = h.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
    contrib = contrib * (flat_w * keep).to(contrib.dtype)[:, None]
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    out = y.reshape(b, s, d)
    if spec.n_shared_experts:
        out = out + apply_mlp(params["shared"], x, act=spec.act)
    return out
