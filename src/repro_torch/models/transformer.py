"""Decoder-only MoE transformer, layer-stacked like the JAX package.

Layers are grouped into homogeneous stacks (``layer_plan``); every leaf of a
stack keeps its leading layer axis, and the JAX ``lax.scan`` over that axis
is a Python loop here.  Only the OneRec serving path is ported: full
attention, MoE FFN on every layer, prefill fill into a per-slot cache and
paged single-token decode (``repro/models/transformer.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.quant import matmul_any
from repro_torch.layers.attention import (AttnSpec, PageWrite,
                                          apply_attention, init_attention,
                                          init_cache, init_page_cache)
from repro_torch.layers.common import dense_init, truncated_normal
from repro_torch.layers.moe import MoESpec, apply_moe, init_moe, make_moe_spec
from repro_torch.layers.norms import rmsnorm_apply


class LayerKind(NamedTuple):
    attn: str           # "full" (the JAX package also has "window")
    ffn: str            # "moe" (the JAX package also has "dense")


class StackSpec(NamedTuple):
    n_periods: int
    kinds: Tuple[LayerKind, ...]


def layer_plan(cfg: TransformerConfig) -> List[StackSpec]:
    """The layer list as homogeneous stacks.  The ported backbone is one
    stack of full-attention MoE layers; leading dense layers and window
    patterns (more stacks in the JAX package) wait for the model zoo."""
    if (not cfg.moe or cfg.n_dense_layers or cfg.sliding_window
            or cfg.use_post_norm or cfg.tie_embeddings or cfg.embed_scale
            or cfg.shared_expert_gate or cfg.zero_centered_norm
            or cfg.use_qk_norm or cfg.use_attention_kernel
            or cfg.n_shared_experts):
        raise NotImplementedError(
            f"{cfg.name}: only the OneRec MoE backbone is ported; dense "
            f"layers, windows, qk-norm, shared experts, sandwich norms, "
            f"tied or scaled embeddings wait for the model zoo (ROADMAP.md "
            f"queue N, item N7)")
    return [StackSpec(cfg.n_layers, (LayerKind("full", "moe"),))]


def attn_spec_for(cfg: TransformerConfig, kind: LayerKind) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    chunk_size=cfg.attn_chunk_size)


def moe_spec_for(cfg: TransformerConfig) -> MoESpec:
    return make_moe_spec(
        cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_expert,
        n_shared_experts=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor, act=cfg.act,
        norm_topk_prob=cfg.norm_topk_prob, ep_degree=cfg.ep_degree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_transformer(gen: torch.Generator, cfg: TransformerConfig, *,
                     device=None) -> dict:
    """Random f32 params on ``device`` from ``gen``: the JAX package's tree
    (paths, shapes, init distributions), other random numbers."""
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": {"table": truncated_normal((cfg.vocab_size, d),
                                            1.0 / math.sqrt(d), gen,
                                            device)},
        "stacks": {},
        "final_norm": {"scale": torch.ones(d, device=device)},
    }
    for si, spec in enumerate(layer_plan(cfg)):
        stack = (spec.n_periods,)
        params["stacks"][str(si)] = {
            f"p{pi}": {
                "attn_norm": {"scale": torch.ones(stack + (d,),
                                                  device=device)},
                "attn": init_attention(gen, d, attn_spec_for(cfg, kind),
                                       stack=stack, device=device),
                "mlp_norm": {"scale": torch.ones(stack + (d,),
                                                 device=device)},
                "moe": init_moe(gen, moe_spec_for(cfg), stack=stack,
                                device=device),
            } for pi, kind in enumerate(spec.kinds)}
    params["lm_head"] = dense_init(gen, d, cfg.vocab_size, device=device)
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_layer(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
                 kind: LayerKind, cache_lp, fill_cache: bool, lengths,
                 page_write, page_tables, page_size):
    h = rmsnorm_apply(lp["attn_norm"], x, eps=cfg.norm_eps)
    attn_out, _ = apply_attention(
        lp["attn"], h, attn_spec_for(cfg, kind), cache=cache_lp,
        fill_cache=fill_cache, lengths=lengths, page_write=page_write,
        page_tables=page_tables, page_size=page_size)
    x = x + attn_out
    h = rmsnorm_apply(lp["mlp_norm"], x, eps=cfg.norm_eps)
    return x + apply_moe(lp["moe"], h, moe_spec_for(cfg))


def embed_tokens(params: dict, tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    return params["embed"]["table"][tokens.long()].to(compute_dtype)


def logits_from_hidden(params: dict, x: torch.Tensor) -> torch.Tensor:
    return matmul_any(x, params["lm_head"]["kernel"],
                      out_dtype=torch.float32)


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    *,
    cache: Optional[dict] = None,
    fill_cache: bool = False,
    compute_dtype=torch.bfloat16,
    inputs_embeds: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,
    page_write: Optional[PageWrite] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
    last_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """tokens (B, T) -> (logits f32, cache).

    ``fill_cache=True`` with a per-slot cache (``init_kv_cache``) is the
    ragged prefill (``lengths`` the true row lengths); a paged pool
    (``init_kv_page_pool``) with ``page_write``/``page_tables`` is paged
    single-token decode (``lengths`` the per-row write index).  Caches are
    updated in place and returned.  ``last_index`` (B,) keeps only that
    position of each row before the final norm and ``lm_head``: logits
    (B, V) instead of (B, T, V) (both are row-wise, so the values are the
    same).
    """
    if inputs_embeds is not None:
        x = inputs_embeds.to(compute_dtype)
    else:
        x = embed_tokens(params, tokens, compute_dtype)
    for si, spec in enumerate(layer_plan(cfg)):
        stack_params = params["stacks"][str(si)]
        stack_cache = cache["stacks"][str(si)] if cache is not None else None
        for i in range(spec.n_periods):
            for pi, kind in enumerate(spec.kinds):
                key = f"p{pi}"
                c_lp = (tree.index(stack_cache[key], i)
                        if stack_cache is not None else None)
                x = _apply_layer(tree.index(stack_params[key], i), x, cfg,
                                 kind, c_lp, fill_cache, lengths,
                                 page_write, page_tables, page_size)
    if last_index is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_index.long()]
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return logits_from_hidden(params, x), cache


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, *, device=None) -> dict:
    """Per-slot serving cache: every batch row keeps its own position
    occupancy (``init_cache``), stacked over layers like the params."""
    dtype = dtype or getattr(torch, cfg.kv_cache_dtype)
    return {"stacks": {
        str(si): {f"p{pi}": init_cache(batch, max_len,
                                        attn_spec_for(cfg, kind),
                                        stack=(spec.n_periods,),
                                        dtype=dtype, device=device)
                  for pi, kind in enumerate(spec.kinds)}
        for si, spec in enumerate(layer_plan(cfg))}}


def init_kv_page_pool(cfg: TransformerConfig, n_pages: int, page_size: int,
                      dtype=None, *, device=None) -> dict:
    """Paged serving cache: ``n_pages`` pages of ``page_size`` positions in
    one flat heap plus the trailing sentinel page, stacked over layers."""
    dtype = dtype or getattr(torch, cfg.kv_cache_dtype)
    if cfg.sliding_window:
        raise ValueError("paged KV caches require full attention")
    n_positions = (n_pages + 1) * page_size      # + the sentinel page
    return {"stacks": {
        str(si): {f"p{pi}": init_page_cache(n_positions,
                                             attn_spec_for(cfg, kind),
                                             stack=(spec.n_periods,),
                                             dtype=dtype, device=device)
                  for pi, kind in enumerate(spec.kinds)}
        for si, spec in enumerate(layer_plan(cfg))}}
