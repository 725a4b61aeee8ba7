"""Decoder-only MoE transformer, layer-stacked like the JAX package.

Layers are grouped into homogeneous stacks (``layer_plan``); every leaf of a
stack keeps its leading layer axis, and the JAX ``lax.scan`` over that axis
is a Python loop here.  Only the OneRec serving path is ported: full
attention, MoE FFN on every layer, prefill fill into a per-slot or shared
cache, resume prefill over a cached prefix, single-token and tree decode
over the paged pool or the per-slot cache, and the shared-index decode of
generation (``prefill``, ``decode_step``, ``decode_fused``;
``repro/models/transformer.py``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.quant import matmul_any
from repro_torch.layers.attention import (AttnSpec, KVWrite,
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
            or cfg.use_qk_norm or cfg.n_shared_experts):
        raise NotImplementedError(
            f"{cfg.name}: only the OneRec MoE backbone is ported; dense "
            f"layers, windows, qk-norm, shared experts, sandwich norms, "
            f"tied or scaled embeddings wait for the model zoo (ROADMAP.md "
            f"queue N, item N7)")
    return [StackSpec(cfg.n_layers, (LayerKind("full", "moe"),))]


def attn_spec_for(cfg: TransformerConfig, kind: LayerKind) -> AttnSpec:
    return AttnSpec(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                    head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
                    chunk_size=cfg.attn_chunk_size,
                    use_kernel=cfg.use_attention_kernel)


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
                 kind: LayerKind, cache_lp, attn_kw: dict):
    h = rmsnorm_apply(lp["attn_norm"], x, eps=cfg.norm_eps)
    attn_out, _ = apply_attention(
        lp["attn"], h, attn_spec_for(cfg, kind), cache=cache_lp, **attn_kw)
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
    starts: Optional[torch.Tensor] = None,
    kv_write: Optional[KVWrite] = None,
    page_gather: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
    branch_stride: Optional[int] = None,
    cache_index: Optional[int] = None,
    last_index: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """tokens (B, T) -> (logits f32, cache).

    ``fill_cache=True`` with a per-slot cache (``init_kv_cache``) is the
    ragged prefill (``lengths`` the true row lengths); with ``starts`` and
    ``kv_write`` it is the resume prefill of each row's suffix over the
    prefix already cached, in a per-slot cache or, with ``page_gather``,
    in the paged pool (``init_kv_page_pool``).  Without ``fill_cache`` a
    paged pool with ``kv_write`` and ``page_tables`` (kernel
    ``paged_decode``) or ``page_gather`` (the gathered view) is paged
    single-token decode, and a per-slot cache with ``kv_write`` alone
    per-slot single-token decode (``lengths`` the per-row write index).
    ``branch_stride`` with ``starts`` makes any of those decodes a tree
    decode: tokens (B, C) are C branches per row, logits (B, C, V).  A
    shared cache (``init_kv_cache(..., per_slot=False)``) with
    ``cache_index`` (an int) is the shared-index decode.
    Caches are updated in place and returned.  ``last_index`` (B,) keeps only that
    position of each row before the final norm and ``lm_head``: logits
    (B, V) instead of (B, T, V) (both are row-wise, so the values are the
    same).
    """
    if inputs_embeds is not None:
        x = inputs_embeds.to(compute_dtype)
    else:
        x = embed_tokens(params, tokens, compute_dtype)
    attn_kw = dict(fill_cache=fill_cache, lengths=lengths, starts=starts,
                   kv_write=kv_write, page_gather=page_gather,
                   page_tables=page_tables, page_size=page_size,
                   branch_stride=branch_stride, cache_index=cache_index)
    for si, spec in enumerate(layer_plan(cfg)):
        stack_params = params["stacks"][str(si)]
        stack_cache = cache["stacks"][str(si)] if cache is not None else None
        for i in range(spec.n_periods):
            for pi, kind in enumerate(spec.kinds):
                key = f"p{pi}"
                c_lp = (tree.index(stack_cache[key], i)
                        if stack_cache is not None else None)
                x = _apply_layer(tree.index(stack_params[key], i), x, cfg,
                                 kind, c_lp, attn_kw)
    if last_index is not None:
        x = x[torch.arange(x.shape[0], device=x.device), last_index.long()]
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps)
    return logits_from_hidden(params, x), cache


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, *, per_slot: bool = True, device=None) -> dict:
    """KV cache stacked over layers like the params: per slot (every batch
    row keeps its own position occupancy, the serving cache) or, with
    ``per_slot=False``, one shared occupancy (``init_cache``)."""
    dtype = dtype or getattr(torch, cfg.kv_cache_dtype)
    return {"stacks": {
        str(si): {f"p{pi}": init_cache(batch, max_len,
                                        attn_spec_for(cfg, kind),
                                        stack=(spec.n_periods,),
                                        dtype=dtype, per_slot=per_slot,
                                        device=device)
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


# ---------------------------------------------------------------------------
# Generation steps over a shared cache
# ---------------------------------------------------------------------------


def prefill(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
            cache: dict) -> Tuple[torch.Tensor, dict]:
    """Run the prompt, fill the shared cache; returns last-position
    logits (B, V)."""
    logits, cache = forward(params, tokens, cfg, cache=cache,
                            fill_cache=True)
    return logits[:, -1], cache


def decode_step(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                cache: dict, index: int) -> Tuple[torch.Tensor, dict]:
    """One decode step: tokens (B, 1) at absolute position ``index``."""
    logits, cache = forward(params, tokens, cfg, cache=cache,
                            cache_index=index)
    return logits[:, -1], cache


def decode_fused(params: dict, first_tokens: torch.Tensor,
                 cfg: TransformerConfig, cache: dict, index: int,
                 n_steps: int) -> Tuple[torch.Tensor, dict]:
    """Greedy-generate ``n_steps`` tokens from ``first_tokens`` (B, 1) at
    ``index``: a loop of forwards where the JAX package scans.  Step j
    feeds its input token, the first or the argmax of step j - 1, at
    ``index + j``.  Returns (the input tokens (B, n_steps), cache)."""
    tok, toks = first_tokens, []
    for j in range(n_steps):
        logits, cache = forward(params, tok, cfg, cache=cache,
                                cache_index=index + j)
        toks.append(tok[:, 0])
        tok = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    return torch.stack(toks, dim=1), cache
