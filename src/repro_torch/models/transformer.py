"""Decoder-only transformer LM (dense + MoE), layer-stacked like the JAX
package (``repro/models/transformer.py``).

Layers are grouped into homogeneous stacks (``layer_plan``): leading dense
layers, then periods of a repeating pattern (gemma3's 5 local : 1 global
becomes a 6-layer period plus a remainder stack).  Every leaf of a stack
keeps its leading layer axis, and the JAX ``lax.scan`` over that axis is a
Python loop here.  Supports GQA and MHA, sliding-window + global
interleave, RoPE with a second theta for window layers, QK-norm, sandwich
and zero-centred norms, scaled and tied embeddings, dense gated MLPs
(SwiGLU / GeGLU), MoE with shared experts and their sigmoid gate, and the
cached modes: prefill into a per-slot or shared cache, resume prefill,
single-token and tree decode over the paged pool or the per-slot cache,
and the shared-index decode of generation (``prefill``, ``decode_step``,
``decode_fused``).

Tensor parallelism: params laid out on a mesh (``launch.steps.shard_args``)
make every activation a ``DTensor`` from the vocabulary-parallel embedding
on (``layers.embedding.gather_rows``); the layers follow
(``layers.attention``, ``layers.mlp``, ``layers.moe``), norms and residual
adds run shard by shard, and the logits come out of a column-parallel head,
sharded over the vocabulary, as in the JAX package under ``INFER_RULES``.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.configs.base import TransformerConfig
from repro_torch.core.quant import matmul_any
from repro_torch.core.stats import tap
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.attention import (AttnSpec, KVWrite,
                                          apply_attention, cache_len_for,
                                          init_attention, init_cache,
                                          init_page_cache)
from repro_torch.layers.common import dense_init, truncated_normal
from repro_torch.layers.embedding import gather_rows
from repro_torch.layers.mlp import apply_mlp, init_mlp
from repro_torch.layers.moe import (MoESpec, apply_moe, init_moe,
                                    load_balance_loss, make_moe_spec)
from repro_torch.layers.norms import rmsnorm_apply


class LayerKind(NamedTuple):
    attn: str           # "full" | "window"
    ffn: str            # "dense" | "moe"


class StackSpec(NamedTuple):
    n_periods: int
    kinds: Tuple[LayerKind, ...]


def layer_plan(cfg: TransformerConfig) -> List[StackSpec]:
    """Decompose the layer list into homogeneous stacks (the JAX package's
    plan, stack for stack: the param and cache keys ``stacks/<si>/p<pi>``
    follow it)."""
    plan: List[StackSpec] = []
    n = cfg.n_layers
    if cfg.moe and cfg.n_dense_layers:
        plan.append(StackSpec(cfg.n_dense_layers,
                              (LayerKind("full", "dense"),)))
        n -= cfg.n_dense_layers
    ffn = "moe" if cfg.moe else "dense"
    if cfg.global_interval and cfg.sliding_window:
        period = cfg.global_interval
        kinds = tuple(LayerKind("window", ffn) for _ in range(period - 1)) \
            + (LayerKind("full", ffn),)
        n_full = n // period
        rem = n - n_full * period
        if n_full:
            plan.append(StackSpec(n_full, kinds))
        if rem:
            plan.append(StackSpec(1, tuple(LayerKind("window", ffn)
                                           for _ in range(rem))))
    elif cfg.sliding_window:
        plan.append(StackSpec(n, (LayerKind("window", ffn),)))
    else:
        plan.append(StackSpec(n, (LayerKind("full", ffn),)))
    return [s for s in plan if s.n_periods > 0 and s.kinds]


def attn_spec_for(cfg: TransformerConfig, kind: LayerKind) -> AttnSpec:
    window = cfg.sliding_window if kind.attn == "window" else 0
    theta = cfg.rope_theta
    if kind.attn == "window" and cfg.rope_theta_local:
        theta = cfg.rope_theta_local
    return AttnSpec(
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=theta, window=window, use_qk_norm=cfg.use_qk_norm,
        chunk_size=cfg.attn_chunk_size, use_kernel=cfg.use_attention_kernel)


def moe_spec_for(cfg: TransformerConfig) -> MoESpec:
    return make_moe_spec(
        cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_expert,
        n_shared_experts=cfg.n_shared_experts,
        capacity_factor=cfg.capacity_factor, act=cfg.act,
        norm_topk_prob=cfg.norm_topk_prob, ep_degree=cfg.ep_degree)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _norm_scale(cfg: TransformerConfig, dtype, device):
    init = torch.zeros if cfg.zero_centered_norm else torch.ones
    return {"scale": init((cfg.d_model,), dtype=dtype, device=device)}


def init_layer(gen: torch.Generator, cfg: TransformerConfig, kind: LayerKind,
               *, dtype=torch.float32, device=None) -> dict:
    """One layer's params: the JAX package's ``_init_layer`` tree without
    the leading layer axis (``init_transformer`` stacks the layers)."""
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "attn_norm": _norm_scale(cfg, dtype, device),
        "attn": init_attention(gen, cfg.d_model, attn_spec_for(cfg, kind),
                               **kw),
        "mlp_norm": _norm_scale(cfg, dtype, device),
    }
    if kind.ffn == "moe":
        p["moe"] = init_moe(gen, moe_spec_for(cfg), **kw)
        if cfg.shared_expert_gate:
            p["moe"]["shared_gate"] = dense_init(gen, cfg.d_model, 1, **kw)
    else:
        p["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff_for_dense, **kw)
    if cfg.use_post_norm:
        p["post_attn_norm"] = _norm_scale(cfg, dtype, device)
        p["post_mlp_norm"] = _norm_scale(cfg, dtype, device)
    return p


def init_transformer(gen: torch.Generator, cfg: TransformerConfig, *,
                     dtype=torch.float32, device=None,
                     transform: Optional[Callable[[str, dict], dict]] = None
                     ) -> dict:
    """Random params of ``dtype`` on ``device`` from ``gen``: the JAX
    package's tree (paths, shapes, init distributions; no ``lm_head`` when
    the embeddings are tied), other random numbers.  Each stack's layers
    are made one at a time; ``transform(path, subtree)`` (PTQ: ``lambda p,
    t: ptq.quantize_params(t, policy, prefix=p)``) is applied to each layer
    as it is made and to the top-level leaves, so a full-width model never
    holds more than one raw layer."""
    transform = transform or (lambda _, t: t)
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": {"table": truncated_normal((cfg.vocab_size, d),
                                            1.0 / math.sqrt(d), gen, device,
                                            dtype)},
        "final_norm": _norm_scale(cfg, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, cfg.vocab_size, dtype=dtype,
                                       device=device)
    params = transform("", params)
    params["stacks"] = {}
    for si, spec in enumerate(layer_plan(cfg)):
        stack = {}
        for pi, kind in enumerate(spec.kinds):
            def make(_, kind=kind, path=f"stacks/{si}/p{pi}"):
                return transform(path, init_layer(gen, cfg, kind,
                                                  dtype=dtype, device=device))
            stack[f"p{pi}"] = tree.stack_layers(make, spec.n_periods)
        params["stacks"][str(si)] = stack
    return params


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _apply_layer(lp: dict, x: torch.Tensor, cfg: TransformerConfig,
                 kind: LayerKind, cache_lp, attn_kw: dict):
    def norm(name, y):
        return rmsnorm_apply(lp[name], y, eps=cfg.norm_eps,
                             zero_centered=cfg.zero_centered_norm)

    attn_out, _ = apply_attention(
        lp["attn"], norm("attn_norm", x), attn_spec_for(cfg, kind),
        cache=cache_lp, norm_eps=cfg.norm_eps, **attn_kw)
    if cfg.use_post_norm:
        attn_out = norm("post_attn_norm", attn_out)
    x = x + attn_out
    h = norm("mlp_norm", x)
    if kind.ffn == "moe":
        ff = apply_moe(lp["moe"], h, moe_spec_for(cfg))
        if cfg.shared_expert_gate and "shared_gate" in lp["moe"]:
            # the gate scales the whole MoE output, routed + shared, as in
            # the JAX package (ROADMAP "Known, not port faults")
            g = torch.sigmoid(matmul_any(
                h, lp["moe"]["shared_gate"]["kernel"],
                out_dtype=torch.float32))
            ff = ff * g.to(ff.dtype)
    else:
        ff = apply_mlp(lp["mlp"], h, act=cfg.act)
    if cfg.use_post_norm:
        ff = norm("post_mlp_norm", ff)
    return x + ff


def embed_tokens(params: dict, tokens: torch.Tensor, cfg: TransformerConfig,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table in ``compute_dtype``; with ``embed_scale`` times
    ``sqrt(d_model)`` rounded to ``compute_dtype`` (the JAX package's
    ``jnp.asarray(math.sqrt(d), bf16)``: 34.0 for gemma3's 1152)."""
    x = gather_rows(params["embed"]["table"], tokens).to(compute_dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=compute_dtype)
    return constrain(x, ("batch", "seq", "embed"))


def logits_from_hidden(params: dict, x: torch.Tensor,
                       cfg: TransformerConfig) -> torch.Tensor:
    """f32 logits through ``lm_head``, or the raw table's transpose when
    the embeddings are tied."""
    w = params["embed"]["table"].T if cfg.tie_embeddings \
        else params["lm_head"]["kernel"]
    return constrain(matmul_any(x, w, out_dtype=torch.float32),
                     ("batch", "seq", "vocab"))


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
        x = constrain(inputs_embeds.to(compute_dtype),
                      ("batch", "seq", "embed"))
    else:
        x = embed_tokens(params, tokens, cfg, compute_dtype)
    tap("embed_out", x)
    attn_kw = dict(fill_cache=fill_cache, lengths=lengths, starts=starts,
                   kv_write=kv_write, page_gather=page_gather,
                   page_tables=page_tables, page_size=page_size,
                   branch_stride=branch_stride, cache_index=cache_index)
    # the JAX scan body under jax.checkpoint: a layer's activations are
    # recomputed in the backward (training only; serving turns remat off)
    remat = cfg.remat and cache is None and torch.is_grad_enabled() \
        and x.requires_grad
    for si, spec in enumerate(layer_plan(cfg)):
        stack_params = params["stacks"][str(si)]
        stack_cache = cache["stacks"][str(si)] if cache is not None else None
        layers = {key: tree.unbind(lp, spec.n_periods)
                  for key, lp in stack_params.items()}
        for i in range(spec.n_periods):
            for pi, kind in enumerate(spec.kinds):
                key = f"p{pi}"
                c_lp = (tree.index(stack_cache[key], i)
                        if stack_cache is not None else None)
                if remat:
                    x = checkpoint(_apply_layer, layers[key][i], x, cfg,
                                   kind, c_lp, attn_kw, use_reentrant=False)
                else:
                    x = _apply_layer(layers[key][i], x, cfg, kind, c_lp,
                                     attn_kw)
                # layer-boundary residual sharding: the identity under the
                # base rules; TRAIN_RULES_SP seq-shards saved activations
                x = constrain(x, ("batch", "act_seq", "embed"))
                tap(f"layer_out/{key}", x)
    if sh.is_dtensor(x) and last_index is not None:
        off, n = sh.shard_range(x.device_mesh, x.placements, 0, x.shape[0])
        x = sh.local_call(_rows_at, x, last_index[off:off + n])
    elif last_index is not None:
        x = _rows_at(x, last_index)
    x = rmsnorm_apply(params["final_norm"], x, eps=cfg.norm_eps,
                      zero_centered=cfg.zero_centered_norm)
    tap("final_hidden", x)
    logits = logits_from_hidden(params, x, cfg)
    tap("logits", logits)
    return logits, cache


def _rows_at(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Position ``index[i]`` of each row i of x (B, T, D): (B, D)."""
    return x[torch.arange(x.shape[0], device=x.device), index.long()]


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  dtype=None, *, per_slot: bool = True, device=None) -> dict:
    """KV cache stacked over layers like the params: per slot (every batch
    row keeps its own position occupancy, the serving cache; full attention
    only, since ragged rows break the ring's tail-keep invariant) or, with
    ``per_slot=False``, one shared occupancy (``init_cache``), a window
    layer's ``cache_len_for`` positions long."""
    dtype = dtype or getattr(torch, cfg.kv_cache_dtype)
    if per_slot and cfg.sliding_window:
        raise ValueError("per-slot KV caches require full attention")
    return {"stacks": {
        str(si): {f"p{pi}": init_cache(batch,
                                        cache_len_for(attn_spec_for(
                                            cfg, kind), max_len),
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
    logits (B, V), computed for that position alone (``last_index``: the
    (B, T, V) logits of a published vocabulary at T = 4096 would not fit
    the card; the head is row-wise, so the values are the same)."""
    b, t = tokens.shape
    last = torch.full((b,), t - 1, dtype=torch.int64, device=tokens.device)
    return forward(params, tokens, cfg, cache=cache, fill_cache=True,
                   last_index=last)


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


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy of f32 ``logits`` (B, T, V) against
    ``labels`` (B, T), labels < 0 masked (the JAX package's ``log_softmax``
    + ``take_along_axis``; each position's gradient lands in its own row,
    so the gather's backward adds nothing twice)."""
    mask = (labels >= 0).to(torch.float32)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.take_along_dim(
        logp, torch.clamp(labels.long(), min=0)[..., None], dim=-1)[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def train_loss(params: dict, batch: Dict[str, torch.Tensor],
               cfg: TransformerConfig) -> torch.Tensor:
    """Next-token cross entropy; labels < 0 are masked.

    With ``cfg.aux_loss_weight > 0`` the Switch-style load-balance loss of
    every MoE router is added, computed on the embedded inputs (the JAX
    package's proxy for per-layer activations) with each stack's first
    layer's router."""
    logits, _ = forward(params, batch["tokens"], cfg)
    loss = token_nll(logits, batch["labels"])
    if cfg.moe and cfg.aux_loss_weight > 0.0:
        spec = moe_spec_for(cfg)
        x = embed_tokens(params, batch["tokens"], cfg)
        aux, n = 0.0, 0
        for si, sspec in enumerate(layer_plan(cfg)):
            for pi, kind in enumerate(sspec.kinds):
                if kind.ffn != "moe":
                    continue
                lp = params["stacks"][str(si)][f"p{pi}"]["moe"]
                aux = aux + load_balance_loss(tree.index(lp, 0), x, spec)
                n += 1
        loss = loss + cfg.aux_loss_weight * aux / max(n, 1)
    return loss
