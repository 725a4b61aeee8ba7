"""Classical recommender architectures: two-tower, MIND, DIN, DIEN, the JAX
package's ``repro/models/recsys.py`` in PyTorch.

These are the paper's contrast class: huge sparse embedding tables and
small dense nets.  Under the paper's policy only their dense MLP towers are
quantized (per-channel fp8 through ``core.quant.matmul_any``, so kernel
``fp8_gemm`` on the card); the embedding path (``index_select`` gathers of
f32 rows, cast to bf16) stays high-precision, as do DIN's attention MLP,
DIEN's GRU / AUGRU and MIND's capsule bilinear.

All four families share one input contract:
  batch = {
    "hist_ids":   (B, L) int32   -- behavior history, 0 = padding
    "target_ids": (B,)   int32   -- candidate item
    "field_ids":  (B, n_fields)  -- user categorical profile
    "labels":     (B,)   float32 -- click label (train)
  }
Scoring entry points:
  * ``score(params, batch, cfg)``            -- pointwise CTR / similarity
  * ``retrieval_scores(params, batch, cfg)`` -- one user vs N candidates
    (``batch["candidate_ids"]`` (N,)); ``retrieval_scores_chunked`` feeds
    the candidates through it C at a time
  * ``train_loss(params, batch, cfg)``       -- the training loss
    (differentiable: ``launch/steps.py``'s train bundles take its
    gradient through ``tree.value_and_grad``)

Activations are tapped at the JAX module's points (``core.stats.tap``:
``hist_embed``, ``din_pooled``, ``din_logit``).  Differences from the JAX
module: ``constrain`` lays out only DTensors, which no caller passes
until N9e (row-sharded tables); ``lax.scan`` is a
Python loop over the history; ``dien_retrieval`` skips the one-user
interest pass whose result the JAX function never reads (XLA drops it
under ``jit``).  Tables are drawn with ``randn`` in f32 on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.quant import matmul_any
from repro_torch.core.stats import tap
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.common import (dense_init, mlp_stack_apply,
                                       mlp_stack_init, split,
                                       truncated_normal)
from repro_torch.layers.embedding import embed_lookup


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _init_tables(gen: torch.Generator, cfg: RecsysConfig, dtype,
                 device) -> dict:
    # unit-std tables, as the JAX package draws them (the Fig.-1 contrast)
    def table(rows):
        return torch.randn((rows, cfg.embed_dim), generator=split(gen),
                           dtype=dtype, device=device)
    return {"item_embed": {"table": table(cfg.n_items)},
            "field_embed": {"table": table(cfg.n_sparse_fields
                                           * cfg.field_vocab)}}


def _field_vecs(params, field_ids: torch.Tensor,
                cfg: RecsysConfig) -> torch.Tensor:
    """(B, n_fields) -> (B, n_fields * d) bf16: one fused table with a row
    offset per field."""
    offsets = torch.arange(cfg.n_sparse_fields, dtype=field_ids.dtype,
                           device=field_ids.device) * cfg.field_vocab
    vecs = embed_lookup(params["field_embed"], field_ids + offsets[None])
    return vecs.reshape(field_ids.shape[0], -1)


def _hist_vecs(params, hist_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) -> embeddings (B, L, d) bf16 + mask (B, L) f32."""
    table = params["item_embed"]["table"]
    vecs = embed_lookup(params["item_embed"], hist_ids,
                        compute_dtype=table.dtype)
    tap("hist_embed", vecs)
    return vecs.to(torch.bfloat16), (hist_ids != 0).to(torch.float32)


def _target_vecs(params, target_ids: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["item_embed"], target_ids)


def _bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-logits.abs())))


def _in_batch_softmax_loss(logits: torch.Tensor) -> torch.Tensor:
    """Each row's own column is its positive: -mean(log_softmax diag)."""
    return -torch.mean(torch.log_softmax(logits, dim=-1).diagonal())


def _unit(v: torch.Tensor) -> torch.Tensor:
    """v / (||v|| + 1e-6), the norm in f32 cast to v's dtype."""
    norm = torch.linalg.vector_norm(v.to(torch.float32), dim=-1,
                                    keepdim=True)
    return v / (norm.to(v.dtype) + 1e-6)


# ---------------------------------------------------------------------------
# Two-tower retrieval  [Yi et al., RecSys'19]
# ---------------------------------------------------------------------------


def init_two_tower(gen, cfg: RecsysConfig, dtype=torch.float32,
                   device=None) -> dict:
    params = _init_tables(split(gen), cfg, dtype, device)
    d = cfg.embed_dim
    user_in = d + cfg.n_sparse_fields * d          # pooled history + fields
    params["user_tower"] = {"tower": mlp_stack_init(
        split(gen), (user_in, *cfg.tower_mlp), dtype=dtype, device=device)}
    params["item_tower"] = {"tower": mlp_stack_init(
        split(gen), (d, *cfg.tower_mlp), dtype=dtype, device=device)}
    return params


def _two_tower_user(params, batch, cfg) -> torch.Tensor:
    hist, mask = _hist_vecs(params, batch["hist_ids"])
    pooled = (torch.sum(hist * mask[..., None].to(hist.dtype), dim=1)
              / torch.clamp(mask.sum(1), min=1.0)[:, None].to(hist.dtype))
    u_in = torch.cat(
        [pooled, _field_vecs(params, batch["field_ids"], cfg)], dim=-1)
    return _unit(mlp_stack_apply(params["user_tower"]["tower"], u_in))


def _two_tower_item(params, item_ids) -> torch.Tensor:
    return _unit(mlp_stack_apply(params["item_tower"]["tower"],
                                 _target_vecs(params, item_ids)))


def two_tower_score(params, batch, cfg) -> torch.Tensor:
    u = _two_tower_user(params, batch, cfg)
    v = _two_tower_item(params, batch["target_ids"])
    return torch.sum(u.to(torch.float32) * v.to(torch.float32), dim=-1)


def two_tower_train_loss(params, batch, cfg,
                         temperature: float = 0.05) -> torch.Tensor:
    """In-batch sampled softmax (each row's target = positive)."""
    u = _two_tower_user(params, batch, cfg)
    v = _two_tower_item(params, batch["target_ids"])
    logits = (u.to(torch.float32) @ v.to(torch.float32).T) / temperature
    logits = constrain(logits, ("batch", "candidates"))
    return _in_batch_softmax_loss(logits)


def two_tower_retrieval(params, batch, cfg) -> torch.Tensor:
    """One user against candidate_ids (N,): one batched product."""
    u = _two_tower_user(params, batch, cfg)                    # (1, d_out)
    cands = _two_tower_item(params, batch["candidate_ids"])    # (N, d_out)
    cands = constrain(cands, ("candidates", None))
    return (u.to(torch.float32) @ cands.to(torch.float32).T)[0]


# ---------------------------------------------------------------------------
# DIN: target attention over behavior history  [arXiv:1706.06978]
# ---------------------------------------------------------------------------


def init_din(gen, cfg: RecsysConfig, dtype=torch.float32,
             device=None) -> dict:
    ka, km, kt = split(gen), split(gen), split(gen)
    params = _init_tables(kt, cfg, dtype, device)
    d = cfg.embed_dim
    params["attn"] = {"attn_mlp": mlp_stack_init(
        ka, (4 * d, *cfg.attn_mlp, 1), dtype=dtype, device=device)}
    score_in = d + d + cfg.n_sparse_fields * d   # pooled + target + fields
    params["score"] = {"score_mlp": mlp_stack_init(
        km, (score_in, *cfg.mlp, 1), dtype=dtype, device=device)}
    return params


def _din_attention(params, hist, mask, target) -> torch.Tensor:
    """DIN local activation unit -> weighted-sum pooled history (B, d)."""
    t = target[:, None, :].expand(hist.shape)
    feats = torch.cat([hist, t, hist * t, hist - t], dim=-1)
    w = mlp_stack_apply(params["attn"]["attn_mlp"], feats)[..., 0]
    w = w.to(torch.float32) + (mask - 1.0) * 1e9
    w = torch.softmax(w, dim=-1) * mask
    return torch.einsum("bl,bld->bd", w.to(hist.dtype), hist)


def din_score(params, batch, cfg) -> torch.Tensor:
    hist, mask = _hist_vecs(params, batch["hist_ids"])
    target = _target_vecs(params, batch["target_ids"])
    pooled = _din_attention(params, hist, mask, target)
    tap("din_pooled", pooled)
    x = torch.cat([pooled, target,
                   _field_vecs(params, batch["field_ids"], cfg)], dim=-1)
    out = mlp_stack_apply(params["score"]["score_mlp"], x)[..., 0]
    tap("din_logit", out)
    return out


def din_train_loss(params, batch, cfg) -> torch.Tensor:
    return _bce_loss(din_score(params, batch, cfg), batch["labels"])


def din_retrieval(params, batch, cfg) -> torch.Tensor:
    """One user vs N candidates: target attention over the user's history
    broadcast to every candidate (no loop)."""
    hist, mask = _hist_vecs(params, batch["hist_ids"])          # (1, L, d)
    cands = _target_vecs(params, batch["candidate_ids"])        # (N, d)
    cands = constrain(cands, ("candidates", None))
    n = cands.shape[0]
    pooled = _din_attention(params, hist.expand(n, *hist.shape[1:]),
                            mask.expand(n, mask.shape[1]), cands)
    fields = _field_vecs(params, batch["field_ids"], cfg)
    x = torch.cat([pooled, cands, fields.expand(n, fields.shape[-1])],
                  dim=-1)
    return mlp_stack_apply(params["score"]["score_mlp"], x)[..., 0]


# ---------------------------------------------------------------------------
# DIEN: GRU interest extraction + AUGRU interest evolution [arXiv:1809.03672]
# ---------------------------------------------------------------------------


def _gru_init(gen, d_in, d_h, dtype, device):
    return {
        "wx": {"kernel": truncated_normal((d_in, 3 * d_h),
                                          1.0 / math.sqrt(d_in), split(gen),
                                          device, dtype)},
        "wh": {"kernel": truncated_normal((d_h, 3 * d_h),
                                          1.0 / math.sqrt(d_h), split(gen),
                                          device, dtype)},
        "bias": torch.zeros((3 * d_h,), dtype=dtype, device=device),
    }


def _gru_cell(p, h, x, att=None):
    """GRU / AUGRU cell (CuDNN variant; AUGRU: update gate scaled by
    ``att``): r = s(x Wr + h Ur); u = s(x Wu + h Uu);
    c = tanh(x Wc + r * (h Uc)); h' = (1 - u) h + u c, in f32, rounded to
    h's dtype."""
    xg = matmul_any(x, p["wx"]["kernel"], out_dtype=torch.float32) \
        + p["bias"].to(torch.float32)
    hg = matmul_any(h, p["wh"]["kernel"], out_dtype=torch.float32)
    xr, xu, xc = xg.chunk(3, dim=-1)
    hr, hu, hc = hg.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    u = torch.sigmoid(xu + hu)
    c = torch.tanh(xc + r * hc)
    if att is not None:
        u = u * att[..., None]
    h_new = (1.0 - u) * h.to(torch.float32) + u * c
    return h_new.to(h.dtype)


def init_dien(gen, cfg: RecsysConfig, dtype=torch.float32,
              device=None) -> dict:
    kt, k1, k2, km = split(gen), split(gen), split(gen), split(gen)
    params = _init_tables(kt, cfg, dtype, device)
    d, g = cfg.embed_dim, cfg.gru_dim
    params["gru"] = _gru_init(k1, d, g, dtype, device)
    params["augru"] = _gru_init(k2, g, g, dtype, device)
    score_in = g + d + cfg.n_sparse_fields * d
    params["score"] = {"score_mlp": mlp_stack_init(
        km, (score_in, *cfg.mlp, 1), dtype=dtype, device=device)}
    return params


def _dien_interest(params, hist, mask, cfg) -> torch.Tensor:
    """First GRU pass over history -> interest states (B, L, g) bf16; a
    padded step keeps the state."""
    h = hist.new_zeros((hist.shape[0], cfg.gru_dim))
    states = []
    for t in range(hist.shape[1]):
        h_new = _gru_cell(params["gru"], h, hist[:, t])
        h = torch.where(mask[:, t, None] > 0, h_new, h)
        states.append(h)
    return torch.stack(states, dim=1)


def dien_score(params, batch, cfg) -> torch.Tensor:
    hist, mask = _hist_vecs(params, batch["hist_ids"])
    target = _target_vecs(params, batch["target_ids"])
    interests = _dien_interest(params, hist, mask, cfg)  # (B, L, g)
    # attention of the target on the interest states: the target padded
    # with zeros (or cut) to gru_dim, no projection
    g, d = cfg.gru_dim, cfg.embed_dim
    tproj = torch.nn.functional.pad(target, (0, max(0, g - d)))[:, :g]
    att = torch.einsum("blg,bg->bl", interests.to(torch.float32),
                       tproj.to(torch.float32))
    att = torch.softmax(att + (mask - 1.0) * 1e9, dim=-1) * mask
    h = hist.new_zeros((hist.shape[0], g))
    for t in range(hist.shape[1]):
        h_new = _gru_cell(params["augru"], h, interests[:, t], att=att[:, t])
        h = torch.where(mask[:, t, None] > 0, h_new, h)
    x = torch.cat([h, target, _field_vecs(params, batch["field_ids"], cfg)],
                  dim=-1)
    return mlp_stack_apply(params["score"]["score_mlp"], x)[..., 0]


def dien_train_loss(params, batch, cfg) -> torch.Tensor:
    return _bce_loss(dien_score(params, batch, cfg), batch["labels"])


def dien_retrieval(params, batch, cfg) -> torch.Tensor:
    """One user vs N candidates: ``dien_score`` over N broadcast copies of
    the user, both GRU passes included, as the JAX function computes it."""
    n = batch["candidate_ids"].shape[0]
    batch_n = {
        "hist_ids": batch["hist_ids"].expand(n, batch["hist_ids"].shape[1]),
        "target_ids": constrain(batch["candidate_ids"], ("candidates",)),
        "field_ids": batch["field_ids"].expand(n,
                                               batch["field_ids"].shape[1]),
    }
    return dien_score(params, batch_n, cfg)


# ---------------------------------------------------------------------------
# MIND: multi-interest capsule routing  [arXiv:1904.08030]
# ---------------------------------------------------------------------------


def init_mind(gen, cfg: RecsysConfig, dtype=torch.float32,
              device=None) -> dict:
    kt, kb, km = split(gen), split(gen), split(gen)
    params = _init_tables(kt, cfg, dtype, device)
    d = cfg.embed_dim
    params["capsule"] = {"bilinear": dense_init(kb, d, d, dtype=dtype,
                                                device=device)}
    user_in = d + cfg.n_sparse_fields * d
    params["proj"] = {"tower": mlp_stack_init(km, (user_in, d), dtype=dtype,
                                              device=device)}
    return params


def _squash(v: torch.Tensor) -> torch.Tensor:
    n2 = torch.sum(torch.square(v), dim=-1, keepdim=True)
    return (n2 / (1.0 + n2)) * v / torch.sqrt(n2 + 1e-9)


def mind_interests(params, batch, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic (B2I) routing -> K interest capsules (B, K, d) f32."""
    hist, mask = _hist_vecs(params, batch["hist_ids"])
    b_, l_, _ = hist.shape
    k_ = cfg.n_interests
    low = matmul_any(hist, params["capsule"]["bilinear"]["kernel"],
                     out_dtype=torch.float32)              # (B, L, d)
    # fixed routing logits (the paper draws them at random and freezes them)
    dev = hist.device
    b = torch.sin(torch.arange(l_, dtype=torch.float32, device=dev)[
        None, :, None] * (1.0 + torch.arange(k_, dtype=torch.float32,
                                             device=dev)[None, None, :]))
    b = b.expand(b_, l_, k_)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * mask[..., None]     # (B, L, K)
        caps = _squash(torch.einsum("blk,bld->bkd", w, low))
        b = b + torch.einsum("bkd,bld->blk", caps, low)
    fields = _field_vecs(params, batch["field_ids"], cfg).to(torch.float32)
    proj_in = torch.cat([caps, fields[:, None, :].expand(
        b_, k_, fields.shape[-1])], dim=-1).to(torch.bfloat16)
    caps = caps + mlp_stack_apply(params["proj"]["tower"], proj_in).to(
        torch.float32)
    return caps, mask


def mind_score(params, batch, cfg) -> torch.Tensor:
    """Label-aware max over interests."""
    caps, _ = mind_interests(params, batch, cfg)
    target = _target_vecs(params, batch["target_ids"]).to(torch.float32)
    return torch.einsum("bkd,bd->bk", caps, target).amax(-1)


def mind_train_loss(params, batch, cfg) -> torch.Tensor:
    """Sampled softmax with in-batch negatives, label-aware interest pick."""
    caps, _ = mind_interests(params, batch, cfg)
    targets = _target_vecs(params, batch["target_ids"]).to(torch.float32)
    best = torch.einsum("bkd,nd->bkn", caps, targets).amax(1)     # (B, B)
    best = constrain(best, ("batch", "candidates"))
    return _in_batch_softmax_loss(best)


def mind_retrieval(params, batch, cfg) -> torch.Tensor:
    caps, _ = mind_interests(params, batch, cfg)           # (1, K, d)
    cands = _target_vecs(params, batch["candidate_ids"]).to(torch.float32)
    cands = constrain(cands, ("candidates", None))
    return torch.einsum("kd,nd->kn", caps[0], cands).amax(0)


# ---------------------------------------------------------------------------
# Family dispatch
# ---------------------------------------------------------------------------

INIT = {"two_tower": init_two_tower, "mind": init_mind,
        "din": init_din, "dien": init_dien}
SCORE = {"two_tower": two_tower_score, "mind": mind_score,
         "din": din_score, "dien": dien_score}
TRAIN_LOSS = {"two_tower": two_tower_train_loss, "mind": mind_train_loss,
              "din": din_train_loss, "dien": dien_train_loss}
RETRIEVAL = {"two_tower": two_tower_retrieval, "mind": mind_retrieval,
             "din": din_retrieval, "dien": dien_retrieval}


def init_recsys(gen: torch.Generator, cfg: RecsysConfig,
                dtype=torch.float32, device=None) -> Dict:
    """Random params of ``dtype`` on ``device`` from ``gen``: the JAX
    package's tree (paths, shapes, distributions), other random numbers."""
    return INIT[cfg.family](gen, cfg, dtype, device)


def score(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    return SCORE[cfg.family](params, batch, cfg)


def train_loss(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """The architecture's training loss (``TRAIN_LOSS``)."""
    return TRAIN_LOSS[cfg.family](params, batch, cfg)


def retrieval_scores(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    return RETRIEVAL[cfg.family](params, batch, cfg)


def retrieval_scores_chunked(params, batch, cfg: RecsysConfig,
                             chunk: int) -> torch.Tensor:
    """``retrieval_scores`` over ``batch["candidate_ids"]`` fed ``chunk``
    candidates a call, concatenated: the same scores (every family scores
    each candidate independently of the others), with the working set of
    ``chunk`` candidates instead of all N."""
    ids = batch["candidate_ids"]
    return torch.cat([retrieval_scores(params, dict(
        batch, candidate_ids=ids[i:i + chunk]), cfg)
        for i in range(0, ids.shape[0], chunk)])
