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
module: ``lax.scan`` is a Python loop over the history; ``dien_retrieval``
skips the one-user interest pass whose result the JAX function never
reads (XLA drops it under ``jit``) and looks the user's history up once,
then repeats its rows for each candidate (the same values as looking up
the repeated ids).  Tables are drawn with ``randn`` in f32 on the device.

Over a mesh (arguments laid out by ``launch.steps.shard_args`` under the
JAX package's rules) every entry point takes its params through
``sharding.at_use``: the tables stay sharded on their rows over ``(data,
model)`` (``table_rows``) and are read by the sharded lookup
(``layers.embedding.gather_rows``), the towers are replicated; the
activations are ``DTensor``s split by rows (the batch over ``data``, the
candidates over ``(data, model)``), and each constrain point is the JAX
module's.  The in-batch softmaxes (two-tower, MIND) gather every rank's
item vectors over the mesh dims that split the batch (``sharding.gather``,
whose transpose sums) and take their log-softmax over a ``candidates``
axis that may be split over ``model``; the losses' means are summed over
the batch's shards (``sharding.total``).  DIEN's GRU loops and MIND's
routing are per user and run on the rank's rows.  The towers' gradients
are summed over the ranks that computed other rows (``at_use``).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.core.quant import matmul_any
from repro_torch.core.stats import tap
from repro_torch.distributed import sharding as sh
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
    vecs = embed_lookup(params["field_embed"], sh.local_call(
        lambda f: f + offsets[None], field_ids))
    return vecs.reshape(field_ids.shape[0], -1)


def _hist_vecs(params, hist_ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, L) -> embeddings (B, L, d) bf16 + mask (B, L) f32.  The rows
    are looked up in bf16 (over a mesh half the bytes summed); the tap
    records them in the table's dtype, as the JAX package's does, looked
    up again only while a ``capture_taps`` block is open."""
    vecs = embed_lookup(params["item_embed"], hist_ids)
    tap("hist_embed", lambda: embed_lookup(
        params["item_embed"], hist_ids,
        compute_dtype=params["item_embed"]["table"].dtype))
    return vecs, (hist_ids != 0).to(torch.float32)


def _target_vecs(params, target_ids: torch.Tensor) -> torch.Tensor:
    return embed_lookup(params["item_embed"], target_ids)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """``torch.mean(x)``; of a ``DTensor`` split by rows, its shards' sums
    summed (``sharding.total``) over its global count."""
    if sh.is_dtensor(x):
        return sh.total(x, tag="loss-sum") / x.numel()
    return torch.mean(x)


def _bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    labels = labels.to(torch.float32)
    return _mean(torch.clamp(logits, min=0) - logits * labels
                 + torch.log1p(torch.exp(-logits.abs())))


def _in_batch_softmax_loss(logits: torch.Tensor) -> torch.Tensor:
    """Each row's own column is its positive: -mean(log_softmax diag)."""
    if sh.is_dtensor(logits):
        return _sharded_in_batch_loss(logits)
    return -torch.mean(torch.log_softmax(logits, dim=-1).diagonal())


def _sharded_in_batch_loss(logits) -> torch.Tensor:
    """``_in_batch_softmax_loss`` of (B, B) logits split by rows and, over
    some mesh dims, by candidates (columns), on the local shards: the row
    max max-reduced over the column-split dims (no cotangent, as JAX stops
    the max's), the sum of exponentials summed there, each row's own
    column taken on the rank that holds it, the rows' sum summed over the
    row-split dims.  The logits are never gathered."""
    from torch.distributed.tensor import Shard
    mesh, pl = logits.device_mesh, logits.placements
    rows = [mesh.get_group(i) for i, p in enumerate(pl) if p == Shard(0)]
    cols = [mesh.get_group(i) for i, p in enumerate(pl) if p == Shard(1)]
    r_off, _ = sh.shard_range(mesh, pl, 0, logits.shape[0])
    c_off, c_n = sh.shard_range(mesh, pl, 1, logits.shape[1])
    local = logits.to_local().to(torch.float32)
    top = local.detach().amax(dim=-1, keepdim=True)
    for g in cols:
        sh.all_reduce(top, g, "max", tag="softmax-max")
    shifted = local - top
    lse = torch.log(sh.psum(torch.sum(torch.exp(shifted), dim=-1), cols,
                            tag="softmax-sum"))
    own = torch.arange(local.shape[0], device=local.device) + r_off - c_off
    mine = (own >= 0) & (own < c_n)
    picked = torch.take_along_dim(shifted, torch.clamp(own, 0, c_n - 1)[
        :, None], dim=-1)[:, 0]
    picked = sh.psum(torch.where(mine, picked, torch.zeros_like(picked)),
                     cols, tag="softmax-sum")
    return sh.psum(torch.sum(lse - picked), rows,
                   tag="loss-sum") / logits.shape[0]


def _rows_einsum(eq: str, *ops) -> torch.Tensor:
    """``torch.einsum`` of operands whose first index is the batch row,
    row by row: over a mesh on the rank's rows (``local_call``; DTensor's
    own einsum reshapes a row dim split over a mesh dim of one rank into
    layouts it then refuses)."""
    return sh.local_call(lambda *a: torch.einsum(eq, *a), *ops)


def _in_batch(fn, users, items):
    """``fn(users, items)``: the (B, ..., B) scores of every user against
    every item of the batch.  Over a mesh each rank scores its users'
    rows against the items of all ranks (gathered over the mesh dims that
    split them, innermost first; the transpose sums each item's cotangent
    over the ranks that scored it), the result laid out as ``users``."""
    if not sh.is_dtensor(users):
        return fn(users, items)
    from torch.distributed.tensor import DTensor, Shard
    mesh = items.device_mesh
    every = items.to_local()
    for i in reversed(range(mesh.ndim)):
        p = items.placements[i]
        if p == Shard(0):
            every = sh.gather(every, 0, mesh.get_group(i),
                              tag="in-batch-gather")
        elif isinstance(p, Shard):
            raise ValueError(f"in-batch scores: items {p} on mesh dim "
                             f"{mesh.mesh_dim_names[i]}")
    return DTensor.from_local(fn(users.to_local(), every), mesh,
                              users.placements, run_check=False)


def _per_candidate(t, cands):
    """``t`` (1, ...), the one user's, repeated for each candidate of
    ``cands`` (N, ...); over a mesh the rank's candidates' rows, laid out
    as ``cands`` (``t`` replicated: its cotangent summed over the ranks
    whose candidates used it)."""
    if not sh.is_dtensor(cands):
        return t.expand(cands.shape[0], *t.shape[1:])
    from torch.distributed.tensor import DTensor
    one = _one_user(t, cands)
    return DTensor.from_local(
        one.expand(cands.to_local().shape[0], *one.shape[1:]),
        cands.device_mesh, cands.placements, run_check=False)


def _against(fn, user, cands):
    """``fn(user, cands)``: the one user's scores (N,) against candidates
    (N, ...); over a mesh on the rank's candidates, laid out as them."""
    if not sh.is_dtensor(cands):
        return fn(user, cands)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(fn(_one_user(user, cands), cands.to_local()),
                              cands.device_mesh, cands.placements,
                              run_check=False)


def _one_user(t, cands) -> torch.Tensor:
    """The one user's ``t`` whole on the rank (it must be replicated: a
    split on a mesh dim of one rank is), entering work on the rank's
    candidates: its cotangent summed over the mesh dims that split them."""
    if sh.is_dtensor(t) and any(
            p.is_shard() and t.device_mesh.size(i) > 1
            for i, p in enumerate(t.placements)):
        raise ValueError(f"a user's row {t.placements} against candidates "
                         f"{cands.placements}: the user must be replicated")
    return sh.fan(sh.local_shard(t), sh.split_groups(cands), tag="user-fan")


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
    logits = _in_batch(lambda a, b: (a.to(torch.float32) @ b.to(
        torch.float32).T) / temperature, u, v)
    logits = constrain(logits, ("batch", "candidates"))
    return _in_batch_softmax_loss(logits)


def two_tower_retrieval(params, batch, cfg) -> torch.Tensor:
    """One user against candidate_ids (N,): one batched product."""
    u = _two_tower_user(params, batch, cfg)                    # (1, d_out)
    cands = _two_tower_item(params, batch["candidate_ids"])    # (N, d_out)
    cands = constrain(cands, ("candidates", None))
    return _against(lambda a, c: (a.to(torch.float32)
                                  @ c.to(torch.float32).T)[0], u, cands)


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
    return _rows_einsum("bl,bld->bd", w.to(hist.dtype), hist)


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
    pooled = _din_attention(params, _per_candidate(hist, cands),
                            _per_candidate(mask, cands), cands)
    fields = _field_vecs(params, batch["field_ids"], cfg)
    x = torch.cat([pooled, cands, _per_candidate(fields, cands)], dim=-1)
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


def _zero_state(hist, g: int) -> torch.Tensor:
    """A zero GRU state (B, g) in hist's dtype, laid out as its rows."""
    return sh.local_call(lambda t: t.new_zeros((t.shape[0], g)), hist)


def _dien_interest(params, hist, mask, cfg) -> torch.Tensor:
    """First GRU pass over history -> interest states (B, L, g) bf16; a
    padded step keeps the state."""
    h = _zero_state(hist, cfg.gru_dim)
    states = []
    for t in range(hist.shape[1]):
        h_new = _gru_cell(params["gru"], h, hist[:, t])
        h = torch.where(mask[:, t, None] > 0, h_new, h)
        states.append(h)
    return torch.stack(states, dim=1)


def dien_score(params, batch, cfg) -> torch.Tensor:
    hist, mask = _hist_vecs(params, batch["hist_ids"])
    return _dien_scores(params, hist, mask,
                        _target_vecs(params, batch["target_ids"]),
                        _field_vecs(params, batch["field_ids"], cfg), cfg)


def _dien_scores(params, hist, mask, target, fields, cfg) -> torch.Tensor:
    """DIEN's scores from looked-up rows: both GRU passes, the target's
    attention on the interest states, the score MLP."""
    interests = _dien_interest(params, hist, mask, cfg)  # (B, L, g)
    # attention of the target on the interest states: the target padded
    # with zeros (or cut) to gru_dim, no projection
    g, d = cfg.gru_dim, cfg.embed_dim
    tproj = sh.local_call(lambda t: torch.nn.functional.pad(
        t, (0, max(0, g - d)))[:, :g], target)
    att = _rows_einsum("blg,bg->bl", interests.to(torch.float32),
                       tproj.to(torch.float32))
    att = torch.softmax(att + (mask - 1.0) * 1e9, dim=-1) * mask
    h = _zero_state(hist, g)
    for t in range(hist.shape[1]):
        h_new = _gru_cell(params["augru"], h, interests[:, t], att=att[:, t])
        h = torch.where(mask[:, t, None] > 0, h_new, h)
    x = torch.cat([h, target, fields], dim=-1)
    return mlp_stack_apply(params["score"]["score_mlp"], x)[..., 0]


def dien_train_loss(params, batch, cfg) -> torch.Tensor:
    return _bce_loss(dien_score(params, batch, cfg), batch["labels"])


def dien_retrieval(params, batch, cfg) -> torch.Tensor:
    """One user vs N candidates: ``dien_score`` over N broadcast copies of
    the user, both GRU passes included, as the JAX function computes it
    (the user's rows looked up once and repeated)."""
    ids = constrain(batch["candidate_ids"], ("candidates",))
    hist, mask = _hist_vecs(params, batch["hist_ids"])          # (1, L, d)
    target = _target_vecs(params, ids)                          # (N, d)
    fields = _field_vecs(params, batch["field_ids"], cfg)
    return _dien_scores(params, _per_candidate(hist, target),
                        _per_candidate(mask, target), target,
                        _per_candidate(fields, target), cfg)


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

    def routing(h):
        dev = h.device
        b = torch.sin(torch.arange(l_, dtype=torch.float32, device=dev)[
            None, :, None] * (1.0 + torch.arange(k_, dtype=torch.float32,
                                                 device=dev)[None, None, :]))
        return b.expand(h.shape[0], l_, k_)
    b = sh.local_call(routing, hist)
    caps = None
    for _ in range(cfg.capsule_iters):
        w = torch.softmax(b, dim=-1) * mask[..., None]     # (B, L, K)
        caps = _squash(_rows_einsum("blk,bld->bkd", w, low))
        b = b + _rows_einsum("bkd,bld->blk", caps, low)
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
    return _rows_einsum("bkd,bd->bk", caps, target).amax(-1)


def mind_train_loss(params, batch, cfg) -> torch.Tensor:
    """Sampled softmax with in-batch negatives, label-aware interest pick."""
    caps, _ = mind_interests(params, batch, cfg)
    targets = _target_vecs(params, batch["target_ids"]).to(torch.float32)
    best = _in_batch(lambda c, t: torch.einsum("bkd,nd->bkn", c, t).amax(1),
                     caps, targets)                               # (B, B)
    best = constrain(best, ("batch", "candidates"))
    return _in_batch_softmax_loss(best)


def mind_retrieval(params, batch, cfg) -> torch.Tensor:
    caps, _ = mind_interests(params, batch, cfg)           # (1, K, d)
    cands = _target_vecs(params, batch["candidate_ids"]).to(torch.float32)
    cands = constrain(cands, ("candidates", None))
    return _against(lambda c, x: torch.einsum("kd,nd->kn", c[0], x).amax(0),
                    caps, cands)


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
    return SCORE[cfg.family](sh.at_use_tree(params), batch, cfg)


def train_loss(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    """The architecture's training loss (``TRAIN_LOSS``)."""
    return TRAIN_LOSS[cfg.family](sh.at_use_tree(params), batch, cfg)


def retrieval_scores(params, batch, cfg: RecsysConfig) -> torch.Tensor:
    return RETRIEVAL[cfg.family](sh.at_use_tree(params), batch, cfg)


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
