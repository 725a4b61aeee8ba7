"""OneRec-V2-style generative recommender (the paper's §5.1 model): a
fat-MoE decoder over a semantic-ID vocabulary with a profile-feature prefix
token.  The serving entry points of ``repro/models/onerec.py``: ragged
prefill into per-slot rows, resume prefill of a suffix over a cached
prefix, and single-token and tree decode over the paged pool or the
contiguous slot pool; and its generation entry points over the
batch-shared cache (``init_cache``, ``prefill``, ``decode_step``,
``generate_items``, ``beam_generate``).

Under a mesh, with params laid out on it (``launch.steps.shard_args``) and
a batch of ``DTensor``s, ``prefill``, ``decode_step`` and
``generate_items`` run tensor and expert parallel (``models.transformer``);
``generate_items`` lays its cache out over ``kv_seq`` and picks each
token from the vocabulary-sharded logits gathered whole on every rank.
The slot and paged entry points and ``beam_generate`` stay single-rank.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs.base import OneRecConfig
from repro_torch.core.quant import matmul_any
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.layers.attention import KVWrite
from repro_torch.layers.common import dense_init
from repro_torch.models import transformer as tfm

PROFILE_DIM = 64  # stub modality frontend: precomputed profile features


def init_onerec(seed: int, cfg: OneRecConfig, *, device=None,
                transform: Optional[Callable[[str, dict], dict]] = None
                ) -> dict:
    """Random f32 params made on ``device`` (the card unless ``"cpu"``; a
    template without values on ``"meta"``) from a ``torch.Generator``
    seeded with ``seed``.  ``transform(path, subtree)`` (PTQ: ``lambda p,
    t: ptq.quantize_params(t, policy, prefix=p)``) is applied to each
    backbone layer as it is made and to the other leaves, with their
    paths in the whole tree, so a full-width model never holds more than
    one raw layer."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    transform = transform or (lambda _, t: t)
    backbone = tfm.init_transformer(
        gen, cfg.transformer, device=dev,
        transform=lambda p, t: transform(f"backbone/{p}" if p
                                         else "backbone", t))
    return {
        "backbone": backbone,
        "profile_proj": transform("profile_proj", dense_init(
            gen, PROFILE_DIM, cfg.transformer.d_model, device=dev)),
    }


def _embed_with_profile(params, tokens, profile, cfg: OneRecConfig,
                        compute_dtype=torch.bfloat16):
    """[profile token] + semantic-ID token embeddings."""
    tok_emb = tfm.embed_tokens(params["backbone"], tokens, cfg.transformer,
                               compute_dtype)
    prof = matmul_any(profile.to(compute_dtype),
                      params["profile_proj"]["kernel"])
    return torch.cat([prof[:, None, :], tok_emb], dim=1)


def forward(params, batch: Dict[str, torch.Tensor],
            cfg: OneRecConfig) -> torch.Tensor:
    """Uncached forward: tokens (B, T) and profile (B, PROFILE_DIM) ->
    logits (B, T + 1, V) over [profile] + tokens."""
    embeds = _embed_with_profile(params, batch["tokens"], batch["profile"],
                                 cfg)
    logits, _ = tfm.forward(params["backbone"], batch["tokens"],
                            cfg.transformer, inputs_embeds=embeds)
    return logits


def train_loss(params, batch: Dict[str, torch.Tensor],
               cfg: OneRecConfig) -> torch.Tensor:
    """Next-token CE over the target item's semantic-ID tokens: ``labels``
    (B, T + 1) aligned with [profile, tokens...], history positions masked
    (-1), so only the final ``decode_len`` target tokens count."""
    return tfm.token_nll(forward(params, batch, cfg), batch["labels"])


def init_cache(cfg: OneRecConfig, batch: int, dtype=None, *,
               device=None) -> dict:
    """Generation KV cache: ``batch`` rows of ``context_len + 1`` positions
    sharing one position occupancy (every row at the same depth).
    ``dtype=None`` resolves ``cfg.transformer.kv_cache_dtype``."""
    return tfm.init_kv_cache(cfg.transformer, batch, cfg.context_len + 1,
                             dtype, per_slot=False, device=device)


def init_slot_cache(cfg: OneRecConfig, n_slots: int, dtype=None,
                    extra_len: int = 0, *, device=None) -> dict:
    """Slot-pool KV cache: ``n_slots`` independent per-request rows of
    ``context_len + 1 + extra_len`` positions, each with its own position
    occupancy.  ``extra_len`` reserves the branch spans of tree decode
    (``(max_candidates - 1) * (decode_len - 1)``).  ``dtype=None`` resolves
    ``cfg.transformer.kv_cache_dtype``; an fp8 dtype adds per-(position,
    head) scale leaves."""
    return tfm.init_kv_cache(cfg.transformer, n_slots,
                             cfg.context_len + 1 + extra_len, dtype,
                             device=device)


def init_page_pool(cfg: OneRecConfig, n_pages: int, page_size: int,
                   dtype=None, *, device=None) -> dict:
    """Paged serving cache: one flat pool of ``n_pages`` x ``page_size``
    positions (plus a sentinel page) shared by every request."""
    return tfm.init_kv_page_pool(cfg.transformer, n_pages, page_size, dtype,
                                 device=device)


def prefill_into_slots(params, batch: Dict[str, torch.Tensor],
                       cfg: OneRecConfig, cache: dict,
                       lengths: torch.Tensor, *,
                       starts: Optional[torch.Tensor] = None,
                       kv_write: Optional[KVWrite] = None,
                       page_gather: Optional[torch.Tensor] = None):
    """Ragged prefill into a per-slot cache.  ``batch["tokens"]`` (B, T) is
    right-padded, ``lengths`` (B,) the true history-token counts; row i
    occupies positions 0 .. lengths[i] ([profile] + tokens).  Returns each
    row's own last-position logits (B, V) and the filled cache.

    With ``starts`` (B,) this is the RESUME prefill: ``batch["tokens"]``
    holds each row's history SUFFIX (``lengths`` counts suffix tokens),
    token j at absolute position ``starts[i] + j``, over a cache whose row
    already holds the profile token and the prefix (positions 0 ..
    starts[i] - 1); no profile embedding is added.  The writes land at
    ``kv_write``; ``page_gather`` reads the paged pool's rows."""
    if starts is None:
        seq_lens = lengths.to(torch.int32) + 1    # + profile prefix token
        embeds = _embed_with_profile(params, batch["tokens"],
                                     batch["profile"], cfg)
    else:
        seq_lens = lengths.to(torch.int32)        # suffix tokens only
        embeds = tfm.embed_tokens(params["backbone"], batch["tokens"],
                                  cfg.transformer)
    return tfm.forward(params["backbone"], batch["tokens"], cfg.transformer,
                       inputs_embeds=embeds, cache=cache, fill_cache=True,
                       lengths=seq_lens, starts=starts, kv_write=kv_write,
                       page_gather=page_gather, last_index=seq_lens - 1)


def decode_step_slots(params, tokens: torch.Tensor, cfg: OneRecConfig,
                      cache: dict, lengths: torch.Tensor, *,
                      kv_write: KVWrite,
                      starts: Optional[torch.Tensor] = None,
                      branch_stride: Optional[int] = None,
                      page_tables: Optional[torch.Tensor] = None,
                      page_gather: Optional[torch.Tensor] = None,
                      page_size: int = 0):
    """Per-slot decode: tokens (B, 1), row i at its own absolute index
    ``lengths[i]``; K/V written at ``kv_write``.  With ``page_tables`` the
    cache is the paged pool and attention runs kernel ``paged_decode``;
    with ``page_gather`` instead, the paged pool read through the gathered
    view (the unfused paged decode); with neither, the cache is the
    contiguous slot pool (``init_slot_cache``) and attention runs kernel
    ``batch_attention`` under ``use_attention_kernel``, else the plain
    masked softmax.  Returns (logits (B, V), cache).

    With ``starts`` (B,) and a ``branch_stride``, TREE decode: ``tokens``
    (B, C) are C candidate branches per row, all at depth ``lengths[i]``;
    branch b's K/V lands in its span at ``starts[i] + b * branch_stride``
    (the host drops the writes of inactive rows and of dummy branches past
    a row's real count, the JAX ``branch_counts``, in ``kv_write``) and
    attends over the shared prefix and its own span.  Returns per-branch
    logits (B, C, V)."""
    tree_step = starts is not None and branch_stride is not None
    last = None if tree_step else torch.zeros(
        tokens.shape[0], dtype=torch.int64, device=tokens.device)
    return tfm.forward(params["backbone"], tokens, cfg.transformer,
                       cache=cache, lengths=lengths.to(torch.int32),
                       starts=starts.to(torch.int32) if tree_step else None,
                       branch_stride=branch_stride if tree_step else None,
                       kv_write=kv_write, page_tables=page_tables,
                       page_gather=page_gather, page_size=page_size,
                       last_index=last)


# ---------------------------------------------------------------------------
# Generation over the batch-shared cache
# ---------------------------------------------------------------------------

TopK = Callable[[torch.Tensor, int], Tuple[torch.Tensor, torch.Tensor]]


def stable_top_k(x: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of the last axis and their ids, ties to the lowest id
    (as ``lax.top_k``): a stable descending sort."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def prefill(params, batch: Dict[str, torch.Tensor], cfg: OneRecConfig,
            cache: dict) -> Tuple[torch.Tensor, dict]:
    """Encode [profile + history] into a shared cache (``init_cache``);
    returns the last position's logits (B, V) and the filled cache."""
    tokens = batch["tokens"]
    embeds = _embed_with_profile(params, tokens, batch["profile"], cfg)
    last = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int64,
                      device=tokens.device)
    return tfm.forward(params["backbone"], tokens, cfg.transformer,
                       inputs_embeds=embeds, cache=cache, fill_cache=True,
                       last_index=last)


def decode_step(params, tokens: torch.Tensor, cfg: OneRecConfig,
                cache: dict, index: int) -> Tuple[torch.Tensor, dict]:
    """One semantic-ID decode step over a shared cache: tokens (B, 1) at
    absolute position ``index``.  Returns (logits (B, V), cache)."""
    logits, cache = tfm.forward(params["backbone"], tokens, cfg.transformer,
                                cache=cache, cache_index=int(index))
    return logits[:, -1], cache


def _map_rows(cache: dict, fn) -> dict:
    """``fn`` over the batch axis (1, under the layer axis) of every leaf
    that has one (k, v and the fp8 scales; the shared ``pos`` has none);
    fp8 payloads move as bytes."""
    def leaf(_, t):
        if t.ndim < 4:
            return t
        if t.dtype == torch.float8_e4m3fn:
            return fn(t.view(torch.uint8)).view(t.dtype)
        return fn(t)
    return tree.map_with_path(leaf, cache)


def beam_generate(params, batch: Dict[str, torch.Tensor], cfg: OneRecConfig,
                  *, beam_width: int = 0, topk_fn: Optional[TopK] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """OneRec beam search over the semantic-ID codebooks.  Returns (items
    (B, W, decode_len) int32, log-probs (B, W)) sorted by beam score;
    ``beam_width=1`` is greedy.  After the prefill the cache is replicated
    per beam (B -> B * W rows), and after every step each beam's rows are
    re-gathered from its parent's.  ``topk_fn`` defaults to
    ``stable_top_k``; ``radix_topk`` runs the selects on the card's
    kernel."""
    topk_fn = topk_fn or stable_top_k
    w = beam_width or cfg.beam_width
    b = batch["tokens"].shape[0]
    v = cfg.vocab_size
    dev = batch["tokens"].device
    cache = init_cache(cfg, b, device=dev)
    logits, cache = prefill(params, batch, cfg, cache)
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, top_ids = topk_fn(logp, w)                      # (B, W)
    beams = top_ids[..., None].to(torch.int32)              # (B, W, 1)
    cache = _map_rows(cache, lambda t: torch.repeat_interleave(t, w, dim=1))
    index = batch["tokens"].shape[1] + 1
    for _ in range(cfg.decode_len - 1):
        tok = beams[..., -1].reshape(b * w, 1)
        logits, cache = decode_step(params, tok, cfg, cache, index)
        index += 1
        logp = torch.log_softmax(logits.float(), dim=-1).reshape(b, w, v)
        cand = scores[..., None] + logp                     # (B, W, V)
        scores, flat_ids = topk_fn(cand.reshape(b, w * v), w)
        flat_ids = flat_ids.long()
        parent, token = flat_ids // v, flat_ids % v
        beams = torch.cat(
            [torch.take_along_dim(beams, parent[..., None], dim=1),
             token[..., None].to(torch.int32)], dim=-1)
        rows = (torch.arange(b, device=dev)[:, None] * w + parent).reshape(-1)
        cache = _map_rows(cache, lambda t: t.index_select(1, rows))
    return beams, scores


def generate_items(params, batch: Dict[str, torch.Tensor], cfg: OneRecConfig,
                   *, topk_fn: Optional[TopK] = None) -> torch.Tensor:
    """Greedy generation of one item (``decode_len`` tokens) per row over a
    shared cache; ``topk_fn`` as in ``beam_generate``.  Returns (B,
    decode_len) int32."""
    topk_fn = topk_fn or stable_top_k
    tokens = batch["tokens"]
    cache = sh.lay_out_cache(init_cache(cfg, tokens.shape[0],
                                        device=tokens.device), tokens)
    logits, cache = prefill(params, batch, cfg, cache)
    index = tokens.shape[1] + 1                             # + the profile
    out = []
    for _ in range(cfg.decode_len):
        # the vocabulary gathered whole, the batch as the tokens' layout
        logits = sh.constrain(logits, ("batch", None))
        _, top_ids = sh.local_call(topk_fn, logits, 1)
        nxt = top_ids[:, :1].to(torch.int32)
        out.append(nxt)
        logits, cache = decode_step(params, nxt, cfg, cache, index)
        index += 1
    return torch.cat(out, dim=1)
