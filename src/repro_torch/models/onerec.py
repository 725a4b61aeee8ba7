"""OneRec-V2-style generative recommender (the paper's §5.1 model): a
fat-MoE decoder over a semantic-ID vocabulary with a profile-feature prefix
token.  The serving entry points of ``repro/models/onerec.py``: ragged
prefill into per-slot rows and paged single-token decode.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import OneRecConfig
from repro_torch.core.quant import matmul_any
from repro_torch.device import resolve_device
from repro_torch.layers.attention import PageWrite
from repro_torch.layers.common import dense_init
from repro_torch.models import transformer as tfm

PROFILE_DIM = 64  # stub modality frontend: precomputed profile features


def init_onerec(seed: int, cfg: OneRecConfig, *, device=None) -> dict:
    """Random f32 params made on ``device`` (the card unless ``"cpu"``) from
    a ``torch.Generator`` seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return {
        "backbone": tfm.init_transformer(gen, cfg.transformer, device=dev),
        "profile_proj": dense_init(gen, PROFILE_DIM, cfg.transformer.d_model,
                                   device=dev),
    }


def _embed_with_profile(params, tokens, profile, cfg: OneRecConfig,
                        compute_dtype=torch.bfloat16):
    """[profile token] + semantic-ID token embeddings."""
    tok_emb = tfm.embed_tokens(params["backbone"], tokens, compute_dtype)
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


def init_page_pool(cfg: OneRecConfig, n_pages: int, page_size: int,
                   dtype=None, *, device=None) -> dict:
    """Paged serving cache: one flat pool of ``n_pages`` x ``page_size``
    positions (plus a sentinel page) shared by every request."""
    return tfm.init_kv_page_pool(cfg.transformer, n_pages, page_size, dtype,
                                 device=device)


def prefill_into_slots(params, batch: Dict[str, torch.Tensor],
                       cfg: OneRecConfig, cache: dict,
                       lengths: torch.Tensor):
    """Ragged prefill into a per-slot cache.  ``batch["tokens"]`` (B, T) is
    right-padded, ``lengths`` (B,) the true history-token counts; row i
    occupies positions 0 .. lengths[i] ([profile] + tokens).  Returns each
    row's own last-position logits (B, V) and the filled cache."""
    seq_lens = lengths.to(torch.int32) + 1        # + profile prefix token
    embeds = _embed_with_profile(params, batch["tokens"], batch["profile"],
                                 cfg)
    return tfm.forward(params["backbone"], batch["tokens"], cfg.transformer,
                       inputs_embeds=embeds, cache=cache, fill_cache=True,
                       lengths=seq_lens, last_index=seq_lens - 1)


def decode_step_slots(params, tokens: torch.Tensor, cfg: OneRecConfig,
                      cache: dict, lengths: torch.Tensor, *,
                      page_write: PageWrite, page_tables: torch.Tensor,
                      page_size: int):
    """Paged per-slot decode: tokens (B, 1), row i at its own absolute index
    ``lengths[i]``; K/V written at ``page_write``, attention through kernel
    ``paged_decode``.  Returns (logits (B, V), cache)."""
    return tfm.forward(params["backbone"], tokens, cfg.transformer,
                       cache=cache, lengths=lengths.to(torch.int32),
                       page_write=page_write, page_tables=page_tables,
                       page_size=page_size,
                       last_index=torch.zeros(tokens.shape[0],
                                              dtype=torch.int64,
                                              device=tokens.device))
