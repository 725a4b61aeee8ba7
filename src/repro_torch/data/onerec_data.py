"""Synthetic semantic-ID behavior streams for OneRec-V2.

Items live in a latent space quantized by 3 nested codebooks (residual-VQ
style, as in OneRec's tokenizer): an item = (l0, l1, l2) codes.  Users
follow latent interests, so the "next item" is predictable from history —
training learns, and FP8-vs-BF16 A/B parity is measured on real ranking
metrics (hit-rate of generated semantic IDs vs the held-out click).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class OneRecStreamConfig:
    codebook_size: int = 8192
    n_codebooks: int = 3
    history_len: int = 128
    global_batch: int = 32
    n_interests: int = 64
    profile_dim: int = 64
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1


class SemanticIDStream:
    def __init__(self, cfg: OneRecStreamConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        # each latent interest maps to a small pool of items (code tuples)
        self.pool = rng.integers(
            0, cfg.codebook_size,
            size=(cfg.n_interests, 16, cfg.n_codebooks), dtype=np.int32)
        self.interest_profile = rng.normal(
            size=(cfg.n_interests, cfg.profile_dim)).astype(np.float32)

    def batch_at(self, step: int) -> dict:
        """Train batch: tokens (B, H*3 + 3), labels mask history, profile."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id, 0x13EC))
        B = self.local_batch
        interest = rng.integers(0, cfg.n_interests, size=B)
        hist_items = self.pool[interest][
            np.arange(B)[:, None], rng.integers(0, 16, size=(B, cfg.history_len))]
        # the clicked item is the user's most recent click (a deterministic,
        # learnable mapping — the A/B parity metrics need a model that can
        # actually learn; "repeat-last-click" is the classic floor baseline)
        target = hist_items[:, -1]
        hist_tokens = hist_items.reshape(B, cfg.history_len * cfg.n_codebooks)
        tokens = np.concatenate([hist_tokens, target], axis=1).astype(np.int32)
        # labels align with [profile, tokens...] positions: position p
        # predicts token p+1, so the label for the LAST HISTORY position is
        # target[0] and the final position (last target token) is masked.
        T = tokens.shape[1]
        labels = np.full((B, T + 1), -1, np.int32)
        labels[:, -cfg.n_codebooks - 1:-1] = target
        profile = (self.interest_profile[interest]
                   + 0.1 * rng.normal(size=(B, cfg.profile_dim))
                   ).astype(np.float32)
        return {"tokens": tokens, "labels": labels, "profile": profile,
                "target": target.astype(np.int32)}

    def serve_request_at(self, step: int) -> dict:
        """Serving request: history only; held-out target for metric eval."""
        b = self.batch_at(step)
        cfg = self.cfg
        hist = b["tokens"][:, :cfg.history_len * cfg.n_codebooks]
        return {"tokens": hist, "profile": b["profile"],
                "target": b["target"]}
