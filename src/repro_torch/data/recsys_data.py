"""Synthetic recommendation interactions with latent structure (numpy
only: the same batches as ``repro/data/recsys_data.py`` for the same config
and step).

A latent-factor model generates users, items, and click labels, so a
recsys model scores against a real signal.  Zipf-distributed item
popularity reproduces the skewed access pattern of production embedding
tables: the histories' gathers hit a few hot rows often.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class RecsysStreamConfig:
    n_items: int
    n_fields: int
    field_vocab: int
    seq_len: int
    global_batch: int
    d_latent: int = 16
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    zipf_a: float = 1.2


class SyntheticInteractions:
    def __init__(self, cfg: RecsysStreamConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {cfg.n_hosts} hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        self.item_latent = rng.normal(
            size=(cfg.n_items, cfg.d_latent)).astype(np.float32)
        self.item_latent /= np.linalg.norm(self.item_latent, axis=1,
                                           keepdims=True)

    def _zipf_items(self, rng, size):
        # bounded zipf via inverse-CDF on ranks
        u = rng.random(size=size)
        ranks = np.floor(
            (self.cfg.n_items ** (1 - self.cfg.zipf_a) * (1 - u) + u)
            ** (1 / (1 - self.cfg.zipf_a))).astype(np.int64)
        return np.clip(ranks - 1, 0, self.cfg.n_items - 1).astype(np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step, cfg.host_id, 0xFEED))
        B = self.local_batch
        hist = self._zipf_items(rng, (B, cfg.seq_len))
        # user taste = mean of history latents; positives are taste-aligned
        # candidates, negatives anti-aligned.
        taste = self.item_latent[hist].mean(axis=1)
        pos = rng.random(B) < 0.5
        cand8 = self._zipf_items(rng, (B, 8))
        align = np.einsum("bkd,bd->bk", self.item_latent[cand8], taste)
        best = np.argmax(align, axis=1)
        worst = np.argmin(align, axis=1)
        target = np.where(pos, cand8[np.arange(B), best],
                          cand8[np.arange(B), worst]).astype(np.int32)
        score = np.einsum("bd,bd->b", self.item_latent[target], taste)
        labels = (score > np.median(score)).astype(np.float32)
        fields = rng.integers(0, cfg.field_vocab,
                              size=(B, cfg.n_fields), dtype=np.int32)
        return {"hist_ids": hist, "target_ids": target,
                "field_ids": fields, "labels": labels}
