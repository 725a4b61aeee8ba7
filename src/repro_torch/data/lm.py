"""Synthetic LM token stream: seeded, per-host shardable, step-addressable
(numpy only: the same arrays as ``repro/data/lm.py`` for the same config).

A fixed random bigram transition table gives the stream learnable structure
(training loss decreases measurably within a few hundred steps at 100M
scale).  ``batch_at(step)`` is a pure function of (seed, step, host) — the
property the fault-tolerant restart test relies on.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    branching: int = 8  # bigram out-degree: lower => more learnable


class SyntheticLMStream:
    def __init__(self, cfg: LMStreamConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of n_hosts {cfg.n_hosts}")
        self.local_batch = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(cfg.seed)
        # each token transitions to one of `branching` successors
        self.table = rng.integers(0, cfg.vocab_size,
                                  size=(cfg.vocab_size, cfg.branching),
                                  dtype=np.int32)

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id, 0xBEEF))
        B, S = self.local_batch, cfg.seq_len
        tokens = np.empty((B, S + 1), np.int32)
        tokens[:, 0] = rng.integers(0, cfg.vocab_size, size=B)
        choices = rng.integers(0, cfg.branching, size=(B, S))
        for t in range(S):
            tokens[:, t + 1] = self.table[tokens[:, t], choices[:, t]]
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
