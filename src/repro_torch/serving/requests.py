"""Shared request construction: the ONE place a serving request dict is
assembled.

A serving request is a plain dict — ``tokens`` (ragged int32 semantic-ID
history), ``profile`` (float32 user features), and optional ``arrival_s``
(offset from submission), ``priority`` (int class, lower = more
important), ``deadline_s`` (offset from submission) — consumed by
``ServingEngine.submit`` / ``serve_requests``.  Every producer (the
launcher, the examples, the benchmarks, and ``ServingEngine.
generate_batch``) builds its dicts through these helpers instead of
hand-rolling them, so a field rename or validation change lands in one
file.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def make_request(tokens: np.ndarray, profile: np.ndarray, *,
                 arrival_s: float = 0.0, priority: int = 0,
                 deadline_s: Optional[float] = None,
                 n_candidates: int = 1,
                 first_token: Optional[int] = None) -> Dict:
    """One serving-request dict; optional fields are omitted when unset so
    the dicts stay minimal (and JSON-friendly for trace replay).

    ``n_candidates > 1`` asks for a ranked set of K candidate items per
    request (tree decode; ``Completion.items`` / ``scores``).
    ``first_token`` forces the seed token of a single-candidate decode —
    the constrained-decode hook the differential test harness uses to
    replay one tree branch as an independent sequential request."""
    req: Dict = {"tokens": np.asarray(tokens, np.int32),
                 "profile": np.asarray(profile, np.float32)}
    if arrival_s:
        req["arrival_s"] = float(arrival_s)
    if priority:
        req["priority"] = int(priority)
    if deadline_s is not None:
        req["deadline_s"] = float(deadline_s)
    if n_candidates != 1:
        req["n_candidates"] = int(n_candidates)
    if first_token is not None:
        req["first_token"] = int(first_token)
    return req


def requests_from_arrays(tokens: np.ndarray,
                         profile: np.ndarray) -> List[Dict]:
    """A uniform (B, T) token batch + (B, D) profile batch -> B request
    dicts (the seed engine's ``generate_batch`` calling convention)."""
    if tokens.shape[0] != profile.shape[0]:
        raise ValueError(f"batch mismatch: {tokens.shape[0]} token rows vs "
                         f"{profile.shape[0]} profiles")
    return [make_request(tokens[i], profile[i])
            for i in range(tokens.shape[0])]


def build_requests(cfg, n_requests: int, batch: int, seed: int,
                   ragged: bool, n_candidates: int = 1) -> List[Dict]:
    """Synthesize ``n_requests`` requests from the OneRec semantic-ID
    stream (the launcher/example/benchmark workload generator).  With
    ``ragged`` each history is truncated to a random item count, the
    mixed-length regime continuous batching targets.  ``seed`` pins the
    whole stream (content AND lengths) — every workload here is
    reproducible run-to-run from its seed.  ``n_candidates`` stamps a
    per-request candidate-set size (tree decode)."""
    from repro_torch.data.onerec_data import OneRecStreamConfig, SemanticIDStream

    stream = SemanticIDStream(OneRecStreamConfig(
        codebook_size=cfg.transformer.vocab_size - 64,
        history_len=cfg.history_len, global_batch=batch, seed=seed))
    rng = np.random.default_rng(seed)
    requests = []
    step = 0
    while len(requests) < n_requests:
        r = stream.serve_request_at(step)
        for i in range(r["tokens"].shape[0]):
            tokens = r["tokens"][i]
            if ragged:  # mixed history lengths: truncate to a random prefix
                n_items = int(rng.integers(2, cfg.history_len + 1))
                tokens = tokens[:n_items * cfg.n_codebooks]
            requests.append(make_request(tokens, r["profile"][i],
                                         n_candidates=n_candidates))
        step += 1
    return requests[:n_requests]
