"""Assigned input-shape cells (one set per architecture family)."""

from __future__ import annotations

from typing import Dict, Optional

from repro_torch.configs.base import ShapeSpec


def lm_shapes(long_ctx_skip: Optional[str] = None) -> Dict[str, ShapeSpec]:
    """The 4 LM cells. ``long_ctx_skip`` marks long_500k N/A with a reason."""
    return {
        "train_4k": ShapeSpec("train_4k", "train", seq_len=4096,
                              global_batch=256),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill", seq_len=32768,
                                 global_batch=32),
        "decode_32k": ShapeSpec("decode_32k", "decode", seq_len=32768,
                                global_batch=128),
        "long_500k": ShapeSpec("long_500k", "decode", seq_len=524288,
                               global_batch=1, skip=long_ctx_skip),
    }


FULL_ATTN_SKIP = ("pure full-attention stack: 500k decode has no "
                  "sub-quadratic/windowed structure (DESIGN.md §4)")


def recsys_shapes() -> Dict[str, ShapeSpec]:
    return {
        "train_batch": ShapeSpec("train_batch", "train", global_batch=65536),
        "serve_p99": ShapeSpec("serve_p99", "score", global_batch=512),
        "serve_bulk": ShapeSpec("serve_bulk", "score", global_batch=262144),
        "retrieval_cand": ShapeSpec("retrieval_cand", "retrieval",
                                    global_batch=1, n_candidates=1_000_000),
    }


def gnn_shapes() -> Dict[str, ShapeSpec]:
    return {
        "full_graph_sm": ShapeSpec("full_graph_sm", "graph", n_nodes=2708,
                                   n_edges=10556, d_feat=1433,
                                   note="cora full-batch"),
        "minibatch_lg": ShapeSpec("minibatch_lg", "graph", n_nodes=232_965,
                                  n_edges=114_615_892, batch_nodes=1024,
                                  fanout=(15, 10), d_feat=602,
                                  note="reddit neighbor-sampled"),
        "ogb_products": ShapeSpec("ogb_products", "graph", n_nodes=2_449_029,
                                  n_edges=61_859_140, d_feat=100,
                                  note="full-batch large"),
        "molecule": ShapeSpec("molecule", "graph", n_nodes=30, n_edges=64,
                              global_batch=128, d_feat=16,
                              note="batched small graphs"),
    }


def onerec_shapes() -> Dict[str, ShapeSpec]:
    """The paper's own serving/training cells (extras beyond the 40)."""
    return {
        "serve_b32": ShapeSpec("serve_b32", "decode", seq_len=512,
                               global_batch=32,
                               note="paper §5.1 serving configuration"),
        "prefill_b32": ShapeSpec("prefill_b32", "prefill", seq_len=384,
                                 global_batch=32),
        "train_b512": ShapeSpec("train_b512", "train", seq_len=384,
                                global_batch=512),
    }
