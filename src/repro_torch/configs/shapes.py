"""Assigned input-shape cells (one set per architecture family).  The
recsys and GNN sets wait for ROADMAP.md queue N, item N7b."""

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
