"""Config schema of the port: the shape cells and the four dataclasses the
OneRec serving path, the LM zoo, the recsys family and the EGNN read, field
for field the same as ``repro.configs.base`` (the parity tests compare
every field and the two parameter counts).  Every architecture module in
``repro_torch/configs`` exposes ``CONFIG`` (the full published
configuration), ``reduced_config()`` (a small same-family config for CPU
tests), ``SHAPES`` (its input-shape cells) and ``FAMILY``."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One (architecture x input-shape) cell."""

    name: str
    kind: str                 # "train" | "prefill" | "decode" | "score" | "graph"
    seq_len: int = 0
    global_batch: int = 0
    # recsys / gnn extras
    n_candidates: int = 0
    n_nodes: int = 0
    n_edges: int = 0
    d_feat: int = 0
    batch_nodes: int = 0
    fanout: Tuple[int, ...] = ()
    note: str = ""
    skip: Optional[str] = None   # reason string when the cell is N/A


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    act: str = "silu"
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_expert: int = 0
    n_shared_experts: int = 0
    shared_expert_gate: bool = False
    n_dense_layers: int = 0          # leading dense layers (deepseek-moe)
    d_ff_dense: int = 0              # their width (0 => d_ff)
    norm_topk_prob: bool = False
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.0      # Switch-style load-balance loss
    # --- attention pattern ---
    sliding_window: int = 0          # 0 => full attention everywhere
    global_interval: int = 0         # every Nth layer is global (gemma3: 6)
    rope_theta: float = 10000.0
    rope_theta_local: float = 0.0    # gemma3 local layers (0 => rope_theta)
    use_qk_norm: bool = False
    attn_chunk_size: int = 1024
    use_attention_kernel: bool = False  # batch_attention kernel on decode
    # --- norms / embeddings ---
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False  # gemma-style (1 + scale)
    use_post_norm: bool = False       # gemma sandwich norms
    embed_scale: bool = False         # multiply embeddings by sqrt(d_model)
    tie_embeddings: bool = False
    # --- execution ---
    max_seq_len: int = 8192
    remat: bool = True
    ep_degree: int = 16               # expert-parallel padding degree
    use_fp8: bool = False             # serve-time default policy
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "float8_e4m3fn"

    @property
    def d_ff_for_dense(self) -> int:
        return self.d_ff_dense or self.d_ff

    def param_count_estimate(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        dense_ffn = 3 * d * self.d_ff_for_dense
        per_moe = (3 * d * self.d_expert * self.n_experts
                   + 3 * d * self.d_expert * self.n_shared_experts
                   + d * self.n_experts)
        n_moe = (self.n_layers - self.n_dense_layers) if self.moe else 0
        n_dense = self.n_layers - n_moe
        if not self.moe:
            dense_ffn = 3 * d * self.d_ff
        body = self.n_layers * attn + n_dense * dense_ffn + n_moe * per_moe
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + embed

    def active_param_count_estimate(self) -> int:
        """Activated params per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.param_count_estimate()
        d = self.d_model
        hd = self.head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
            + (self.n_heads * hd) * d
        per_moe_active = 3 * d * self.d_expert * (self.top_k
                                                  + self.n_shared_experts)
        n_moe = self.n_layers - self.n_dense_layers
        n_dense = self.n_dense_layers
        body = (self.n_layers * attn + n_dense * 3 * d * self.d_ff_for_dense
                + n_moe * per_moe_active)
        embed = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return body + embed


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    family: str                       # "two_tower" | "mind" | "din" | "dien"
    embed_dim: int
    n_items: int = 1_000_000          # item-vocab rows
    n_users: int = 1_000_000
    n_sparse_fields: int = 8          # categorical context fields
    field_vocab: int = 100_000
    seq_len: int = 100                # behavior-history length
    # family-specific
    tower_mlp: Tuple[int, ...] = ()
    mlp: Tuple[int, ...] = ()
    attn_mlp: Tuple[int, ...] = ()
    n_interests: int = 0
    capsule_iters: int = 0
    gru_dim: int = 0
    use_fp8: bool = False


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    family: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    d_coord: int = 3
    use_fp8: bool = False             # inapplicable; kept for API uniformity


@dataclasses.dataclass(frozen=True)
class OneRecConfig:
    """OneRec-V2-style generative recommender (paper §5.1 envelope)."""

    name: str = "onerec-v2"
    # semantic-ID tokenizer: 3 codebook levels
    n_codebooks: int = 3
    codebook_size: int = 8192
    history_len: int = 128            # items; each item = n_codebooks tokens
    decode_len: int = 3               # tokens generated per recommended item
    # fat-MoE backbone (~4B total / ~0.5B active)
    transformer: TransformerConfig = dataclasses.field(
        default_factory=lambda: TransformerConfig(
            name="onerec-v2-backbone",
            n_layers=12, d_model=2048, n_heads=16, n_kv_heads=4,
            head_dim=128, d_ff=8192, vocab_size=8192 + 64,
            moe=True, n_experts=12, top_k=2, d_expert=4096,
            n_shared_experts=0, capacity_factor=1.5,
            rope_theta=10000.0, max_seq_len=512,
        ))
    # serving
    serve_batch: int = 32
    beam_width: int = 8
    use_fp8: bool = True

    @property
    def vocab_size(self) -> int:
        return self.transformer.vocab_size

    @property
    def context_len(self) -> int:
        return self.history_len * self.n_codebooks + self.decode_len
