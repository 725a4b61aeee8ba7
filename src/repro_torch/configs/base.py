"""Config schema of the port: the two dataclasses the OneRec serving path
reads, field for field the same as ``repro.configs.base`` (the parity tests
compare every field), without the JAX package's dry-run and zoo extras."""

from __future__ import annotations

import dataclasses


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
