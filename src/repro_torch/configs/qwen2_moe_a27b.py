"""qwen2-moe-a2.7b [hf:Qwen/Qwen1.5-MoE-A2.7B]: 4 shared + 60 routed top-4."""

from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.shapes import FULL_ATTN_SKIP, lm_shapes

CONFIG = TransformerConfig(
    name="qwen2-moe-a2.7b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=151936, act="silu",
    moe=True, n_experts=60, top_k=4, d_expert=1408,
    n_shared_experts=4, shared_expert_gate=True,
    norm_topk_prob=False, capacity_factor=1.25,
    rope_theta=1_000_000.0, tie_embeddings=False,
    max_seq_len=32768, ep_degree=16,
)

SHAPES = lm_shapes(long_ctx_skip=FULL_ATTN_SKIP)

FAMILY = "lm"


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="qwen2-moe-a2.7b-reduced",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=512, act="silu",
        moe=True, n_experts=8, top_k=4, d_expert=96,
        n_shared_experts=2, shared_expert_gate=True,
        norm_topk_prob=False, capacity_factor=1.5,
        max_seq_len=128, ep_degree=4, remat=False,
    )
