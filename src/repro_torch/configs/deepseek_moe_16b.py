"""deepseek-moe-16b [arXiv:2401.06066]: 2 shared + 64 routed top-6,
fine-grained experts, first layer dense."""

from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.shapes import FULL_ATTN_SKIP, lm_shapes

CONFIG = TransformerConfig(
    name="deepseek-moe-16b",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400, act="silu",
    moe=True, n_experts=64, top_k=6, d_expert=1408,
    n_shared_experts=2, n_dense_layers=1, d_ff_dense=10944,
    norm_topk_prob=False, capacity_factor=1.25,
    rope_theta=10000.0, tie_embeddings=False,
    max_seq_len=32768, ep_degree=16,
)

SHAPES = lm_shapes(long_ctx_skip=FULL_ATTN_SKIP)

FAMILY = "lm"


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-moe-16b-reduced",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab_size=512, act="silu",
        moe=True, n_experts=8, top_k=3, d_expert=96,
        n_shared_experts=1, n_dense_layers=1, d_ff_dense=256,
        norm_topk_prob=False, capacity_factor=1.5,
        max_seq_len=128, ep_degree=4, remat=False,
    )
