"""llama3-8b [arXiv:2407.21783]: dense, GQA kv=8, 128k vocab."""

from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.shapes import FULL_ATTN_SKIP, lm_shapes

CONFIG = TransformerConfig(
    name="llama3-8b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256, act="silu",
    rope_theta=500000.0, tie_embeddings=False,
    max_seq_len=32768,
)

SHAPES = lm_shapes(long_ctx_skip=FULL_ATTN_SKIP)

FAMILY = "lm"


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="llama3-8b-reduced",
        n_layers=4, d_model=128, n_heads=8, n_kv_heads=2, head_dim=16,
        d_ff=256, vocab_size=512, act="silu",
        rope_theta=500000.0, max_seq_len=128, remat=False,
    )
