"""deepseek-coder-33b [arXiv:2401.14196]: llama-arch dense, GQA kv=8."""

from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.shapes import FULL_ATTN_SKIP, lm_shapes

CONFIG = TransformerConfig(
    name="deepseek-coder-33b",
    n_layers=62, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=19200, vocab_size=32256, act="silu",
    rope_theta=100000.0, tie_embeddings=False,
    max_seq_len=32768,
)

SHAPES = lm_shapes(long_ctx_skip=FULL_ATTN_SKIP)

FAMILY = "lm"


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="deepseek-coder-33b-reduced",
        n_layers=4, d_model=112, n_heads=7, n_kv_heads=1, head_dim=16,
        d_ff=300, vocab_size=512, act="silu",
        rope_theta=100000.0, max_seq_len=128, remat=False,
    )
