"""gemma3-1b [hf:google/gemma-3-1b-pt]: 5:1 local:global, 256k vocab, tied."""

from repro_torch.configs.base import TransformerConfig
from repro_torch.configs.shapes import lm_shapes

CONFIG = TransformerConfig(
    name="gemma3-1b",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144, act="gelu",
    sliding_window=512, global_interval=6,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    use_qk_norm=True, use_post_norm=True, zero_centered_norm=True,
    embed_scale=True, tie_embeddings=True,
    max_seq_len=524288,
)

# hybrid 5:1 local:global — long_500k RUNS for this arch (DESIGN.md §4)
SHAPES = lm_shapes(long_ctx_skip=None)

FAMILY = "lm"


def reduced_config() -> TransformerConfig:
    return TransformerConfig(
        name="gemma3-1b-reduced",
        n_layers=7, d_model=96, n_heads=4, n_kv_heads=1, head_dim=24,
        d_ff=192, vocab_size=512, act="gelu",
        sliding_window=8, global_interval=3,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        use_qk_norm=True, use_post_norm=True, zero_centered_norm=True,
        embed_scale=True, tie_embeddings=True,
        max_seq_len=128, remat=False,
    )
