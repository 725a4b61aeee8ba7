"""onerec-v2 (the paper's model): fat-MoE generative recommender,
~4B backbone / ~0.5B active per token, semantic-ID decoding, batch-32
short-context serving (paper §5.1)."""

from repro_torch.configs.base import OneRecConfig, TransformerConfig

CONFIG = OneRecConfig()


def reduced_config() -> OneRecConfig:
    return OneRecConfig(
        name="onerec-v2-reduced",
        history_len=8,
        transformer=TransformerConfig(
            name="onerec-v2-reduced-backbone",
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=64, capacity_factor=1.5, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4,
    )
