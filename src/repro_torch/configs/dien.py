"""dien [arXiv:1809.03672]: GRU interest extraction + AUGRU evolution."""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import recsys_shapes

CONFIG = RecsysConfig(
    name="dien", family="dien",
    embed_dim=18, n_items=10_000_000, n_users=10_000_000,
    n_sparse_fields=8, field_vocab=100_000, seq_len=100,
    gru_dim=108, mlp=(200, 80),
)

SHAPES = recsys_shapes()

FAMILY = "recsys"


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name="dien-reduced", family="dien",
        embed_dim=8, n_items=1000, n_users=1000,
        n_sparse_fields=4, field_vocab=50, seq_len=12,
        gru_dim=24, mlp=(32, 16),
    )
