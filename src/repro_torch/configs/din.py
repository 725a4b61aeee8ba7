"""din [arXiv:1706.06978]: target attention, attn MLP 80-40, MLP 200-80."""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import recsys_shapes

CONFIG = RecsysConfig(
    name="din", family="din",
    embed_dim=18, n_items=10_000_000, n_users=10_000_000,
    n_sparse_fields=8, field_vocab=100_000, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80),
)

SHAPES = recsys_shapes()

FAMILY = "recsys"


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name="din-reduced", family="din",
        embed_dim=8, n_items=1000, n_users=1000,
        n_sparse_fields=4, field_vocab=50, seq_len=12,
        attn_mlp=(20, 10), mlp=(32, 16),
    )
