"""two-tower-retrieval [RecSys'19 (YouTube)]: dot-product retrieval,
sampled softmax, tower MLP 1024-512-256."""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import recsys_shapes

CONFIG = RecsysConfig(
    name="two-tower-retrieval", family="two_tower",
    embed_dim=256, n_items=10_000_000, n_users=10_000_000,
    n_sparse_fields=8, field_vocab=100_000, seq_len=50,
    tower_mlp=(1024, 512, 256),
)

SHAPES = recsys_shapes()

FAMILY = "recsys"


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name="two-tower-reduced", family="two_tower",
        embed_dim=16, n_items=1000, n_users=1000,
        n_sparse_fields=4, field_vocab=50, seq_len=12,
        tower_mlp=(64, 32, 16),
    )
