"""mind [arXiv:1904.08030]: multi-interest capsule routing, 4 interests."""

from repro_torch.configs.base import RecsysConfig
from repro_torch.configs.shapes import recsys_shapes

CONFIG = RecsysConfig(
    name="mind", family="mind",
    embed_dim=64, n_items=10_000_000, n_users=10_000_000,
    n_sparse_fields=8, field_vocab=100_000, seq_len=50,
    n_interests=4, capsule_iters=3,
)

SHAPES = recsys_shapes()

FAMILY = "recsys"


def reduced_config() -> RecsysConfig:
    return RecsysConfig(
        name="mind-reduced", family="mind",
        embed_dim=8, n_items=1000, n_users=1000,
        n_sparse_fields=4, field_vocab=50, seq_len=12,
        n_interests=4, capsule_iters=3,
    )
