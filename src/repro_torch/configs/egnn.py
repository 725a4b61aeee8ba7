"""egnn [arXiv:2102.09844]: E(n)-equivariant GNN, 4 layers, d_hidden 64.

FP8 PTQ is documented inapplicable to this family (DESIGN.md §4); the arch
is implemented without the paper's technique.
"""

from repro_torch.configs.base import GNNConfig
from repro_torch.configs.shapes import gnn_shapes

CONFIG = GNNConfig(name="egnn", family="egnn", n_layers=4, d_hidden=64)

SHAPES = gnn_shapes()

FAMILY = "gnn"

N_CLASSES = 16  # synthetic label space used across graph cells


def reduced_config() -> GNNConfig:
    return GNNConfig(name="egnn-reduced", family="egnn",
                     n_layers=2, d_hidden=16)
