"""Production and debug meshes (the JAX package's ``repro/launch/mesh.py``).

FUNCTIONS, never module-level state: importing this module touches no
process group and no device.  Each builds a ``DeviceMesh`` over the
default process group, which the caller initializes first
(``torch.distributed.init_process_group`` with its address, world size and
rank); its world size must be the mesh's.
"""

from __future__ import annotations

from typing import Tuple


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device_type: str):
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs a process group of {n} ranks: call "
            f"torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *,
                    device_type: str = "cuda"):
    """A small ``(n_data, n_model)`` ``("data", "model")`` mesh."""
    return _mesh((n_data, n_model), ("data", "model"), device_type)
