"""FP8 gradient compression with error feedback (the JAX package's
``repro/distributed/compression.py``).

Gradients are compressed to e4m3 with a per-tensor scale before the
cross-replica reduction, and the quantization residual is kept and added
back into the next step's gradient (error feedback), so the compression
error does not bias convergence.  ``ef_compress`` is the pure tree
transform the train loop calls, op for op the JAX one: equal f32 inputs
give bit-identical outputs on the CPU, and on the card (the scale's
divisor is a device tensor: CUDA divides by a host scalar through its
reciprocal).  ``compressed_psum`` is the reduction itself: compress, then
sum each leaf over one axis of the active mesh.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.core.quant import E4M3, FP8_MAX, cast_to_fp8
from repro_torch.distributed.sharding import current_mesh, mesh_axes

F32 = torch.float32
_SCALE_FLOOR = 1e-30      # the JAX floor, not ``quant._EPS``


def ef_init(grads: Dict[str, Any]) -> Dict[str, Any]:
    return tree.map_with_path(lambda _, g: torch.zeros_like(g, dtype=F32),
                              grads)


def _compress_leaf(g: torch.Tensor, r: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    gt = g.to(F32) + r
    amax = torch.amax(torch.abs(gt))
    fmax = torch.full((), FP8_MAX[E4M3], dtype=F32, device=gt.device)
    scale = torch.clamp(amax, min=_SCALE_FLOOR) / fmax
    q = cast_to_fp8(gt, scale, E4M3)
    ghat = q.to(F32) * scale
    return ghat.to(g.dtype), gt - ghat


def ef_compress(grads: Dict[str, Any], residuals: Dict[str, Any]
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(grads, residuals) -> (fp8-grid grads, new residuals)."""
    res = dict(tree.leaves_with_path(residuals))
    out = tree.map_with_path(lambda path, g: _compress_leaf(g, res[path]),
                             grads)
    return (tree.map_with_path(lambda _, o: o[0], out),
            tree.map_with_path(lambda _, o: o[1], out))


def compressed_psum(grads: Dict[str, Any], axis_name: str,
                    residuals: Dict[str, Any]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Error-feedback compress, then a SUM all-reduce of every leaf over
    the active mesh's ``axis_name`` group (``sharding.use_mesh``).
    Returns (reduced grads, new residuals); the grads passed in are not
    changed."""
    mesh = current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs an active mesh "
                         "(distributed.sharding.use_mesh)")
    if axis_name not in mesh_axes(mesh):
        raise ValueError(f"mesh has no axis {axis_name!r}: "
                         f"{tuple(mesh_axes(mesh))}")
    group = mesh.get_group(axis_name)
    ghat, new_res = ef_compress(grads, residuals)
    for _, g in tree.leaves_with_path(ghat):
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
    return ghat, new_res
