"""FP8 gradient compression with error feedback (the JAX package's
``repro/distributed/compression.py``).

Gradients are compressed to e4m3 with a per-tensor scale before the
cross-replica reduction, and the quantization residual is kept and added
back into the next step's gradient (error feedback), so the compression
error does not bias convergence.  ``ef_compress`` is the pure tree
transform the train loop calls, op for op the JAX one: equal f32 inputs
give bit-identical outputs on the CPU, and on the card (the scale's
divisor is a device tensor: CUDA divides by a host scalar through its
reciprocal).  ``compressed_psum`` (the reduction itself) waits for
ROADMAP.md queue N, item N9d.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.core.quant import E4M3, FP8_MAX, cast_to_fp8

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
