"""AdamW + cosine schedule + global-norm clipping over a param tree (the
JAX package's ``repro/optim/adamw.py``, term by term).

``mu`` and ``nu`` are f32 leaves of the params' paths and shapes, the step
counter an int32 tensor.  The update runs leaf by leaf IN PLACE on the
param, ``mu``, ``nu`` and the gradient (its buffer is reused as scratch),
with one leaf-sized f32 temporary at a time: the stacked expert leaves of
6-layer OneRec-V2 are 3.2 GB each, and a functional update would hold
five such temporaries.  Every elementwise step is the JAX expression's,
in its order, each rounded to f32 (no fused multiply-add, no reciprocal:
the schedule and bias corrections are f32 device tensors and divisions
are by tensors), so equal gradients give bit-identical params, ``mu`` and
``nu`` wherever the f32 scalars agree (tested).  ``global_norm`` sums the
leaves in the JAX flatten order (``tree.flat_leaves``).

On a mesh the leaves are ``DTensor``s: params, gradients, ``mu`` and
``nu`` share a leaf's placements (``launch.steps.params_axes`` lays the
moments out as the JAX ``arg_axes`` do), so the update runs on the local
shards as it is; ``global_norm`` sums each leaf's local sum of squares
over the mesh dims it is split on (each element counted once), so every
rank clips by the same scale.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch import tree
from repro_torch.distributed import sharding as sh

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=F32, device=like.device)


def cosine_schedule(cfg: OptimizerConfig
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """step (an int tensor) -> the f32 learning rate: linear warmup, then
    a cosine decay to ``min_lr_ratio * lr`` at ``total_steps``."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = step / _f32(max(cfg.warmup_steps, 1), step)
        prog = (step - cfg.warmup_steps) / _f32(
            max(cfg.total_steps - cfg.warmup_steps, 1), step)
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return fn


def global_norm(grads: Dict[str, Any]) -> torch.Tensor:
    """sqrt of the sum over leaves (JAX flatten order) of each leaf's f32
    sum of squares; a ``DTensor`` leaf's summed over the mesh dims it is
    split on (one all-reduce a set of such dims for all its leaves)."""
    from torch.distributed.tensor import Shard
    leaves = tree.flat_leaves(grads)
    sums = [torch.sum(torch.square(sh.local_shard(leaf).to(F32)))
            for leaf in leaves]
    by_groups: Dict[tuple, list] = {}
    for i, leaf in enumerate(leaves):
        if sh.is_dtensor(leaf):
            dims = tuple(d for d, p in enumerate(leaf.placements)
                         if isinstance(p, Shard))
            if dims:
                by_groups.setdefault((leaf.device_mesh, dims), []).append(i)
    for (mesh, dims), idx in by_groups.items():
        part = torch.stack([sums[i] for i in idx])
        for d in dims:
            sh.all_reduce(part, mesh.get_group(d), tag="grad-norm")
        for j, i in enumerate(idx):
            sums[i] = part[j]
    return torch.sqrt(sum(sums))


def adamw_init(params: Dict[str, Any]) -> Dict[str, Any]:
    """f32 zero moments of every param leaf, and the int32 step 0."""
    zeros = lambda _, p: torch.zeros_like(p, dtype=F32)    # noqa: E731
    leaf = sh.local_shard(next(iter(tree.flat_leaves(params))))
    return {"mu": tree.map_with_path(zeros, params),
            "nu": tree.map_with_path(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def _update_leaf(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, *, scale: torch.Tensor,
                 lr: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                 cfg: OptimizerConfig) -> None:
    """The JAX ``upd(p, g, mu, nu)`` in place: ``g`` (f32) is scratch, ``t``
    the one temporary."""
    b1, b2 = cfg.b1, cfg.b2
    g = g.mul_(scale) if g.dtype == F32 else g.to(F32) * scale
    t = g * (1 - b1)
    mu.mul_(b1).add_(t)                             # b1*mu + (1-b1)*g
    torch.mul(g, g, out=t).mul_(1 - b2)
    nu.mul_(b2).add_(t)                             # b2*nu + (1-b2)*g^2
    torch.div(mu, bc1, out=t)                       # mhat
    torch.div(nu, bc2, out=g).sqrt_().add_(cfg.eps)
    t.div_(g)                                       # mhat/(sqrt(nhat)+eps)
    if cfg.weight_decay and p.ndim >= 2:  # no decay on norms/biases
        t.add_(torch.mul(p.to(F32), cfg.weight_decay, out=g))
    t.mul_(lr)
    if p.dtype == F32:
        p.sub_(t)
    else:
        p.copy_(p.to(F32).sub_(t))


def _like(old, new: torch.Tensor):
    """``new`` laid out as ``old`` (a replicated ``DTensor`` step counter
    stays one)."""
    if not sh.is_dtensor(old):
        return new
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False)


def adamw_update(params: Dict[str, Any], grads: Dict[str, Any],
                 state: Dict[str, Any], cfg: OptimizerConfig
                 ) -> Tuple[Dict[str, Any], Dict[str, Any],
                            Dict[str, torch.Tensor]]:
    """One AdamW step, in place (params, ``state`` and the gradient
    buffers are overwritten; ``DTensor`` leaves shard by shard).  Returns
    (params, state, metrics)."""
    step = sh.local_shard(state["step"]) + 1
    lr = cosine_schedule(cfg)(step)
    gnorm = global_norm(grads)
    if cfg.clip_norm > 0:
        scale = torch.clamp(_f32(cfg.clip_norm, gnorm) / (gnorm + 1e-9),
                            max=1.0)
    else:
        scale = _f32(1.0, gnorm)
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(_f32(cfg.b1, stepf), stepf)
    bc2 = 1 - torch.pow(_f32(cfg.b2, stepf), stepf)
    flat_g = dict(tree.leaves_with_path(grads))
    flat_mu = dict(tree.leaves_with_path(state["mu"]))
    flat_nu = dict(tree.leaves_with_path(state["nu"]))
    loc = sh.local_shard
    for path, p in tree.leaves_with_path(params):
        _update_leaf(loc(p), loc(flat_g[path]), loc(flat_mu[path]),
                     loc(flat_nu[path]), scale=scale, lr=lr, bc1=bc1,
                     bc2=bc2, cfg=cfg)
    state["step"] = _like(state["step"], step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
