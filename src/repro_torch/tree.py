"""Nested-dict param and cache trees: the port's stand-in for JAX pytrees.

A tree is a dict of dicts whose leaves are tensors or ``QuantizedTensor``s;
a leaf's path is its keys joined with ``/`` (``backbone/stacks/0/p0/attn/
q_proj/kernel``), the same strings the JAX package's pytree paths give, so
``QuantPolicy`` patterns apply unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch


def leaves_with_path(tree: Dict[str, Any], prefix: str = ""
                     ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from leaves_with_path(val, path)
        else:
            yield path, val


def flat_leaves(tree: Dict[str, Any]) -> List[Any]:
    """The leaves in the JAX flatten order: each dict's keys sorted (so
    ``"10"`` comes before ``"2"``, as ``jax.tree_util`` orders them)."""
    out: List[Any] = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(flat_leaves(val) if isinstance(val, dict) else [val])
    return out


def value_and_grad(fn: Callable[..., torch.Tensor], params: Dict[str, Any],
                   *args, **kwargs) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``jax.value_and_grad(fn)(params, *args)``: the scalar ``fn(params,
    ...)`` and its gradient tree (the params' paths).  The params are not
    marked: ``fn`` sees detached aliases that require grad, so the caller's
    tensors stay plain leaves (updatable in place, servable without a
    graph)."""
    paths = [path for path, _ in leaves_with_path(params)]
    alias = map_with_path(lambda _, p: p.detach().requires_grad_(), params)
    loss = fn(alias, *args, **kwargs)
    leaves = dict(leaves_with_path(alias))
    grads = torch.autograd.grad(loss, [leaves[p] for p in paths],
                                allow_unused=True)
    by_path = {p: torch.zeros_like(leaves[p]) if g is None else g
               for p, g in zip(paths, grads)}
    return loss.detach(), map_with_path(lambda path, _: by_path[path],
                                        params)


def map_with_path(fn: Callable[[str, Any], Any], tree: Dict[str, Any],
                  prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        out[key] = map_with_path(fn, val, path) if isinstance(val, dict) \
            else fn(path, val)
    return out


def index(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Slice the leading (layer) axis of every leaf: the per-layer view of a
    stacked tree (views, no copies)."""
    return map_with_path(lambda _, leaf: leaf[i], tree)


def unbind(tree: Dict[str, Any], n: int) -> List[Dict[str, Any]]:
    """The ``n`` per-layer trees of a stacked tree, each tensor leaf split
    once (``unbind``): one layer's gradient is written into a slice of the
    stacked leaf's, where ``index`` would give every layer a zero gradient
    of the whole stack to add.  ``QuantizedTensor`` leaves are indexed."""
    parts = map_with_path(
        lambda _, leaf: leaf.unbind(0) if torch.is_tensor(leaf)
        else [leaf[i] for i in range(n)], tree)
    return [map_with_path(lambda _, p, i=i: p[i], parts) for i in range(n)]


def empty_like(t: torch.Tensor, lead: Tuple[int, ...] = (),
               device=None) -> torch.Tensor:
    """Empty ``(*lead, *t.shape)`` storage on ``device`` (``t``'s by
    default) whose slices have t's memory layout: a K-major payload
    (``stride(-2) == 1``, the transpose view of an (.., out, in) array,
    rows padded as ``quant.k_major`` pads them, the padding zeroed) stays
    K-major; any other leaf is contiguous."""
    device = t.device if device is None else device
    if t.ndim >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        k, ld = t.shape[-2], t.stride(-1)      # rows padded past K, if so
        alloc = torch.empty if ld == k else torch.zeros
        base = alloc((*lead, *t.shape[:-2], t.shape[-1], ld), dtype=t.dtype,
                     device=device)
        return base[..., :k].transpose(-1, -2)
    return torch.empty((*lead, *t.shape), dtype=t.dtype, device=device)


def _alloc(leaf, n: int):
    if torch.is_tensor(leaf):
        return empty_like(leaf, (n,))
    return dataclasses.replace(            # a QuantizedTensor
        leaf, data=empty_like(leaf.data, (n,)),
        scale=empty_like(leaf.scale, (n,)),
        act_scale=None if leaf.act_scale is None
        else empty_like(leaf.act_scale, (n,)))


def _put(stacked, i: int, leaf) -> None:
    if torch.is_tensor(leaf):
        stacked[i].copy_(leaf)
        return
    for name in ("data", "scale", "act_scale"):
        part = getattr(leaf, name)
        if part is not None:
            getattr(stacked, name)[i].copy_(part)


def stack_layers(make: Callable[[int], Dict[str, Any]], n: int
                 ) -> Dict[str, Any]:
    """The trees ``make(0) .. make(n - 1)`` stacked on a new leading (layer)
    axis, made one at a time and copied into storage allocated after the
    first: beside the stack, at most one layer's tree exists (a full-width
    model made layer by layer never holds a second copy of its weights).
    ``QuantizedTensor`` leaves stack field by field."""
    layer = make(0)
    out = map_with_path(lambda _, leaf: _alloc(leaf, n), layer)
    flat = dict(leaves_with_path(out))
    for i in range(n):
        if i:
            layer = make(i)
        for path, leaf in leaves_with_path(layer):
            _put(flat[path], i, leaf)
        layer = None
    return out
