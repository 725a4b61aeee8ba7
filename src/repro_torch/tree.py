"""Nested-dict param and cache trees: the port's stand-in for JAX pytrees.

A tree is a dict of dicts whose leaves are tensors or ``QuantizedTensor``s;
a leaf's path is its keys joined with ``/`` (``backbone/stacks/0/p0/attn/
q_proj/kernel``), the same strings the JAX package's pytree paths give, so
``QuantPolicy`` patterns apply unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Tuple

import torch


def leaves_with_path(tree: Dict[str, Any], prefix: str = ""
                     ) -> Iterator[Tuple[str, Any]]:
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(val, dict):
            yield from leaves_with_path(val, path)
        else:
            yield path, val


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


def _stacked_like(t: torch.Tensor, n: int) -> torch.Tensor:
    """Empty (n, *t.shape) storage whose slices have t's memory layout: a
    K-major payload (``stride(-2) == 1``, the transpose view of an (.., out,
    in) array, rows padded as ``quant.k_major`` pads them) stays K-major."""
    if t.ndim >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1:
        k, ld = t.shape[-2], t.stride(-1)      # rows padded past K, if so
        alloc = torch.empty if ld == k else torch.zeros
        base = alloc((n, *t.shape[:-2], t.shape[-1], ld), dtype=t.dtype,
                     device=t.device)
        return base[..., :k].transpose(-1, -2)
    return torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)


def _alloc(leaf, n: int):
    if torch.is_tensor(leaf):
        return _stacked_like(leaf, n)
    return dataclasses.replace(            # a QuantizedTensor
        leaf, data=_stacked_like(leaf.data, n),
        scale=_stacked_like(leaf.scale, n),
        act_scale=None if leaf.act_scale is None
        else _stacked_like(leaf.act_scale, n))


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
