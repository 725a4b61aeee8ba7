"""Nested-dict param and cache trees: the port's stand-in for JAX pytrees.

A tree is a dict of dicts whose leaves are tensors or ``QuantizedTensor``s;
a leaf's path is its keys joined with ``/`` (``backbone/stacks/0/p0/attn/
q_proj/kernel``), the same strings the JAX package's pytree paths give, so
``QuantPolicy`` patterns apply unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


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
