"""Elastic re-sharding: restore any checkpoint onto any mesh (the JAX
package's ``repro/distributed/elastic.py``).

Checkpoints store global logical arrays (``checkpoint/store.py``), so
scaling a job from N ranks to M is: build the target mesh, derive each
leaf's sharding from the same logical-axis rules, and let every rank keep
its slice of the global value as a ``DTensor``.  Divisibility fix-ups
happen in ``logical_to_spec`` / ``_divides``, so a mesh whose axis sizes
don't divide a dim simply drops that axis for that leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch import tree as tree_util
from repro_torch.checkpoint.store import _QT_CHILDREN, load_checkpoint
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed.sharding import (AxisRules, NamedSharding,
                                              TRAIN_RULES, _divides,
                                              infer_param_axes,
                                              logical_to_spec)


def _sharding(axes, leaf, mesh, rules: AxisRules) -> NamedSharding:
    spec = logical_to_spec(axes, rules=rules, mesh=mesh)
    return NamedSharding(mesh, _divides(mesh, spec, tuple(leaf.shape)))


def _part(axes, name: str):
    return getattr(axes, name) if isinstance(axes, QuantizedTensor) \
        else axes


def shardings_for_tree(tree: Any, mesh, rules: Optional[AxisRules] = None,
                       axes: Any = None) -> Any:
    """A ``NamedSharding`` for every leaf, in the tree's structure (the
    dry run's ``shardings_for``): its logical axes from ``axes``, a tree
    of the same structure (``launch.steps.params_axes`` / ``cache_axes``
    / ``batch_axes``; one tuple for a ``QuantizedTensor`` is every part's,
    the scale inheriting the kernel's axes), or by default the param-axis
    rules of its path.
    Paths are the JAX package's: keys joined with ``/``, a
    ``QuantizedTensor``'s children ``/0`` (data), ``/1`` (scale) and
    ``/2`` (act_scale), their flat indices."""
    rules = rules or TRAIN_RULES
    given = None if axes is None else dict(tree_util.leaves_with_path(axes))

    def leaf(path, w):
        if isinstance(w, QuantizedTensor):
            return dataclasses.replace(w, **{
                name: None if getattr(w, name) is None
                else _sharding(
                    infer_param_axes(f"{path}/{i}", getattr(w, name).ndim)
                    if given is None else _part(given[path], name),
                    getattr(w, name), mesh, rules)
                for i, name in enumerate(_QT_CHILDREN)})
        return _sharding(infer_param_axes(path, w.ndim) if given is None
                         else given[path], w, mesh, rules)

    return tree_util.map_with_path(leaf, tree)


def restore_elastic(ckpt_path: str, template: Any, mesh,
                    rules: Optional[AxisRules] = None) -> Tuple[Any, Dict]:
    """Load a checkpoint onto ``mesh`` regardless of the mesh it was saved
    from (the elastic-scaling path): a tree of ``DTensor``s and the
    manifest.  ``template`` may hold ``meta`` tensors."""
    return load_checkpoint(ckpt_path, template,
                           shardings=shardings_for_tree(template, mesh,
                                                        rules))
