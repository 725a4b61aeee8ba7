"""Logical-axis sharding (t5x / MaxText style), the JAX package's
``repro/distributed/sharding.py``.

Model code names tensor axes logically (``'batch'``, ``'heads'``, ``'mlp'``,
``'expert'``, ...) and calls :func:`constrain`; a rule set maps logical names
to physical mesh axes.  Outside a mesh, and on a plain tensor, ``constrain``
is the identity, so the same model code runs on one device and, with
``DTensor`` leaves, over a ``DeviceMesh``.

Physical mesh axes (``launch/mesh.py``):
  * ``pod``   -- slowest axis, across pods, pure data parallelism.
  * ``data``  -- data parallelism / FSDP storage sharding.
  * ``model`` -- tensor / expert parallelism.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` (axis names
from ``mesh_dim_names``, sizes from ``shape``) or any object with
``axis_names`` and a ``shape`` mapping (a stand-in for the rules alone).
Specs are the port's :class:`P`, a tuple whose entries compare equal to
``jax.sharding.PartitionSpec``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

MeshAxes = Union[None, str, Tuple[str, ...]]


class AxisRules:
    """Mapping logical axis name -> physical mesh axis (or tuple, or None)."""

    def __init__(self, rules: Dict[str, MeshAxes]):
        self.rules = dict(rules)

    def physical(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        return self.rules.get(logical)

    def replace(self, **kw) -> "AxisRules":
        out = dict(self.rules)
        out.update(kw)
        return AxisRules(out)


# Training: Megatron TP over `model`, batch over (pod, data), FSDP storage
# sharding of the non-TP weight axis over `data`, experts over `model` (EP).
TRAIN_RULES = AxisRules({
    "batch": ("pod", "data"),
    "seq": None,
    "act_seq": None,            # residual stream between layers (SP variant)
    "embed": None,
    "embed_fsdp": "data",       # weight-storage-only sharding (ZeRO/FSDP)
    "heads": "model",
    "kv_heads": None,           # kv heads can be < TP degree (GQA): replicate
    "head_dim": None,
    "qkv_out": "model",         # flattened heads*head_dim projection outputs
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_ffn": None,
    "capacity": None,
    "kv_seq": None,
    # recsys / gnn
    "table_rows": ("data", "model"),
    "table_dim": None,
    "nodes": ("data", "model"),
    "edges": ("data", "model"),
    "candidates": ("data", "model"),
    "feature": None,
})

# Inference: weights TP over `model`, replicated over data; batch over
# (pod, data); long-context KV cache sharded along the sequence dim.
INFER_RULES = TRAIN_RULES.replace(
    embed_fsdp=None,
    kv_seq="model",
)

# Sequence parallelism: the residual stream between layers sharded over
# `model` ('act_seq'), so the activations saved for the backward shrink by
# the TP degree.
TRAIN_RULES_SP = TRAIN_RULES.replace(act_seq="model")

# FSDP / DP-dominant sharding for models too small to feed a 16-wide TP
# group: no tensor parallelism; `model` carries extra data parallelism for
# activations and joins `data` for parameter / optimizer storage.
TRAIN_RULES_FSDP = AxisRules({
    **TRAIN_RULES.rules,
    "batch": ("pod", "data", "model"),
    "heads": None, "qkv_out": None, "mlp": None, "vocab": None,
    "expert": None,
    "embed_fsdp": ("data", "model"),
    "act_seq": None,
})

RULE_SETS = {
    "train": TRAIN_RULES,
    "infer": INFER_RULES,
    "train_sp": TRAIN_RULES_SP,
    "train_fsdp": TRAIN_RULES_FSDP,
}


class P(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated), a
    mesh axis name, or a tuple of names (the dim split over their product,
    the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a mesh stand-in."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: mesh.shape[a] for a in mesh.axis_names}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: Optional[AxisRules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[AxisRules] = None):
    """Activate a mesh + rule set for ``constrain`` and the MoE's expert
    parallelism within the block (this thread only)."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, rules or TRAIN_RULES
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _CTX.mesh


def current_rules() -> Optional[AxisRules]:
    return _CTX.rules


def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules: Optional[AxisRules] = None, mesh=None) -> P:
    """Build a spec, dropping physical axes that are already used or that
    the mesh lacks."""
    rules = rules or _CTX.rules or TRAIN_RULES
    mesh = mesh or _CTX.mesh
    names = None if mesh is None else mesh_axes(mesh)
    used = set()
    out: List[MeshAxes] = []
    for ax in logical_axes:
        phys = rules.physical(ax)
        if phys is None:
            out.append(None)
            continue
        phys_t = (phys,) if isinstance(phys, str) else tuple(phys)
        phys_t = tuple(p for p in phys_t
                       if p not in used and (names is None or p in names))
        used.update(phys_t)
        if not phys_t:
            out.append(None)
        elif len(phys_t) == 1:
            out.append(phys_t[0])
        else:
            out.append(phys_t)
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def _divides(mesh, spec: P, shape: Tuple[int, ...]) -> P:
    """Drop spec entries whose mesh-axis product doesn't divide the dim."""
    sizes = mesh_axes(mesh)
    fixed: List[MeshAxes] = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                         - len(spec))):
        if entry is None:
            fixed.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep = []
        quot = dim
        for a in axes:
            if quot % sizes[a] == 0:
                keep.append(a)
                quot //= sizes[a]
        if not keep:
            fixed.append(None)
        elif len(keep) == 1:
            fixed.append(keep[0])
        else:
            fixed.append(tuple(keep))
    while fixed and fixed[-1] is None:
        fixed.pop()
    return P(*fixed)


def placements(mesh, spec: P) -> list:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: one
    ``Shard(dim)`` or ``Replicate()`` per mesh dim.  DTensor splits a
    tensor dim over several mesh dims in mesh order, so a tuple entry must
    name its axes in that order (the JAX layout is then the same)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx = [names.index(a) for a in
               ((entry,) if isinstance(entry, str) else entry)]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} of dim {dim} is not in the mesh's "
                f"axis order {tuple(names)}: DTensor cannot lay it out")
        for i in idx:
            out[i] = Shard(dim)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: P

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """Lay ``x`` out by logical axis names: a ``DTensor`` is redistributed
    to the spec of the active rules on the active mesh (axes that do not
    divide dropped); without a mesh, and for a plain tensor (a rank's
    local slab), ``x`` is returned as it is."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = _divides(mesh, logical_to_spec(logical_axes), tuple(x.shape))
    return x.redistribute(mesh, placements(mesh, spec))


def infer_param_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter leaf, from its tree path.

    Matches the framework's naming conventions (``repro_torch/layers``);
    QuantizedTensor children (data / scale) inherit the kernel's axes --
    ``_divides`` then drops whatever doesn't fit the scale's reduced dims.
    """
    p = path.lower()

    def ax(*names: Optional[str]) -> Tuple[Optional[str], ...]:
        """Right-align the given axes to ndim (stacked leading dims -> None)."""
        names_t = tuple(names)
        if len(names_t) >= ndim:
            return names_t[len(names_t) - ndim:]
        return (None,) * (ndim - len(names_t)) + names_t

    if "item_embed" in p or "field_embed" in p:
        return ax("table_rows", None)
    if "embed/table" in p:
        return ax("vocab", "embed_fsdp")
    if "lm_head" in p:
        return ax("embed_fsdp", "vocab")
    if "/experts/gate" in p or "/experts/up" in p:
        return ax("expert", "embed_fsdp", "mlp")
    if "/experts/down" in p:
        return ax("expert", "mlp", "embed_fsdp")
    if "router" in p:
        return ax(None, None)
    if any(f"{n}/kernel" in p for n in ("q_proj", "k_proj", "v_proj")):
        return ax("embed_fsdp", "qkv_out")
    if "o_proj/kernel" in p:
        return ax("qkv_out", "embed_fsdp")
    if any(f"{n}/kernel" in p for n in ("gate", "up")) and "mlp" in p or \
            "shared/gate" in p or "shared/up" in p:
        return ax("embed_fsdp", "mlp")
    if "down/kernel" in p:
        return ax("mlp", "embed_fsdp")
    # small dense nets (recsys towers, gnn MLPs, routers, norms, biases):
    # replicated -- they are KB-scale.
    return (None,) * ndim


def param_sharding(logical_axes: Sequence[Optional[str]],
                   shape: Tuple[int, ...], mesh=None,
                   rules: Optional[AxisRules] = None) -> NamedSharding:
    """The sharding of a parameter, with divisibility fixed up."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        raise ValueError("param_sharding requires a mesh")
    spec = logical_to_spec(logical_axes, rules=rules, mesh=mesh)
    spec = _divides(mesh, spec, tuple(shape))
    return NamedSharding(mesh, spec)
