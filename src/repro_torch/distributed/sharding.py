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
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

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
    (:func:`redistribute`) to the spec of the active rules on the active
    mesh (axes that do not divide dropped); without a mesh, and for a
    plain tensor (a rank's local slab), ``x`` is returned as it is.  A
    ``DTensor`` on another mesh than the active one raises."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    if x.device_mesh != mesh:
        raise ValueError(f"constrain: a DTensor on {x.device_mesh} under "
                         f"the active mesh {mesh}")
    spec = _divides(mesh, logical_to_spec(logical_axes), tuple(x.shape))
    return redistribute(x, placements(mesh, spec))


# ---------------------------------------------------------------------------
# DTensors without functional collectives
#
# DTensor's own redistribution runs functional collectives, which gloo
# does not run on CUDA tensors (a rank dies of SIGSEGV in
# ``all_gather_tensor`` on an H100, torch 2.11; ``all_reduce`` and
# ``all_gather_into_tensor`` run).  So the port moves DTensor data with
# the c10d collectives alone, and every DTensor op on the model path is
# one that DTensor computes shard by shard without communication.
# ---------------------------------------------------------------------------


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor``, without importing DTensor's module
    (~1.2 s a process): none exists before it is imported."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def local_shard(x):
    """A ``DTensor``'s local shard; any other value as it is."""
    return x.to_local() if is_dtensor(x) else x


def _byte_view(t):
    """fp8 payloads move through the collectives as bytes."""
    import torch
    return t.view(torch.uint8) if t.dtype in (
        torch.float8_e4m3fn, torch.float8_e5m2) else t


# The collectives' observers: ``STATS`` (when a dict) gets ``[calls,
# bytes, seconds, largest call's bytes]`` by ``(tag, kind)`` (each call
# synchronized by ``STATS_SYNC`` before and after, so its seconds are its
# own); ``AS_KIND`` names the collective an all-reduce stands in for (a
# reduce-scatter run as an all-reduce and a slice: ``(kind, bytes of its
# output)``), for the dry run's counter.  Module globals, not thread-local: a backward on the
# card runs on autograd's device thread.
STATS: Optional[Dict[Tuple[str, str], list]] = None
STATS_SYNC = None
AS_KIND: Optional[Tuple[str, int]] = None


def _observed(kind: str, tag: str, held, run):
    if STATS is None:
        return run()
    import time
    STATS_SYNC and STATS_SYNC()
    t0 = time.perf_counter()
    out = run()
    STATS_SYNC and STATS_SYNC()
    s = STATS.setdefault((tag, kind), [0, 0, 0.0, 0])
    nbytes = held.numel() * held.element_size()
    s[0] += 1
    s[1] += nbytes
    s[2] += time.perf_counter() - t0
    s[3] = max(s[3], nbytes)
    return out


def all_gather(t, dim: int, group, tag: str = "gather"):
    """The pieces ``t`` of the ranks of ``group`` concatenated along
    ``dim`` in rank order (``all_gather_into_tensor``; a group of one rank
    gives ``t`` itself)."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    if n == 1:
        return t
    src = _byte_view(t).movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    _observed("all-gather", tag, out, lambda: dist.all_gather_into_tensor(
        out, src, group=group))
    out = out.movedim(0, dim)
    return out.view(t.dtype) if out.dtype != t.dtype else out


def all_reduce(t, group, op: str = "sum", tag: str = "sum"):
    """``t`` summed (or maxed) over ``group``, in place; returns ``t``
    (a group of one rank moves nothing)."""
    import torch.distributed as dist
    if dist.get_world_size(group) == 1:
        return t
    _observed("all-reduce", tag, t, lambda: dist.all_reduce(
        t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op],
        group=group))
    return t


def reduce_scatter(t, dim: int, group, tag: str = "reduce-scatter"):
    """``t`` summed over ``group`` and this rank's slice of ``dim`` kept
    (a reduce-scatter), run as an all-reduce of a copy and a slice: the
    all-reduce is the collective gloo is known to run on CUDA tensors.
    It moves the whole of ``t``, where a reduce-scatter would move a
    ``1 / size`` slice of it."""
    import torch.distributed as dist
    global AS_KIND
    n, r = dist.get_world_size(group), dist.get_rank(group)
    if n == 1:
        return t
    part = t.shape[dim] // n
    full = t.contiguous().clone()
    AS_KIND = ("reduce-scatter", full.numel() // n * full.element_size())
    try:
        all_reduce(full, group, tag=tag)
    finally:
        AS_KIND = None
    return full.narrow(dim, r * part, part).contiguous()


# ---------------------------------------------------------------------------
# Collectives with a backward (training on local shards)
#
# Every rank holds the same replicated loss and seeds its backward with 1,
# so the backward of each data movement is its JAX transpose under that
# convention: a sum whose result every rank uses alike passes its
# cotangent through (Megatron's g); a replicated value that enters work
# that differs by rank gets its cotangents summed (Megatron's f); an
# all-gather whose result feeds such work sums and keeps the rank's slice
# (a reduce-scatter), and a reduce-scatter gathers.  The c10d calls above
# are the only ones: no functional collective, forward or backward.
# ---------------------------------------------------------------------------


def _grad_path(t) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, tag):
        out = t.clone()
        for g in groups:
            all_reduce(out, g, tag=tag)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Fan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, groups, tag):
        ctx.groups, ctx.tag = groups, tag
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        for g in ctx.groups:
            all_reduce(out, g, tag=ctx.tag)
        return out, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, tag):
        ctx.dim, ctx.group, ctx.tag = dim, group, tag
        return all_gather(t, dim, group, tag=tag)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_scatter(grad, ctx.dim, ctx.group,
                               tag=ctx.tag + "-bwd"), None, None, None)


class _SumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, tag):
        ctx.dim, ctx.group, ctx.tag = dim, group, tag
        return reduce_scatter(t, dim, group, tag=tag)

    @staticmethod
    def backward(ctx, grad):
        return (all_gather(grad.contiguous(), ctx.dim, ctx.group,
                           tag=ctx.tag + "-bwd"), None, None, None)


def _moving(groups) -> list:
    """The groups of more than one rank (a group of one moves nothing)."""
    import torch.distributed as dist
    return [g for g in groups if dist.get_world_size(g) > 1]


def psum(t, groups, tag: str = "sum"):
    """``t`` summed over each group of ``groups``, the result used alike on
    every rank: backward the identity.  Without a graph, in place."""
    groups = _moving(groups)
    if not groups:
        return t
    if _grad_path(t):
        return _Psum.apply(t, groups, tag)
    for g in groups:
        all_reduce(t, g, tag=tag)
    return t


def fan(t, groups, tag: str = "fan"):
    """``t`` as it is, entering work that differs by rank over ``groups``:
    backward sums its cotangents over them."""
    groups = _moving(groups)
    if not groups or not _grad_path(t):
        return t
    return _Fan.apply(t, groups, tag)


def gather(t, dim: int, group, tag: str = "gather"):
    """``all_gather`` whose backward is a reduce-scatter (its result feeds
    work that differs by rank)."""
    if _grad_path(t) and _moving([group]):
        return _Gather.apply(t, dim, group, tag)
    return all_gather(t, dim, group, tag=tag)


def sum_scatter(t, dim: int, group, tag: str = "sum-scatter"):
    """``reduce_scatter`` whose backward is an all-gather."""
    if _grad_path(t) and _moving([group]):
        return _SumScatter.apply(t, dim, group, tag)
    return reduce_scatter(t, dim, group, tag=tag)


def shard_range(mesh, places, dim: int, size: int,
                coord=None) -> Tuple[int, int]:
    """``(offset, length)`` of this rank's slice of global tensor dim
    ``dim`` (``size`` long) under ``places`` (mesh dims in order, the
    first major); of the rank at mesh coordinate ``coord`` when given."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate() if coord is None else coord
    idx, count = 0, 1
    for i, pl in enumerate(places):
        if isinstance(pl, Shard) and pl.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
            count *= mesh.size(i)
    if size % count:
        raise ValueError(f"dim {dim} of {size} does not split over {count} "
                         f"ranks")
    return idx * (size // count), size // count


def redistribute(x, target):
    """``x`` (a DTensor) laid out by ``target`` placements with the c10d
    collectives: ``Shard -> Replicate`` gathers over the mesh dim,
    ``Replicate -> Shard`` keeps the rank's slice, ``Partial ->
    Replicate`` sums.  Gathers run innermost mesh dim first, so a dim
    split over several mesh dims is put back in order.  Any other change
    raises."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    cur = list(x.placements)
    target = list(target)
    if cur == target:
        return x
    local = x.to_local()
    for i in reversed(range(len(cur))):          # gathers and sums
        src, dst = cur[i], target[i]
        if src == dst or isinstance(dst, Shard):
            continue
        if not isinstance(dst, Replicate):
            raise ValueError(f"redistribute: {src} -> {dst} on mesh dim "
                             f"{i} is not supported")
        group = mesh.get_group(i)
        if isinstance(src, Shard):
            inner = [j for j in range(i + 1, len(cur))
                     if isinstance(cur[j], Shard) and cur[j].dim == src.dim]
            if inner:
                raise ValueError(f"redistribute: dim {src.dim} stays split "
                                 f"over an inner mesh dim")
            local = gather(local, src.dim, group, tag="redistribute")
        elif isinstance(src, Partial):
            local = psum(local.clone(), [group], tag="redistribute")
        cur[i] = dst
    for i in range(len(cur)):                    # slices
        src, dst = cur[i], target[i]
        if src == dst:
            continue
        if not (isinstance(src, Replicate) and isinstance(dst, Shard)):
            raise ValueError(f"redistribute: {src} -> {dst} on mesh dim "
                             f"{i} is not supported")
        n = mesh.size(i)
        if local.shape[dst.dim] % n:
            raise ValueError(f"redistribute: dim {dst.dim} of "
                             f"{local.shape[dst.dim]} does not split over "
                             f"{n} ranks")
        part = local.shape[dst.dim] // n
        if _grad_path(local):
            local = _Keep.apply(local, dst.dim, mesh.get_group(i))
        else:
            local = local.narrow(dst.dim, mesh.get_local_rank(i) * part,
                                 part)
        cur[i] = dst
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())


class _Keep(torch.autograd.Function):
    """The rank's slice of a replicated tensor; backward gathers the
    slices' cotangents (every rank used the whole alike)."""

    @staticmethod
    def forward(ctx, t, dim, group):
        import torch.distributed as dist
        ctx.dim, ctx.group = dim, group
        part = t.shape[dim] // dist.get_world_size(group)
        return t.narrow(dim, dist.get_rank(group) * part, part).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return (all_gather(grad.contiguous(), ctx.dim, ctx.group,
                           tag="keep-bwd"), None, None)


class _Unsplit(torch.autograd.Function):
    """``_Keep``'s transpose: the slices gathered whole; backward keeps the
    rank's slice of the cotangent (every rank's the same: each consumer
    whose work differs by rank summed its own, as ``fan`` does)."""

    @staticmethod
    def forward(ctx, t, dim, group, tag):
        ctx.dim, ctx.group = dim, group
        return all_gather(t, dim, group, tag=tag)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist
        part = grad.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return (grad.narrow(ctx.dim, dist.get_rank(ctx.group) * part,
                            part).contiguous(), None, None, None)


def unsplit(x, logical_axes, tag: str = "sp-gather"):
    """``constrain`` for a move that only gathers, whose result every rank
    uses alike: the rows ``TRAIN_RULES_SP`` splits by sequence over
    ``model`` gathered whole where a layer takes them (its column-parallel
    products, whose ``fan`` sums the cotangent over ``model``; the MoE's
    tokens), and the attention's heads where every rank runs them all
    (``layers.attention._heads``).  Backward keeps the rank's slice
    (``_Unsplit``), where ``redistribute``'s gather reduce-scatters for
    work that sums nothing.
    Without a mesh, for a plain tensor, or with nothing to gather, ``x``
    as it is; any other move raises."""
    mesh = _CTX.mesh
    if mesh is None or not is_dtensor(x):
        return x
    return unsplit_to(x, placements(mesh, _divides(
        mesh, logical_to_spec(logical_axes), tuple(x.shape))), tag)


def unsplit_to(x, target, tag: str = "sp-gather"):
    """``unsplit`` to explicit ``target`` placements on ``x``'s mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    target = list(target)
    cur = list(x.placements)
    if cur == target:
        return x
    local = x.to_local()
    for i in reversed(range(len(cur))):
        if cur[i] == target[i]:
            continue
        if not (isinstance(cur[i], Shard) and isinstance(target[i],
                                                         Replicate)):
            raise ValueError(f"unsplit: {cur[i]} -> {target[i]} on mesh "
                             f"dim {i} is not a gather")
        if any(isinstance(cur[j], Shard) and cur[j].dim == cur[i].dim
               for j in range(i + 1, len(cur))):
            raise ValueError(f"unsplit: dim {cur[i].dim} stays split over "
                             f"an inner mesh dim")
        group = mesh.get_group(i)
        if _grad_path(local) and _moving([group]):
            local = _Unsplit.apply(local, cur[i].dim, group, tag)
        else:
            local = all_gather(local, cur[i].dim, group, tag=tag)
        cur[i] = target[i]
    return DTensor.from_local(local, mesh, target, run_check=False,
                              shape=x.shape, stride=x.stride())


def match(t, like):
    """``t`` in ``like``'s layout where that only keeps slices of what
    ``t`` holds whole (``redistribute``'s ``Replicate -> Shard``, whose
    backward gathers): a layer's output brought to the residual stream's
    layout before the add (``TRAIN_RULES_SP``).  ``t`` as it is where
    either is not a ``DTensor``; a move that would gather raises."""
    from torch.distributed.tensor import Replicate, Shard
    if not (is_dtensor(t) and is_dtensor(like)):
        return t
    for src, dst in zip(t.placements, like.placements):
        if src != dst and not (isinstance(src, Replicate)
                               and isinstance(dst, Shard)):
            raise ValueError(f"match: {list(t.placements)} -> "
                             f"{list(like.placements)} is not a slice")
    return redistribute(t, like.placements)


# ---------------------------------------------------------------------------
# Weights at use (training): storage sharded over ``data`` (ZeRO-3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Stored:
    """One layer's part of a stored parameter leaf: this rank's local
    tensor (in the graph of the leaf's ``to_local``) and its layout."""
    local: Any
    mesh: Any
    placements: tuple
    shape: tuple
    stride: tuple


# Logical axes whose shards are where a leaf is used, not only where it is
# stored: an embedding table's rows (its lookups run on the rank's rows,
# ``layers.embedding.gather_rows``; the JAX ``table_rows``).
USE_SHARDED_AXES = ("table_rows",)


def _use_placements(mesh, places, axes=None) -> tuple:
    """The placements a weight is used in: a ``Shard`` on each mesh axis
    the active rules give ``embed_fsdp`` (storage-only sharding) made
    ``Replicate``; tensor-parallel shards stay.  A leaf whose logical
    ``axes`` (``infer_param_axes``) start with one of ``USE_SHARDED_AXES``
    keeps every shard: a table's row shards are its use layout."""
    from torch.distributed.tensor import Replicate, Shard
    if axes and axes[0] in USE_SHARDED_AXES:
        return tuple(places)
    phys = (_CTX.rules or TRAIN_RULES).physical("embed_fsdp")
    fsdp = {phys} if isinstance(phys, str) else set(phys or ())
    names = list(mesh.mesh_dim_names)
    return tuple(Replicate() if isinstance(p, Shard) and names[i] in fsdp
                 else p for i, p in enumerate(places))


class _AtUse(torch.autograd.Function):
    """A stored local shard -> the ``DTensor`` in its use layout, its
    storage shards gathered over their mesh axes (innermost first).  The
    cotangent arrives in the use layout, ``Partial`` on each mesh axis
    whose ranks computed on other rows (``param_local``'s labels); each
    such axis is summed: a reduce-scatter where the weight was gathered,
    an all-reduce where it is replicated.  On a gathered axis with a
    ``Replicate`` cotangent (every rank's the same) the rank's slice is
    kept."""

    @staticmethod
    def forward(ctx, local, mesh, stored, use, shape, stride):
        from torch.distributed.tensor import DTensor
        ctx.mesh, ctx.stored, ctx.use = mesh, stored, use
        full = local
        for i in reversed(range(mesh.ndim)):
            if stored[i] != use[i]:
                full = all_gather(full, stored[i].dim, mesh.get_group(i),
                                  tag="weight-gather")
        if full is local:
            full = local.view_as(local)
        return DTensor.from_local(full, mesh, use, run_check=False,
                                  shape=shape, stride=stride)

    @staticmethod
    def backward(ctx, grad):
        none = (None,) * 5
        if grad is None:
            return (None, *none)
        mesh = ctx.mesh
        places = grad.placements if is_dtensor(grad) else ctx.use
        g = grad.to_local() if is_dtensor(grad) else grad
        for i in range(mesh.ndim):                    # outermost first
            gp, sp, up = places[i], ctx.stored[i], ctx.use[i]
            group = mesh.get_group(i)
            if sp != up:
                if gp.is_partial():
                    g = reduce_scatter(g, sp.dim, group, tag="grad-reduce")
                else:
                    part = g.shape[sp.dim] // mesh.size(i)
                    g = g.narrow(sp.dim, mesh.get_local_rank(i) * part,
                                 part)
            elif gp.is_partial():
                g = all_reduce(g.contiguous().clone(), group,
                               tag="grad-reduce")
            elif gp != sp:
                raise ValueError(f"a weight's cotangent {gp} against its "
                                 f"layout {sp} on mesh dim {i}")
        return (g.contiguous(), *none)


def _takes_stored(w) -> bool:
    """Whether a leaf goes through ``at_use``: a ``DTensor`` under autograd,
    or one whose storage is sharded for storage alone."""
    return is_dtensor(w) and (torch.is_grad_enabled() or _use_placements(
        w.device_mesh, w.placements) != tuple(w.placements))


def at_use(w, axes=None):
    """A weight as the layers use it (``_AtUse``): a ``Stored`` part or a
    ``DTensor`` leaf gathered over its storage shards, in the graph; any
    other leaf as it is.  ``axes``, the leaf's logical axes, name a table
    (``USE_SHARDED_AXES``), whose shards stay: no byte of it moves, and its
    cotangent (complete on the rank's rows, from the lookup's transpose)
    is not summed again."""
    if isinstance(w, Stored):
        local, mesh, places = w.local, w.mesh, w.placements
        shape, stride = w.shape, w.stride
    elif is_dtensor(w):
        local, mesh, places = w.to_local(), w.device_mesh, tuple(
            w.placements)
        shape, stride = tuple(w.shape), tuple(w.stride())
    else:
        return w
    use = _use_placements(mesh, places, axes)
    if use == places and is_dtensor(w) and not torch.is_grad_enabled():
        return w
    return _AtUse.apply(local, mesh, places, use, shape, stride)


def at_use_tree(tree):
    """``at_use`` on every leaf of a param tree, each ``DTensor`` leaf
    named by its logical axes (``infer_param_axes`` of its path)."""
    from repro_torch import tree as tree_util
    return tree_util.map_with_path(lambda path, w: at_use(
        w, infer_param_axes(path, w.ndim) if is_dtensor(w) else None), tree)


def unbind_layers(tree, n: int) -> list:
    """The ``n`` per-layer trees of a stacked param tree (``tree.unbind``);
    a leaf that ``at_use`` takes becomes ``n`` ``Stored`` parts of its
    local shard, so a layer's weight is gathered where the layer runs
    (inside its remat region) and released after."""
    from torch.distributed.tensor import Shard
    from repro_torch import tree as tree_util

    def parts(_, w):
        if not _takes_stored(w):
            return w.unbind(0) if torch.is_tensor(w) \
                else [w[i] for i in range(n)]
        places = tuple(Shard(p.dim - 1) if isinstance(p, Shard) else p
                       for p in w.placements)
        return [Stored(loc, w.device_mesh, places, tuple(w.shape[1:]),
                       tuple(w.stride()[1:]))
                for loc in w.to_local().unbind(0)]
    if not any(_takes_stored(w) for _, w in tree_util.leaves_with_path(
            tree)):
        return tree_util.unbind(tree, n)
    split = tree_util.map_with_path(parts, tree)
    return [tree_util.map_with_path(lambda _, p, i=i: p[i], split)
            for i in range(n)]


def param_local(w, x, *, feature_last: bool = True):
    """Weight ``w``'s local shard for work on ``x``'s local shard.  Under
    autograd its cotangent is labelled ``Partial`` on each mesh dim where
    ``w`` is replicated and ``x`` is split on a row dim (any dim but its
    last, the feature dim, when ``feature_last``): each rank's cotangent
    is its own rows' share, summed in ``at_use``'s backward.  A plain or
    quantized weight, or one without a graph, is its local shard."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    if not is_dtensor(w):
        return w.map_parts(local_shard) if hasattr(w, "map_parts") else w
    if not _grad_path(w) or not is_dtensor(x):
        return w.to_local()
    last = x.ndim - 1 if feature_last else x.ndim
    labels = [Partial() if isinstance(p, Replicate) and isinstance(
        xp, Shard) and xp.dim < last else p
        for p, xp in zip(w.placements, x.placements)]
    return w.to_local(grad_placements=labels)


def mesh_groups(x, which: str) -> list:
    """The process groups of DTensor ``x``'s mesh dims on which it is split
    on its last dim (``which="last"``) or on another (``"rows"``)."""
    from torch.distributed.tensor import Shard
    out = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and (p.dim == x.ndim - 1) == (
                which == "last"):
            out.append(x.device_mesh.get_group(i))
    return out


def split_groups(x) -> list:
    """The process groups of the mesh dims on which DTensor ``x`` is split
    (on any tensor dim); none for any other value."""
    from torch.distributed.tensor import Shard
    if not is_dtensor(x):
        return []
    return [x.device_mesh.get_group(i) for i, p in enumerate(x.placements)
            if isinstance(p, Shard)]


def total(x, tag: str = "total"):
    """``torch.sum(x)``: of a ``DTensor``, the local shard's sum summed
    over the mesh dims that split it (``psum``: a plain scalar, the same on
    every rank, its cotangent passed through); of any other tensor, its
    sum."""
    return psum(torch.sum(local_shard(x)), split_groups(x), tag=tag)


def mesh_index(x, axis: str) -> Tuple[int, int]:
    """``(rank, size)`` of this process on mesh axis ``axis`` of DTensor
    ``x``'s mesh, ``(0, 1)`` where the mesh lacks it."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    if axis not in names:
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(names.index(axis))


def placement_on(x, axis: str):
    """The placement of DTensor ``x`` on mesh axis ``axis`` (``Replicate``
    where the mesh lacks it)."""
    from torch.distributed.tensor import Replicate
    names = list(x.device_mesh.mesh_dim_names)
    return x.placements[names.index(axis)] if axis in names \
        else Replicate()


def local_call(fn, *args, like=None, **kwargs):
    """``fn`` on the local shards of the ``DTensor`` arguments (plain ones
    passed as they are); each tensor it returns (one, or a tuple) becomes a
    ``DTensor`` with the placements of ``like`` (by default the first
    ``DTensor`` argument), its global shape counted from the local one.
    Without a ``DTensor`` argument this is ``fn(*args, **kwargs)``: the
    plain path is untouched.  For shape-preserving and row-wise work on
    the local slab (RoPE, selects, top-k), where no data crosses ranks."""
    from torch.distributed.tensor import DTensor
    dts = [a for a in args if is_dtensor(a)]
    if not dts and like is None:
        return fn(*args, **kwargs)
    like = like if like is not None else dts[0]
    out = fn(*(local_shard(a) for a in args), **kwargs)

    def wrap(t):
        return DTensor.from_local(t, like.device_mesh, like.placements,
                                  run_check=False)
    return tuple(wrap(t) for t in out) if isinstance(out, tuple) \
        else wrap(out)


def lay_out(t, sharding: "NamedSharding", *, layout=None, device=None):
    """The rank's slice of the global tensor ``t`` (every rank's the
    same) as a ``DTensor`` on ``sharding.mesh``: a fresh tensor on
    ``device`` (``t``'s by default; ``meta`` stays ``meta``), in the
    memory layout of ``layout`` (``t`` by default): a K-major fp8 payload
    stays K-major, rows padded (``quant.k_major``), the layout the GEMM
    kernels read."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.core import quant
    mesh, places = sharding.mesh, sharding.placements
    layout = t if layout is None else layout
    local = t
    for dim in range(t.ndim):
        off, n = shard_range(mesh, places, dim, t.shape[dim])
        if n != t.shape[dim]:
            local = local.narrow(dim, off, n)
    dev = t.device if device is None else device
    if layout.ndim >= 2 and layout.stride(-2) == 1 \
            and layout.stride(-1) != 1:
        local = quant.k_major(local.to(dev))
    else:
        local = torch.empty(local.shape, dtype=local.dtype,
                            device=dev).copy_(local)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=t.shape, stride=layout.stride())


def lay_out_tree(tree, axes, mesh=None, rules: Optional[AxisRules] = None):
    """Every leaf of ``tree`` (tensors, ``QuantizedTensor``s part by
    part) laid out by :func:`lay_out` on ``mesh`` (the active one by
    default) by its logical axes in ``axes``, a tree of the same
    structure, under ``rules`` (the active ones, else ``TRAIN_RULES``)."""
    import dataclasses
    from repro_torch import tree as tree_util
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.distributed.elastic import shardings_for_tree
    mesh = mesh or _CTX.mesh
    specs = dict(tree_util.leaves_with_path(shardings_for_tree(
        tree, mesh, rules or _CTX.rules, axes=axes)))

    def leaf(path, w):
        s = specs[path]
        if isinstance(w, QuantizedTensor):
            return dataclasses.replace(w, **{
                name: None if getattr(w, name) is None
                else lay_out(getattr(w, name), getattr(s, name))
                for name in ("data", "scale", "act_scale")})
        return lay_out(w, s)
    return tree_util.map_with_path(leaf, tree)


def lay_out_cache(cache, like):
    """A fresh KV cache (zeros) laid out by :func:`cache_axes` on the
    active mesh when ``like``, the step's input, is a ``DTensor`` (the
    tensor-parallel path: the cache sequence-sharded over ``model`` under
    ``INFER_RULES``); else ``cache`` as it is."""
    if _CTX.mesh is None or not is_dtensor(like):
        return cache
    return lay_out_tree(cache, cache_axes(cache))


def cache_axes(cache):
    """Logical axes of every leaf of a KV cache tree (the JAX package's
    ``repro/launch/steps.py::cache_axes``): ``pos`` ``(..., "kv_seq")``,
    k / v ``(stack, B, S, Kv, hd)`` ``(..., "batch", "kv_seq",
    "kv_heads", None)``.  An fp8 cache's scales ``(stack, B, S, Kv)``
    get ``(..., "batch", "kv_seq", "kv_heads")``, aligned to their dims
    (the JAX rule hands them k's four names from the stack axis on).

    A per-slot cache's ``pos`` (stack, B, S) is so whole over ``data``:
    every rank writes every row's positions on the slots it holds, worked
    out from the host-resolved writes (``layers.attention._tp_write``).

    The paged heap, k / v ``(stack, N, Kv, hd)`` (one leading layer dim
    under ``stacks/``, none in a layer's own tree), has no batch dim: the
    JAX rule, counting from the end, would name the layer dim ``batch``.
    It is replicated, as an unannotated operand of the Pallas call runs
    under XLA's partitioner: every rank keeps the whole heap, writes every
    row's new K/V (gathered over the batch's mesh dims) and reads its own
    copy, so no collective moves it (the fused read copies the rank's KV
    heads out of it on the device, ``layers.attention._tp_read``)."""
    from repro_torch import tree as tree_util
    leaves = dict(tree_util.leaves_with_path(cache))

    def leaf(path, t):
        nd = t.ndim
        layer = path.rpartition("/")[0]
        k = leaves[f"{layer}/k" if layer else "k"]
        if k.ndim - (1 if path.startswith("stacks/") else 0) == 3:
            return (None,) * nd   # the paged heap: replicated
        if path.endswith("pos"):
            return (None,) * (nd - 1) + ("kv_seq",)
        if path.endswith("_scale"):
            return (None,) * (nd - 3) + ("batch", "kv_seq", "kv_heads")
        return (None,) * (nd - 4) + ("batch", "kv_seq", "kv_heads", None)
    return tree_util.map_with_path(leaf, cache)


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
