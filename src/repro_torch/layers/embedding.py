"""Embedding tables and EmbeddingBag, the JAX package's
``repro/layers/embedding.py`` in PyTorch.

The JAX package builds the bag lookup from ``jnp.take`` +
``jax.ops.segment_sum`` / ``segment_max``, XLA ops with no Pallas kernel;
here they are ``index_select`` + ``segment_sum`` / ``scatter_reduce`` over
f32 rows, so every mode sums and compares in f32 as the JAX package does
(``torch.nn.functional.embedding_bag`` is not used: it reduces in the
table's dtype).  ``segment_sum`` adds each segment's rows in their order
on either device (the EGNN's message passing uses it too): ``index_add_``
on the CPU, a stable sort by segment then ``torch.segment_reduce`` on the
card, where ``index_add_`` adds with atomics in no fixed order; the two
give the same bits.  An empty bag gives 0 in every mode: ``segment_max``
gives ``-inf`` there and the JAX code maps it to 0, so the max starts from
``-inf`` (``include_self=False`` over a ``-inf`` fill) and non-finite
results become 0.  Row gathers go through ``gather_rows``, whose gradient
is that ``segment_sum`` (the JAX gather's transpose, a scatter-add), so a
backward adds each row's contributions in a fixed order on the card too.

Chunked sums (the EGNN's message passing over more edges than fit at once,
``models/gnn.py``): ``segment_sum(..., out=acc)`` adds a chunk's rows into
f32 sums ``acc`` that the caller carries from chunk to chunk, and
``segment_plan`` makes the card's sort of a chunk's ids once, for every
sum over them.  A gather's backward carries its sums the same way
(``RowGrads``: the f32 sums of every gather that reads one table, rounded
once).  On the CPU ``index_add_`` adds each row into its segment in index
order, so contiguous chunks carried in order give one pass's bits (the
forward; a gather's backward adds the chunks in the order autograd runs
them, which is fixed but not theirs).  On the card each chunk's segments
are summed on their own (the sort) and then added to the carried sums: one
rounding more per segment and chunk, in a fixed order, so a chunked sum
holds to a floor against one pass, not to its bits.

Over a mesh (``DTensor`` operands) both run on each rank's shards:

* ``gather_rows`` of a table sharded on its rows: ids replicated on a mesh
  dim (the LMs' vocabulary under ``INFER_RULES``) -- each rank gathers the
  ids in its row range, zeroes the others and the ranks sum; ids sharded
  on the same mesh dim as the table (the recsys tables over ``(data,
  model)`` with the batch over ``data``) -- the ids are gathered over that
  dim first, each rank looks up the ids in its row range, zeroes the rest,
  and the ranks sum the rows keeping each its own slice of the ids' dim
  (``sharding.sum_scatter``, whose transpose is ``gather``).  A sum of one
  nonzero row and zeros is exact in any dtype, so the rows are one rank's
  bits, and they are cast to the compute dtype before the sum (half the
  bytes at bf16).  Per split mesh dim of k ranks a rank moves the ids
  (k x its ids x 4 B, an all-gather) and the looked-up rows (an all-reduce
  of k x its ids x the row's bytes, kept as a reduce-scatter's slice);
  the backward gathers the rows' cotangent (the same bytes).  The table's
  cotangent is the rank's rows' ``segment_sum`` over every id in the ids'
  global order: complete on the rank's rows, not summed again
  (``sharding.at_use``).  Routing each id to the rank that owns its row
  (an all-to-all) would move ``(k - 1) / k`` of the rank's ids and rows
  instead: ROADMAP.md queue B.
* ``segment_sum`` of rows sharded on dim 0 (the EGNN's edges) into
  segments laid out like ``like`` (its nodes, sharded on dim 0) or
  replicated: each rank sums its rows into all ``n`` segments in row order
  (f32), and the ranks sum, keeping each its own slice of the segments
  (``sum_scatter``; its transpose gathers) or all of them (``psum``).
  The f32 sums run in another association than world 1's: a bound, not
  bits.

``embedding_bag`` and ``multi_hot_bag`` reduce after the lookup, on the
rank's rows (a bag split over ranks is summed over them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.layers.common import truncated_normal


def init_embedding(gen: torch.Generator, vocab: int, dim: int, *,
                   stddev: Optional[float] = None, dtype=torch.float32,
                   device=None) -> dict:
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(dim)
    return {"table": truncated_normal((vocab, dim), stddev, gen, device,
                                      dtype)}


def segment_plan(seg: torch.Tensor, n: int):
    """The card's sort of segment ids ``seg`` (int64) for ``segment_sum``
    into ``n`` rows: ``(stable order, segment lengths)``, made once and
    passed to every sum over the same ids; ``None`` on the CPU (and
    ``meta``), whose ``index_add_`` needs none."""
    if seg.device.type in ("cpu", "meta"):
        return None
    order = torch.argsort(seg, stable=True)
    lengths = torch.zeros(n, dtype=torch.int64, device=seg.device
                          ).index_add_(0, seg, torch.ones_like(order))
    return order, lengths


class _SegmentSum(torch.autograd.Function):
    """``vals``' rows (f32) summed by segment into ``out`` (in place) or
    into fresh zeros: on the CPU by ``index_add_`` in index order, on the
    card by ``segment_reduce`` over the rows sorted stably by segment
    (``plan``), added to ``out``.  Its transpose is the gather of the
    cotangent by ``seg`` (what autograd gives through ``index_add_`` or
    ``segment_reduce`` and the sort), keeping nothing but the ids: not
    the rows, which ``index_add_``'s and ``segment_reduce``'s own
    backwards save."""

    @staticmethod
    def forward(ctx, vals, seg, n, out, plan):
        ctx.save_for_backward(seg)
        ctx.carried = out is not None
        if out is not None:
            ctx.mark_dirty(out)
        if vals.device.type in ("cpu", "meta"):
            if out is None:
                out = vals.new_zeros((n, *vals.shape[1:]))
            return out.index_add_(0, seg, vals)
        order, lengths = plan if plan is not None else segment_plan(seg, n)
        part = torch.segment_reduce(vals.index_select(0, order), "sum",
                                    lengths=lengths, axis=0, unsafe=True)
        return part if out is None else out.add_(part)

    @staticmethod
    def backward(ctx, grad):
        seg, = ctx.saved_tensors
        return (grad.index_select(0, seg), None, None,
                grad if ctx.carried else None, None)


def segment_sum(vals: torch.Tensor, seg: torch.Tensor, n: int,
                like=None, *, out: Optional[torch.Tensor] = None,
                plan=None) -> torch.Tensor:
    """f32 sums of ``vals``' rows by segment id ``seg`` (int64) into ``n``
    rows (``jax.ops.segment_sum``), each segment summed in row order.
    ``out``: f32 sums carried from earlier chunks, which this chunk's rows
    are added into (in place) and which are returned; ``plan``:
    ``segment_plan(seg, n)``, the card's sort made once (module
    docstring).  ``DTensor`` operands: the sharded sum (module
    docstring), laid out as ``like`` on its row dims (replicated without
    one)."""
    if sh.is_dtensor(vals) or sh.is_dtensor(seg):
        return _sharded_segment_sum(vals, seg, n, like)
    return _SegmentSum.apply(vals.to(torch.float32), seg, n, out, plan)


def _sharded_segment_sum(vals, seg, n, like):
    """``segment_sum`` of rows split on dim 0 over some mesh dims (``seg``
    split alike): the rank's rows into all ``n`` segments, then
    ``segment_total``."""
    from torch.distributed.tensor import Replicate
    rows = vals if sh.is_dtensor(vals) else seg
    rep = [Replicate()] * rows.device_mesh.ndim
    v_pl = list(vals.placements) if sh.is_dtensor(vals) else rep
    s_pl = list(seg.placements) if sh.is_dtensor(seg) else rep
    if v_pl != s_pl:
        raise ValueError(f"segment_sum: values {v_pl} with segment ids "
                         f"{s_pl}")
    part = segment_sum(sh.local_shard(vals), sh.local_shard(seg).long(), n)
    return segment_total(part, rows, like)


def segment_total(part: torch.Tensor, rows, like=None):
    """The ranks' sums ``part`` (each rank's rows, laid out as the
    ``DTensor`` ``rows`` on dim 0, summed into all segments) summed over
    each mesh dim that splits the rows, keeping the rank's slice where
    ``like`` is split on its rows there (``sum_scatter``, outermost mesh
    dim first) or the whole (``psum``): a ``DTensor`` laid out as ``like``
    on its row dims (replicated without one).  ``rows`` plain: ``part``
    as it is."""
    if not sh.is_dtensor(rows):
        return part
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = rows.device_mesh
    o_pl = like.placements if like is not None \
        else [Replicate()] * mesh.ndim
    scatters, sums = [], []
    for i, (rp, op) in enumerate(zip(rows.placements, o_pl)):
        if rp not in (Replicate(), Shard(0)) \
                or op not in (Replicate(), Shard(0)) \
                or (rp == Replicate() and op == Shard(0)):
            raise ValueError(
                f"segment_sum: rows {rp} into an output {op} on mesh dim "
                f"{mesh.mesh_dim_names[i]}")
        if rp == Shard(0):
            (scatters if op == Shard(0) else sums).append(mesh.get_group(i))
    for g in scatters:
        part = sh.sum_scatter(part, 0, g, tag="segment-sum")
    part = sh.psum(part, sums, tag="segment-sum")
    return DTensor.from_local(part, mesh, list(o_pl), run_check=False)


class RowGrads:
    """The gradient of a table read by ``parts`` gathers (a chunked
    layer's: each chunk's source and destination rows): each gather's
    backward adds its rows' gradients into one set of f32 sums carried
    from gather to gather (``segment_sum(..., out=)``); the last of them
    to run returns the sums rounded once to the gradient's dtype, the
    others nothing.  Every gather that reads it must take part in the
    backward, once: a further gather's backward raises, and so does the
    backward of a table ``watch``ed while gathers are still owed."""

    def __init__(self, parts: int):
        self.parts = parts
        self.sums = None

    def add(self, grad, idx, rows, plan):
        if self.parts <= 0:
            raise RuntimeError("RowGrads: a gather's backward ran after the "
                               "table's gradient was handed back (a second "
                               "backward through the same graph?)")
        self.sums = segment_sum(grad, idx, rows, out=self.sums, plan=plan)
        self.parts -= 1
        if self.parts:
            return None
        sums, self.sums = self.sums, None
        return sums.to(grad.dtype)

    def watch(self, table: torch.Tensor) -> torch.Tensor:
        """``table``, whose gradient, once every reader's is in, fails
        unless all ``parts`` gathers handed theirs to the sums."""
        if table.requires_grad:
            table.register_hook(self._handed_back)
        return table

    def _handed_back(self, grad):
        if self.parts:
            raise RuntimeError(f"RowGrads: {self.parts} gathers of the "
                               f"table took no part in its backward")


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose gradient is ``segment_sum``:
    autograd's own (``index_add_``) adds with atomics on the card, in no
    fixed order."""

    @staticmethod
    def forward(ctx, table, idx, plan, grads):
        ctx.save_for_backward(idx)
        ctx.rows, ctx.plan, ctx.grads = table.shape[0], plan, grads
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        if ctx.grads is not None:
            return ctx.grads.add(grad, idx, ctx.rows, ctx.plan), None, \
                None, None
        return segment_sum(grad, idx, ctx.rows, plan=ctx.plan).to(
            grad.dtype), None, None, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor,
                dtype=None, *, plan=None,
                grads: Optional[RowGrads] = None) -> torch.Tensor:
    """Rows ``idx`` (any shape, any integer dtype) of ``table``: (*idx.shape,
    *table.shape[1:]), cast to ``dtype`` when given.  Its backward sums
    the rows' gradients in f32 in ``idx`` order (``segment_sum``, over
    ``plan``, ``segment_plan`` of the flat ids, when given) and rounds
    once to the gradient's dtype, the same bits on either device; with
    ``grads`` into the sums it carries (``RowGrads``).  ``DTensor``
    operands: the sharded lookup (module docstring)."""
    if sh.is_dtensor(table) or sh.is_dtensor(idx):
        return _sharded_rows(table, idx, dtype)
    flat = idx.reshape(-1).long()
    rows = _GatherRows.apply(table, flat, plan, grads) \
        if torch.is_grad_enabled() and table.requires_grad \
        else table.index_select(0, flat)
    rows = rows.reshape(*idx.shape, *table.shape[1:])
    return rows if dtype is None else rows.to(dtype)


def _sharded_rows(table, idx, dtype):
    """``gather_rows`` over a mesh: ``table`` replicated or sharded on its
    rows on each mesh dim, ``idx`` replicated, or sharded on any dim where
    the table is replicated or sharded on its rows.  Each rank looks up
    the ids in its row range (the ids gathered over the mesh dims that
    split both, innermost first), zeroes the rest and the ranks of each
    row-sharding mesh dim sum (exact): over a dim that splits the ids too,
    each keeps its slice of the ids' dim (outermost first)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (table if sh.is_dtensor(table) else idx).device_mesh
    t_pl = table.placements if sh.is_dtensor(table) \
        else [Replicate()] * mesh.ndim
    i_pl = idx.placements if sh.is_dtensor(idx) \
        else [Replicate()] * mesh.ndim
    out_pl, sums, splits = [], [], []
    for i, (tp, ip) in enumerate(zip(t_pl, i_pl)):
        if tp == Replicate():
            out_pl.append(ip)
        elif tp == Shard(0) and ip == Replicate():
            out_pl.append(Replicate())
            sums.append(mesh.get_group(i))
        elif tp == Shard(0) and isinstance(ip, Shard):
            out_pl.append(ip)
            splits.append((mesh.get_group(i), ip.dim))
        else:
            raise ValueError(f"gather_rows: a table {tp} with ids {ip} on "
                             f"mesh dim {mesh.mesh_dim_names[i]}")
    # training: the table's cotangent is the rank's rows' scatter-add
    # (``segment_sum``), complete where the table is split (the ids were
    # gathered, or replicated), summed over the mesh dims that split only
    # the ids in ``at_use``
    local = sh.param_local(table, idx, feature_last=False) \
        if sh.is_dtensor(idx) else sh.local_shard(table)
    ids = sh.local_shard(idx)
    for group, dim in reversed(splits):
        ids = sh.all_gather(ids, dim, group, tag="ids-gather")
    ids = ids.long()
    off, n = sh.shard_range(mesh, t_pl, 0, table.shape[0])
    mine = (ids >= off) & (ids < off + n)
    rows = gather_rows(local, torch.clamp(ids - off, 0, n - 1))
    rows = torch.where(mine.reshape(*ids.shape, *(1,) * (rows.ndim
                                                         - ids.ndim)),
                       rows, torch.zeros((), dtype=rows.dtype,
                                         device=rows.device))
    if dtype is not None:
        rows = rows.to(dtype)
    for group, dim in splits:
        rows = sh.sum_scatter(rows, dim, group, tag="rows-sum")
    rows = sh.psum(rows, sums, tag="embed-sum")
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def embed_lookup(params: dict, ids: torch.Tensor, *,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain gather of ``ids``' rows, cast to ``compute_dtype``."""
    return gather_rows(params["table"], ids, compute_dtype)


def _gather_f32(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return gather_rows(table, ids, torch.float32)


def embedding_bag(params: dict, ids: torch.Tensor,
                  offsets_or_segments: torch.Tensor, *, n_bags: int,
                  mode: str = "sum", weights: Optional[torch.Tensor] = None,
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """EmbeddingBag(sum|mean|max) over ragged id lists: ``ids`` (nnz,)
    rows of the table, ``offsets_or_segments`` (nnz,) the bag of each
    entry; optional per-entry ``weights``.  Returns (n_bags, dim)."""
    seg = offsets_or_segments.long()
    vecs = _gather_f32(params["table"], ids)
    if weights is not None:
        vecs = vecs * weights.to(torch.float32)[:, None]
    if mode == "sum":
        out = segment_sum(vecs, seg, n_bags)
    elif mode == "mean":
        cnt = segment_sum(torch.ones_like(seg, dtype=torch.float32), seg,
                          n_bags)
        out = segment_sum(vecs, seg, n_bags) \
            / torch.clamp(cnt, min=1.0)[:, None]
    elif mode == "max":
        out = _bag_max(vecs, seg, n_bags)
    else:
        raise ValueError(f"unknown mode {mode}")
    return out.to(compute_dtype)


def _bag_max(vecs, seg, n_bags):
    """The bags' elementwise max (0 for an empty bag); over a mesh the
    rank's rows' max, max-reduced over the mesh dims that split them (no
    backward there)."""
    local = sh.local_shard(vecs)
    out = local.new_full((n_bags, local.shape[-1]), -math.inf
                         ).scatter_reduce_(
        0, sh.local_shard(seg)[:, None].expand_as(local), local, "amax",
        include_self=False)
    if sh.is_dtensor(vecs):
        from torch.distributed.tensor import DTensor, Replicate
        if torch.is_grad_enabled() and vecs.requires_grad:
            raise ValueError("embedding_bag: mode 'max' over a mesh has no "
                             "backward")
        for g in sh.split_groups(vecs):
            sh.all_reduce(out, g, "max", tag="bag-max")
        out = DTensor.from_local(out, vecs.device_mesh,
                                 [Replicate()] * vecs.device_mesh.ndim,
                                 run_check=False)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def multi_hot_bag(params: dict, ids: torch.Tensor, *, mode: str = "sum",
                  pad_id: int = 0, compute_dtype=torch.bfloat16
                  ) -> torch.Tensor:
    """Fixed-width multi-hot lookup: ``ids`` (batch, n_per_bag), ``pad_id``
    entries empty (masked out of the reduction)."""
    vecs = _gather_f32(params["table"], ids)
    mask = (ids != pad_id).to(torch.float32)[..., None]
    vecs = vecs * mask
    if mode == "sum":
        out = vecs.sum(-2)
    elif mode == "mean":
        out = vecs.sum(-2) / torch.clamp(mask.sum(-2), min=1.0)
    elif mode == "max":
        out = torch.where(mask > 0, vecs, torch.full_like(vecs, -math.inf)
                          ).amax(-2)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        raise ValueError(f"unknown mode {mode}")
    return out.to(compute_dtype)
