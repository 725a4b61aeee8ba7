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
Under tensor parallelism ``gather_rows`` takes a ``DTensor`` table sharded
on its rows (the LMs' vocabulary, ``embed/table`` under ``INFER_RULES``):
each rank gathers the rows it holds, zeroes the others and the ranks sum,
which gives one rank's bits (one nonzero row and zeros).  Row sharding of
the recsys tables (``table_rows``) waits for ROADMAP.md queue N, item
N9e.5.
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


def segment_sum(vals: torch.Tensor, seg: torch.Tensor,
                n: int) -> torch.Tensor:
    """f32 sums of ``vals``' rows by segment id ``seg`` (int64) into ``n``
    rows (``jax.ops.segment_sum``), each segment summed in row order."""
    vals = vals.to(torch.float32)
    if vals.device.type == "cpu":
        return vals.new_zeros((n, *vals.shape[1:])).index_add_(0, seg, vals)
    order = torch.argsort(seg, stable=True)
    lengths = torch.zeros(n, dtype=torch.int64, device=seg.device
                          ).index_add_(0, seg, torch.ones_like(order))
    return torch.segment_reduce(vals.index_select(0, order), "sum",
                                lengths=lengths, axis=0, unsafe=True)


class _GatherRows(torch.autograd.Function):
    """``table.index_select(0, idx)`` whose gradient is ``segment_sum``:
    autograd's own (``index_add_``) adds with atomics on the card, in no
    fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return segment_sum(grad, idx, ctx.rows).to(grad.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``idx`` (any shape, any integer dtype) of ``table``: (*idx.shape,
    *table.shape[1:]).  Its backward sums the rows' gradients in f32 in
    ``idx`` order (``segment_sum``) and rounds once to the gradient's
    dtype, the same bits on either device.  ``DTensor`` operands: the
    vocabulary-parallel lookup (module docstring)."""
    if sh.is_dtensor(table) or sh.is_dtensor(idx):
        return _sharded_rows(table, idx)
    flat = idx.reshape(-1).long()
    rows = _GatherRows.apply(table, flat) if torch.is_grad_enabled() \
        and table.requires_grad else table.index_select(0, flat)
    return rows.reshape(*idx.shape, *table.shape[1:])


def _sharded_rows(table, idx):
    """``gather_rows`` over a mesh: ``table`` replicated or sharded on its
    rows, ``idx`` replicated or sharded on any dim where the table is
    replicated.  Each rank gathers the ids in its row range, zeroes the
    rest and the ranks of each row-sharding mesh dim sum (exact)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (table if sh.is_dtensor(table) else idx).device_mesh
    t_pl = table.placements if sh.is_dtensor(table) \
        else [Replicate()] * mesh.ndim
    i_pl = idx.placements if sh.is_dtensor(idx) \
        else [Replicate()] * mesh.ndim
    out_pl, groups = [], []
    for i, (tp, ip) in enumerate(zip(t_pl, i_pl)):
        if tp == Replicate():
            out_pl.append(ip)
        elif tp == Shard(0) and ip == Replicate():
            out_pl.append(Replicate())
            groups.append(mesh.get_group(i))
        else:
            raise ValueError(f"gather_rows: a table {tp} with ids {ip} on "
                             f"mesh dim {mesh.mesh_dim_names[i]}")
    # training: the table's cotangent is the rank's rows' scatter-add
    # (``segment_sum``), summed over the id-split mesh dims in ``at_use``
    local = sh.param_local(table, idx, feature_last=False) \
        if sh.is_dtensor(idx) else sh.local_shard(table)
    ids = sh.local_shard(idx).long()
    off, n = sh.shard_range(mesh, t_pl, 0, table.shape[0])
    mine = (ids >= off) & (ids < off + n)
    rows = gather_rows(local, torch.clamp(ids - off, 0, n - 1))
    rows = torch.where(mine.reshape(*ids.shape, *(1,) * (rows.ndim
                                                         - ids.ndim)),
                       rows, torch.zeros((), dtype=rows.dtype,
                                         device=rows.device))
    rows = sh.psum(rows, groups, tag="embed-sum")
    return DTensor.from_local(rows, mesh, out_pl, run_check=False)


def embed_lookup(params: dict, ids: torch.Tensor, *,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain gather of ``ids``' rows, cast to ``compute_dtype``."""
    return gather_rows(params["table"], ids).to(compute_dtype)


def _gather_f32(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return gather_rows(table, ids).to(torch.float32)


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
        out = vecs.new_full((n_bags, vecs.shape[-1]), -math.inf
                            ).scatter_reduce_(
            0, seg[:, None].expand_as(vecs), vecs, "amax",
            include_self=False)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        raise ValueError(f"unknown mode {mode}")
    return out.to(compute_dtype)


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
