"""EGNN: E(n)-equivariant graph network [arXiv:2102.09844], the JAX
package's ``repro/models/gnn.py`` in PyTorch: the forward and the training
loss (``launch/steps.py``'s graph bundles take its gradient).

Message passing is edge-index gathers (``gather_rows``) and segment sums
(``layers.embedding.segment_sum`` over f32 rows, in a fixed order on
either device): the JAX package builds it from ``jnp.take``
and ``jax.ops.segment_sum``, XLA ops with no Pallas kernel.  The paper's
FP8 scheme is inapplicable to this family (64-wide MLPs, a numerically
sensitive coordinate update), so it runs unquantized, in bf16 with f32
coordinates.

The edges' work runs over contiguous chunks of at most ``edge_chunk``
edges (``EDGE_CHUNK`` by default): each chunk's gathers, ``dx`` and
``d2``, edge and coordinate MLPs, and its rows of the ``deg``, ``upd``
and ``agg`` sums, added into node-sized f32 sums carried from chunk to
chunk (``segment_sum(..., out=)``, ``layers/embedding.py``); the node
work (the coordinate update, the node MLP) runs once on the carried sums.
With more than one chunk each chunk's edge work is recomputed in the
backward (``torch.utils.checkpoint``, non-reentrant: its outputs go
straight into the sums, whose transposes keep no rows, so no edge-sized
tensor outlives its chunk), and the gathers' backward carries its f32
sums across the chunks (``RowGrads``); the card's sorts of each chunk's
ids are made once a forward and read by every layer (``segment_plan``).
A graph whose edges fit in one chunk runs each op as one pass does.

Over a mesh (the graph step's arguments laid out by
``launch.steps.shard_args`` under ``TRAIN_RULES``: nodes and edges both
split over ``(data, model)``) the params go through ``sharding.at_use``
(replicated: their gradients are summed over every rank), the node
features and coordinates a layer reads are gathered whole once for all
of the edges' lookups (``_node_rows``: N rows a layer, where gathering the
ids and summing the looked-up rows would move 2 E; every EGNN cell has
N <= 2 E), the edges' work runs on the rank's own edges (chunked as
above; the edge MLPs' weights are local, ``sharding.param_local``), their
sums into the nodes are summed over the ranks into the rank's node shard
once a layer (``embedding.segment_total``), and the graph readout and the
loss's masked means are summed over the node shards.

Input contract (padded, static shapes):
  batch = {
    "feat":   (N, d_feat) node features,
    "coord":  (N, 3)      positions,
    "edges":  (E, 2)      int32 [src, dst]; padding edges = [N-1, N-1] with
    "edge_mask": (E,)     0/1,
    "node_mask": (N,)     0/1,
    "labels": (N,) or (B,) int32 (node- or graph-level),
    "graph_ids": (N,) int32 (for batched small graphs; else zeros),
  }
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch import tree as tree_util
from repro_torch.configs.base import GNNConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.common import mlp_stack_apply, mlp_stack_init, split
from repro_torch.layers.embedding import (RowGrads, gather_rows,
                                          segment_plan, segment_sum,
                                          segment_total)

# Edges a chunk of the message passing.  A chunk's edge work at d 64 holds
# ~1.7 KB an edge at the step's peak (its backward recomputing it: the
# gathered rows, the edge MLPs' activations and cotangents, the f32 rows
# summed), ~7 GB at 2^22 edges; ogb_products (2.45 M nodes, 61.86 M
# edges, 4 layers) keeps ~13 GiB of node-sized activations, ids and sorts
# beside it: a 19.8 GiB peak of an 80 GB card (an H100; PERF.md).
EDGE_CHUNK = 1 << 22


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / (1.0 + torch.exp(-x))


class _Silu(torch.autograd.Function):
    """``x * logistic(x)`` with JAX's derivative: the cotangent ``ct`` gives
    ``ct * s + (ct * x) * (s * (1 - s))`` (``logistic``'s JVP rule), each
    product rounded in x's dtype.  Autograd through the spelled-out steps
    would multiply ``exp(-x)``'s overflow (inf) by 0 below x = -88: NaN."""

    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(x, s)
        return x * s

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        return ct * s + (ct * x) * (s * (1 - s))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in x's dtype: XLA computes a bf16 ``logistic`` as
    ``1 / (1 + exp(-x))`` rounding each step to bf16 (a third of
    ``torch.sigmoid``'s bf16 results differ from it by an ulp), so the
    steps are spelled out; its gradient is JAX's (``_Silu``)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Silu.apply(x)
    return x * _logistic(x)


def init_egnn(gen: torch.Generator, cfg: GNNConfig, d_feat: int,
              n_classes: int, dtype=torch.float32, device=None) -> dict:
    d = cfg.d_hidden
    kw = dict(dtype=dtype, device=device)
    params = {
        "encoder": {"tower": mlp_stack_init(split(gen), (d_feat, d), **kw)},
        "layers": {},
        "head": {"tower": mlp_stack_init(split(gen), (d, d, n_classes),
                                         **kw)},
    }
    for i in range(cfg.n_layers):
        params["layers"][str(i)] = {
            # phi_e(h_i, h_j, ||dx||^2) -> message
            "edge_mlp": {"tower": mlp_stack_init(
                split(gen), (2 * d + 1, d, d), **kw)},
            # phi_x(m_ij) -> scalar coordinate weight (kept f32: equivariance)
            "coord_mlp": {"tower": mlp_stack_init(
                split(gen), (d, d, 1), **kw)},
            # phi_h(h_i, m_i) -> update
            "node_mlp": {"tower": mlp_stack_init(
                split(gen), (2 * d, d, d), **kw)},
        }
    return params


def _node_rows(t: torch.Tensor, edges) -> torch.Tensor:
    """Node rows ``t`` as the rank's edges index them: ``t`` itself, or
    over a mesh (``edges`` a ``DTensor``) the local shard gathered whole
    over each mesh dim that splits both (``sharding.gather``, whose
    transpose sums each node's cotangent over the ranks whose edges read
    it); nodes split where the edges are not raise."""
    if not sh.is_dtensor(t):
        return t
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    whole = t.to_local()
    for i in reversed(range(mesh.ndim)):
        tp = t.placements[i]
        if tp == Shard(0) and edges.placements[i] == Shard(0):
            whole = sh.gather(whole, 0, mesh.get_group(i), tag="node-gather")
        elif tp.is_shard():
            raise ValueError(f"edge rows: nodes {tp} with edges "
                             f"{edges.placements[i]} on mesh dim "
                             f"{mesh.mesh_dim_names[i]}")
    return whole


def _edge_rows(t: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *,
               plans=(None, None), grads: Optional[RowGrads] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t[src], t[dst])`` of plain tensors; ``plans`` the card's sorts
    of ``src`` and ``dst``, ``grads`` the table's carried gradient."""
    return (gather_rows(t, src, plan=plans[0], grads=grads),
            gather_rows(t, dst, plan=plans[1], grads=grads))


@dataclasses.dataclass
class _Chunk:
    """A contiguous run of the rank's edges: ids, mask, and the card's
    sorts of both ids (``segment_plan``; the sources' only under
    autograd, for the gathers' backward)."""
    src: torch.Tensor
    dst: torch.Tensor
    mask: torch.Tensor
    src_plan: object
    dst_plan: object


def edge_chunks(n_edges: int, edge_chunk: int = EDGE_CHUNK) -> int:
    """Chunks a layer runs over ``n_edges`` edges (a rank's own)."""
    return max(1, -(-n_edges // edge_chunk))


def _cut_edges(src, dst, mask, n_nodes: int, edge_chunk: int
               ) -> List[_Chunk]:
    """The rank's edges cut into chunks, once a forward for every
    layer."""
    src, dst, mask = (sh.local_shard(t) for t in (src, dst, mask))
    grad = torch.is_grad_enabled()
    chunks = []
    for a in range(0, max(src.shape[0], 1), edge_chunk):
        s, d = src[a:a + edge_chunk], dst[a:a + edge_chunk]
        chunks.append(_Chunk(s, d, mask[a:a + edge_chunk],
                             segment_plan(s, n_nodes) if grad else None,
                             segment_plan(d, n_nodes)))
    return chunks


def _edge_messages(lp, h, x, src, dst, mask, plans, grads):
    """One chunk's edge work on plain tensors (whole node rows ``h`` and
    ``x``): the messages ``m`` and the coordinate updates ``upd``."""
    h_src, h_dst = _edge_rows(h, src, dst, plans=plans, grads=grads[0])
    x_src, x_dst = _edge_rows(x, src, dst, plans=plans, grads=grads[1])
    dx = x_src - x_dst                                        # (E, 3) f32
    d2 = torch.sum(torch.square(dx), dim=-1, keepdim=True)

    m = mlp_stack_apply(lp["edge_mlp"]["tower"],
                        torch.cat([h_src, h_dst, d2.to(h.dtype)], dim=-1),
                        act=silu, final_act=True)
    m = m * mask[:, None].to(m.dtype)

    # equivariant coordinate update (f32; tanh-clipped per EGNN stability)
    w = torch.tanh(mlp_stack_apply(lp["coord_mlp"]["tower"], m,
                                   act=silu).to(torch.float32))
    upd = dx * w * mask[:, None].to(torch.float32)
    return m, upd


def _egnn_layer(lp: dict, h: torch.Tensor, x: torch.Tensor,
                chunks: List[_Chunk], edges, n_nodes: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer over the rank's edge ``chunks``; ``edges`` the edges'
    ``DTensor`` layout over a mesh, else a plain tensor."""
    hw, xw = _node_rows(h, edges), _node_rows(x, edges)
    ep = {k: lp[k] for k in ("edge_mlp", "coord_mlp")}
    if sh.is_dtensor(edges):
        ep = tree_util.map_with_path(lambda _, w: sh.param_local(
            w, edges, feature_last=False), ep)
    several = len(chunks) > 1 and torch.is_grad_enabled()
    grads = (None, None)
    if several:
        grads = (RowGrads(2 * len(chunks)), RowGrads(2 * len(chunks)))
        hw, xw = grads[0].watch(hw), grads[1].watch(xw)
    deg = upd = agg = None
    for c in chunks:
        args = (ep, hw, xw, c.src, c.dst, c.mask, (c.src_plan, c.dst_plan),
                grads)
        m, u = torch.utils.checkpoint.checkpoint(
            _edge_messages, *args, use_reentrant=False,
            preserve_rng_state=False) if several else _edge_messages(*args)
        deg = segment_sum(c.mask, c.dst, n_nodes, out=deg, plan=c.dst_plan)
        upd = segment_sum(u, c.dst, n_nodes, out=upd, plan=c.dst_plan)
        agg = segment_sum(m, c.dst, n_nodes, out=agg, plan=c.dst_plan)
        del m, u                    # freed before the next chunk's are made
    deg = segment_total(deg, edges, like=x)
    x = x + segment_total(upd, edges, like=x) \
        / torch.clamp(deg, min=1.0)[:, None]

    agg = segment_total(agg, edges, like=h).to(h.dtype)
    agg = constrain(agg, ("nodes", None))
    h = h + mlp_stack_apply(lp["node_mlp"]["tower"],
                            torch.cat([h, agg], dim=-1), act=silu)
    return h, x


def equivariance_error(params: dict, batch: Dict[str, torch.Tensor],
                       cfg: GNNConfig, gen: torch.Generator) -> Tuple[
                           float, float]:
    """The forward's E(3) equivariance on ``batch``: a random rotation
    (an orthogonal 3 x 3 from ``gen``, a reflection allowed) and
    translation of the input coordinates must move the output coordinates
    the same way and leave the node embeddings as they are.  Returns (max
    |x' - (x R + t)| over max |x|, max |h' - h| over max |h|)."""
    dev = batch["coord"].device
    rot, _ = torch.linalg.qr(torch.randn((3, 3), generator=gen,
                                         device=gen.device).to(dev))
    shift = torch.randn((1, 3), generator=gen, device=gen.device).to(dev)
    h, x = egnn_forward(params, batch, cfg)
    moved = dict(batch, coord=batch["coord"].to(torch.float32) @ rot + shift)
    h2, x2 = egnn_forward(params, moved, cfg)
    err_x = (x2 - (x @ rot + shift)).abs().max() / x.abs().max()
    err_h = (h2.float() - h.float()).abs().max() / h.float().abs().max()
    # a diagnostic's two numbers, read once a call: not a serving path
    return err_x.item(), err_h.item()  # lint: allow[hidden-host-sync]


def egnn_forward(params: dict, batch: Dict[str, torch.Tensor],
                 cfg: GNNConfig, compute_dtype=torch.bfloat16,
                 edge_chunk: int = EDGE_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (node embeddings (N, d), coords (N, 3) f32); the edges' work in
    chunks of at most ``edge_chunk`` of the rank's edges."""
    params = sh.at_use_tree(params)
    n_nodes = batch["feat"].shape[0]
    h = mlp_stack_apply(params["encoder"]["tower"],
                        batch["feat"].to(compute_dtype))
    h = constrain(h, ("nodes", None))
    x = batch["coord"].to(torch.float32)
    edges = batch["edges"]
    src, dst = edges[:, 0].long(), edges[:, 1].long()
    edge_mask = batch.get("edge_mask")
    if edge_mask is None:
        edge_mask = sh.local_call(lambda e: torch.ones(
            e.shape[0], dtype=torch.float32, device=e.device), src)
    chunks = _cut_edges(src, dst, edge_mask, n_nodes, edge_chunk)
    for i in range(cfg.n_layers):
        h, x = _egnn_layer(params["layers"][str(i)], h, x, chunks, src,
                           n_nodes)
    return h, x


def node_logits(params: dict, batch, cfg: GNNConfig,
                edge_chunk: int = EDGE_CHUNK) -> torch.Tensor:
    h, _ = egnn_forward(params, batch, cfg, edge_chunk=edge_chunk)
    return mlp_stack_apply(sh.at_use_tree(params["head"])["tower"], h,
                           act=silu).to(torch.float32)


def graph_logits(params: dict, batch, cfg: GNNConfig,
                 n_graphs: int, edge_chunk: int = EDGE_CHUNK
                 ) -> torch.Tensor:
    """Mean-pooled graph-level readout (batched small molecules); over a
    mesh each rank pools its nodes and the ranks sum (replicated)."""
    h, _ = egnn_forward(params, batch, cfg, edge_chunk=edge_chunk)
    mask = batch["node_mask"].to(torch.float32)
    gids = batch["graph_ids"].long()
    pooled = segment_sum(h.to(torch.float32) * mask[:, None], gids,
                         n_graphs)
    cnt = segment_sum(mask, gids, n_graphs)
    pooled = (pooled / torch.clamp(cnt, min=1.0)[:, None]).to(h.dtype)
    return mlp_stack_apply(sh.at_use_tree(params["head"])["tower"], pooled,
                           act=silu).to(torch.float32)


def train_loss(params: dict, batch, cfg: GNNConfig, *,
               level: str = "node", n_graphs: int = 0,
               edge_chunk: int = EDGE_CHUNK) -> torch.Tensor:
    """Masked mean cross entropy of node logits, or of graph logits
    (``level="graph"``, ``n_graphs`` mean-pooled graphs); over a mesh on
    each rank's rows, the masked sum and the count summed over the mesh
    dims that split them.  ``edge_chunk``: the message passing's chunk
    of edges (module docstring)."""
    if level == "graph":
        logits = graph_logits(params, batch, cfg, n_graphs,
                              edge_chunk=edge_chunk)
        mask = torch.ones(n_graphs, dtype=torch.float32,
                          device=logits.device)
    else:
        logits = node_logits(params, batch, cfg, edge_chunk=edge_chunk)
        mask = sh.local_shard(batch["node_mask"]).to(torch.float32)
    groups = sh.split_groups(logits)
    logp = sh.local_shard(torch.log_softmax(logits, dim=-1))
    labels = torch.clamp(sh.local_shard(batch["labels"]).long(), min=0)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return sh.psum(torch.sum(nll * mask), groups, tag="loss-sum") \
        / torch.clamp(sh.psum(torch.sum(mask), groups, tag="loss-sum"),
                      min=1.0)
