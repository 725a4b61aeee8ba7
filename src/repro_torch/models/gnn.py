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

Over a mesh (the graph step's arguments laid out by
``launch.steps.shard_args`` under ``TRAIN_RULES``: nodes and edges both
split over ``(data, model)``) the params go through ``sharding.at_use``
(replicated: their gradients are summed over every rank), the node
features and coordinates a layer reads are gathered whole once for both
of the edges' lookups (``_edge_rows``: N rows a layer, where gathering the
ids and summing the looked-up rows would move 2 E; every EGNN cell has
N <= 2 E), the edges' sums into
the nodes run on each rank's edges and are summed into the rank's node
shard (``segment_sum(..., like=...)``), and the graph readout and the
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

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.layers.common import mlp_stack_apply, mlp_stack_init, split
from repro_torch.layers.embedding import gather_rows, segment_sum


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


def _edge_rows(t: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(t[src], t[dst])``.  Over a mesh ``t`` (nodes) is gathered whole
    once for both lookups (``sharding.gather``, whose transpose sums each
    node's cotangent over the ranks whose edges read it) and each rank
    looks its edges up in it; nodes split where the edges are not raise."""
    if not sh.is_dtensor(t):
        return gather_rows(t, src), gather_rows(t, dst)
    from torch.distributed.tensor import DTensor, Shard
    mesh = t.device_mesh
    whole = t.to_local()
    for i in reversed(range(mesh.ndim)):
        tp = t.placements[i]
        if tp == Shard(0) and src.placements[i] == Shard(0):
            whole = sh.gather(whole, 0, mesh.get_group(i), tag="node-gather")
        elif tp.is_shard():
            raise ValueError(f"edge rows: nodes {tp} with edges "
                             f"{src.placements[i]} on mesh dim "
                             f"{mesh.mesh_dim_names[i]}")

    def rows(ids):
        return DTensor.from_local(gather_rows(whole, ids.to_local()), mesh,
                                  ids.placements, run_check=False)
    return rows(src), rows(dst)


def _egnn_layer(lp: dict, h: torch.Tensor, x: torch.Tensor,
                src: torch.Tensor, dst: torch.Tensor,
                edge_mask: torch.Tensor, n_nodes: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    h_src, h_dst = _edge_rows(h, src, dst)
    x_src, x_dst = _edge_rows(x, src, dst)
    dx = x_src - x_dst                                        # (E, 3) f32
    d2 = torch.sum(torch.square(dx), dim=-1, keepdim=True)

    m = mlp_stack_apply(lp["edge_mlp"]["tower"],
                        torch.cat([h_src, h_dst, d2.to(h.dtype)], dim=-1),
                        act=silu, final_act=True)
    m = m * edge_mask[:, None].to(m.dtype)

    # equivariant coordinate update (f32; tanh-clipped per EGNN stability)
    w = torch.tanh(mlp_stack_apply(lp["coord_mlp"]["tower"], m,
                                   act=silu).to(torch.float32))
    upd = dx * w * edge_mask[:, None].to(torch.float32)
    deg = segment_sum(edge_mask, dst, n_nodes, like=x)
    x = x + segment_sum(upd, dst, n_nodes, like=x) \
        / torch.clamp(deg, min=1.0)[:, None]

    agg = segment_sum(m, dst, n_nodes, like=h).to(h.dtype)
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
                 cfg: GNNConfig, compute_dtype=torch.bfloat16
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (node embeddings (N, d), coords (N, 3) f32)."""
    params = sh.at_use_tree(params)
    n_nodes = batch["feat"].shape[0]
    h = mlp_stack_apply(params["encoder"]["tower"],
                        batch["feat"].to(compute_dtype))
    h = constrain(h, ("nodes", None))
    x = batch["coord"].to(torch.float32)
    edges = batch["edges"].long()
    src, dst = edges[:, 0], edges[:, 1]
    edge_mask = batch.get("edge_mask")
    if edge_mask is None:
        edge_mask = sh.local_call(lambda e: torch.ones(
            e.shape[0], dtype=torch.float32, device=e.device), src)
    for i in range(cfg.n_layers):
        h, x = _egnn_layer(params["layers"][str(i)], h, x, src, dst,
                           edge_mask, n_nodes)
    return h, x


def node_logits(params: dict, batch, cfg: GNNConfig) -> torch.Tensor:
    h, _ = egnn_forward(params, batch, cfg)
    return mlp_stack_apply(sh.at_use_tree(params["head"])["tower"], h,
                           act=silu).to(torch.float32)


def graph_logits(params: dict, batch, cfg: GNNConfig,
                 n_graphs: int) -> torch.Tensor:
    """Mean-pooled graph-level readout (batched small molecules); over a
    mesh each rank pools its nodes and the ranks sum (replicated)."""
    h, _ = egnn_forward(params, batch, cfg)
    mask = batch["node_mask"].to(torch.float32)
    gids = batch["graph_ids"].long()
    pooled = segment_sum(h.to(torch.float32) * mask[:, None], gids,
                         n_graphs)
    cnt = segment_sum(mask, gids, n_graphs)
    pooled = (pooled / torch.clamp(cnt, min=1.0)[:, None]).to(h.dtype)
    return mlp_stack_apply(sh.at_use_tree(params["head"])["tower"], pooled,
                           act=silu).to(torch.float32)


def train_loss(params: dict, batch, cfg: GNNConfig, *,
               level: str = "node", n_graphs: int = 0) -> torch.Tensor:
    """Masked mean cross entropy of node logits, or of graph logits
    (``level="graph"``, ``n_graphs`` mean-pooled graphs); over a mesh on
    each rank's rows, the masked sum and the count summed over the mesh
    dims that split them."""
    if level == "graph":
        logits = graph_logits(params, batch, cfg, n_graphs)
        mask = torch.ones(n_graphs, dtype=torch.float32,
                          device=logits.device)
    else:
        logits = node_logits(params, batch, cfg)
        mask = sh.local_shard(batch["node_mask"]).to(torch.float32)
    groups = sh.split_groups(logits)
    logp = sh.local_shard(torch.log_softmax(logits, dim=-1))
    labels = torch.clamp(sh.local_shard(batch["labels"]).long(), min=0)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return sh.psum(torch.sum(nll * mask), groups, tag="loss-sum") \
        / torch.clamp(sh.psum(torch.sum(mask), groups, tag="loss-sum"),
                      min=1.0)
