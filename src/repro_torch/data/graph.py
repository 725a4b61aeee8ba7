"""Synthetic graph generation + a neighbor sampler (minibatch_lg), numpy
only: the same graphs and batches as ``repro/data/graph.py`` for the same
arguments and seeds.

``NeighborSampler`` does fanout-bounded uniform neighbor sampling from a
CSR adjacency (GraphSAGE-style), emitting padded fixed-shape subgraph
batches (the JAX dry-run's static shapes).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class SyntheticGraph:
    n_nodes: int
    edges: np.ndarray          # (E, 2) int32 [src, dst]
    feat: np.ndarray           # (N, d)
    coord: np.ndarray          # (N, 3)
    labels: np.ndarray         # (N,)
    indptr: np.ndarray         # CSR over dst -> incoming srcs
    indices: np.ndarray


def random_geometric_graph(n_nodes: int, avg_degree: int, d_feat: int,
                           n_classes: int = 16, seed: int = 0
                           ) -> SyntheticGraph:
    """Latent-cluster geometric graph: edges prefer same-cluster nodes, node
    labels = cluster id (so GNN training has real signal)."""
    rng = np.random.default_rng(seed)
    coord = rng.normal(size=(n_nodes, 3)).astype(np.float32)
    cluster = rng.integers(0, n_classes, size=n_nodes)
    coord += cluster[:, None] * 0.7
    n_edges = n_nodes * avg_degree
    # bias edges toward same-cluster pairs
    src = rng.integers(0, n_nodes, size=2 * n_edges)
    dst = rng.integers(0, n_nodes, size=2 * n_edges)
    same = cluster[src] == cluster[dst]
    keep = same | (rng.random(2 * n_edges) < 0.15)
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    edges = np.stack([src, dst], axis=1).astype(np.int32)
    feat = (np.eye(n_classes, dtype=np.float32)[cluster]
            @ rng.normal(size=(n_classes, d_feat)).astype(np.float32))
    feat += 0.5 * rng.normal(size=feat.shape).astype(np.float32)
    order = np.argsort(dst, kind="stable")
    sorted_dst = dst[order]
    indptr = np.searchsorted(sorted_dst, np.arange(n_nodes + 1)).astype(
        np.int64)
    return SyntheticGraph(n_nodes, edges, feat, coord,
                          cluster.astype(np.int32), indptr,
                          src[order].astype(np.int32))


def graph_batch(g: SyntheticGraph, pad_nodes: int = 0, pad_edges: int = 0
                ) -> dict:
    """Full-batch training dict (padded to the dry-run's static shapes)."""
    N, E = g.n_nodes, len(g.edges)
    pn = max(pad_nodes, N)
    pe = max(pad_edges, E)
    feat = np.zeros((pn, g.feat.shape[1]), np.float32)
    feat[:N] = g.feat
    coord = np.zeros((pn, 3), np.float32)
    coord[:N] = g.coord
    edges = np.full((pe, 2), pn - 1, np.int32)
    edges[:E] = g.edges
    edge_mask = np.zeros(pe, np.float32)
    edge_mask[:E] = 1
    node_mask = np.zeros(pn, np.float32)
    node_mask[:N] = 1
    labels = np.zeros(pn, np.int32)
    labels[:N] = g.labels
    return {"feat": feat, "coord": coord, "edges": edges,
            "edge_mask": edge_mask, "node_mask": node_mask,
            "labels": labels, "graph_ids": np.zeros(pn, np.int32)}


class NeighborSampler:
    """Uniform fanout-bounded neighbor sampling over CSR (GraphSAGE)."""

    def __init__(self, g: SyntheticGraph, fanout: Tuple[int, ...],
                 batch_nodes: int, seed: int = 0):
        self.g = g
        self.fanout = fanout
        self.batch_nodes = batch_nodes
        self.seed = seed

    def sample_at(self, step: int) -> dict:
        g = self.g
        rng = np.random.default_rng((self.seed, step, 0xA11CE))
        seeds = rng.integers(0, g.n_nodes, size=self.batch_nodes
                             ).astype(np.int32)
        all_nodes = [seeds]
        all_src, all_dst = [], []
        frontier = seeds
        for f in self.fanout:
            deg = g.indptr[frontier + 1] - g.indptr[frontier]
            # sample up to f incoming neighbors per frontier node
            offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                                size=(len(frontier), f))
            has = deg > 0
            src = g.indices[np.minimum(g.indptr[frontier][:, None] + offs,
                                       g.indptr[frontier + 1][:, None] - 1)]
            src = np.where(has[:, None], src, frontier[:, None])
            dst = np.broadcast_to(frontier[:, None], src.shape)
            all_src.append(src.ravel())
            all_dst.append(dst.ravel())
            frontier = src.ravel()
            all_nodes.append(frontier)
        # relabel to compact ids
        nodes = np.unique(np.concatenate(all_nodes))
        lookup = {n: i for i, n in enumerate(nodes)}
        remap = np.vectorize(lookup.get)
        src = remap(np.concatenate(all_src)).astype(np.int32)
        dst = remap(np.concatenate(all_dst)).astype(np.int32)
        n = len(nodes)
        e = len(src)
        # pad to the static shapes used by the dry-run cell
        seeds_n = self.batch_nodes
        n1 = seeds_n * self.fanout[0]
        n2 = n1 * (self.fanout[1] if len(self.fanout) > 1 else 0)
        pn = _pad2048(seeds_n + n1 + n2)
        pe = _pad2048(n1 + n2)
        feat = np.zeros((pn, g.feat.shape[1]), np.float32)
        feat[:n] = g.feat[nodes]
        coord = np.zeros((pn, 3), np.float32)
        coord[:n] = g.coord[nodes]
        edges = np.full((pe, 2), pn - 1, np.int32)
        edges[:e, 0] = src
        edges[:e, 1] = dst
        edge_mask = np.zeros(pe, np.float32)
        edge_mask[:e] = 1
        node_mask = np.zeros(pn, np.float32)
        node_mask[:seeds_n] = 1  # loss on seed nodes only
        labels = np.zeros(pn, np.int32)
        labels[:n] = g.labels[nodes]
        return {"feat": feat, "coord": coord, "edges": edges,
                "edge_mask": edge_mask, "node_mask": node_mask,
                "labels": labels, "graph_ids": np.zeros(pn, np.int32)}


def _pad2048(n: int, mult: int = 2048) -> int:
    if n < mult:
        return n
    return ((n + mult - 1) // mult) * mult


def molecule_batch(n_graphs: int, n_nodes: int, n_edges: int, d_feat: int,
                   n_classes: int = 16, seed: int = 0) -> dict:
    """Batched small graphs via block-diagonal edge offsets."""
    rng = np.random.default_rng(seed)
    N, E = n_graphs * n_nodes, n_graphs * n_edges
    feat = rng.normal(size=(N, d_feat)).astype(np.float32)
    coord = rng.normal(size=(N, 3)).astype(np.float32)
    offs = (np.arange(n_graphs) * n_nodes)[:, None]
    edges = (rng.integers(0, n_nodes, size=(n_graphs, n_edges, 2)) +
             offs[..., None]).reshape(E, 2).astype(np.int32)
    labels = rng.integers(0, n_classes, size=n_graphs).astype(np.int32)
    return {"feat": feat, "coord": coord, "edges": edges,
            "edge_mask": np.ones(E, np.float32),
            "node_mask": np.ones(N, np.float32), "labels": labels,
            "graph_ids": np.repeat(np.arange(n_graphs, dtype=np.int32),
                                   n_nodes)}
