"""The EGNN's message passing in edge chunks (ROADMAP.md queue N, item
N9e.7) on the CPU: each layer's edge work over contiguous chunks of the
edges, its sums into the nodes carried in f32 from chunk to chunk, each
chunk's edge work recomputed in the backward.

* Forced to 256-edge chunks (10 or 11 a layer), the training loss and its
  gradient against the JAX package's ``train_loss`` op by op, at
  ``reduced_config()`` and at the published width (4 layers, d 64), on a
  geometric graph of 2583 edges (node level) and 64 molecules of 40 edges
  (graph level), and the port's one-pass step beside it: each >= 2-D
  gradient leaf within ``test_torch_train_models.py``'s 1e-2 relative L2
  (``_torch_parity.GRAD_REL_L2``; measured <= 6.9e-3).  Its loss (1e-5)
  and 1-D vector (1e-2) tolerances do not hold on graphs of this size for
  the one-pass step either: a bf16 rounding of h that flips now and then
  (the products' f32 sums in another order than XLA's) runs on through
  the layers, more often with more nodes (measured, one pass and chunked
  alike: loss 6.36e-5 at the published width, node level; 1-D 1.10e-2,
  reduced, graph level).  Both are held to ``JAX_LOSS_REL`` (1e-4) and
  ``JAX_1D_REL_L2`` (1.5e-2), fixed from those floors; the chunked step
  is also held to the one-pass step's own gap on the same graph: the same
  loss gap, and a 1-D gap at most ``CHUNK_1D_SLACK`` (1e-3) above it
  (measured at most 3.8e-4 above: 3.83e-3 against 3.45e-3, published
  width, node level).
* Chunked against one chunk in the port: ``index_add_`` adds each row in
  index order, so the carried sums give the forward's bits (node
  embeddings, coordinates, loss: asserted equal).  The gradients differ:
  the gathers' backward adds a node's source and destination rows of
  every chunk in one f32 sum, rounded once, where one chunk rounds each
  gather's sum to bf16 and adds them; relative L2 within
  ``CHUNK_GRAD_REL_L2`` (5e-2, ~5x the measured worst, 7.3e-3 at the
  published width, graph level).
* ``RowGrads`` hands the table's gradient back once: a second backward,
  or a gather that took no part, raises.
* No float tensor of a chunk's edges is kept for the backward outside
  the recomputed region (only ids): no edge-sized activation outlives its
  chunk.
* ``ogb_products``: the abstract bundle's shapes on ``meta``, and the
  concrete bundle at a thousandth of its nodes and edges on the CPU,
  stepped in chunks and as one chunk: the same loss.
"""

import dataclasses

import pytest
import torch

from _torch_parity import (GRAD_REL_L2, assert_takes_a_step, chunk_batches,
                           egnn_chunked_grads, egnn_params, grad_deviation)
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.layers.embedding import RowGrads, gather_rows
from repro_torch.models import gnn

CHUNK = 256
CHUNK_GRAD_REL_L2 = 5e-2
JAX_LOSS_REL = 1e-4
JAX_1D_REL_L2 = 1.5e-2
CHUNK_1D_SLACK = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small eager ops, many of them (a chunk's): torch's thread pool only
    adds contention under the six test workers' load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("which", ["reduced", "CONFIG"])
@pytest.mark.parametrize("level", ["node", "graph"])
def test_chunked_step_matches_jax(which, level):
    theirs, ours = egnn_chunked_grads(which, level,
                                      (CHUNK, gnn.EDGE_CHUNK))
    gaps = {chunk: grad_deviation(got, theirs) for chunk, got in ours.items()}
    for chunk, (loss_rel, rel, rel_1d) in gaps.items():
        worst = max(rel, key=rel.get)
        assert loss_rel <= JAX_LOSS_REL, (chunk, loss_rel)
        assert rel[worst] <= GRAD_REL_L2, (chunk, worst, rel[worst])
        assert rel_1d <= JAX_1D_REL_L2, (chunk, rel_1d)
    # chunking uses up none of the looser bounds: its gap to JAX is the
    # one-pass step's
    (c_loss, _, c_1d), (o_loss, _, o_1d) = gaps[CHUNK], gaps[gnn.EDGE_CHUNK]
    assert c_loss == o_loss, (c_loss, o_loss)
    assert c_1d <= o_1d + CHUNK_1D_SLACK, (c_1d, o_1d)


def _cfg(which):
    mod = registry.get_arch("egnn")
    return mod.CONFIG if which == "CONFIG" else mod.reduced_config()


def _run(which, level, edge_chunk):
    """(h, x, loss, grads) of the port at ``edge_chunk``."""
    cfg = _cfg(which)
    batch = {k: torch.from_numpy(v)
             for k, v in chunk_batches()[level].items()}
    _, params = egnn_params(which, batch["feat"].shape[1])
    n_graphs = len(batch["labels"]) if level == "graph" else 0
    h, x = gnn.egnn_forward(params, batch, cfg, edge_chunk=edge_chunk)
    loss, grads = tree.value_and_grad(
        gnn.train_loss, params, batch, cfg, level=level, n_graphs=n_graphs,
        edge_chunk=edge_chunk)
    return h, x, loss, grads


@pytest.mark.parametrize("which", ["reduced", "CONFIG"])
@pytest.mark.parametrize("level", ["node", "graph"])
def test_chunked_matches_one_chunk(which, level):
    n_edges = chunk_batches()[level]["edges"].shape[0]
    assert gnn.edge_chunks(n_edges, CHUNK) >= 10
    assert gnn.edge_chunks(n_edges) == 1
    one, chunked = _run(which, level, gnn.EDGE_CHUNK), _run(which, level,
                                                            CHUNK)
    for a, b in zip(one[:3], chunked[:3]):
        assert torch.equal(a, b)
    for (path, a), (_, b) in zip(tree.leaves_with_path(one[3]),
                                 tree.leaves_with_path(chunked[3])):
        rel = float((b.double() - a.double()).norm()
                    / a.double().norm().clamp(min=1e-30))
        assert rel <= CHUNK_GRAD_REL_L2, (path, rel)


@pytest.mark.parametrize("fault", ["none", "second_backward",
                                   "gather_missing"])
def test_row_grads_are_handed_back_once(fault):
    """``RowGrads`` of two gathers: the table's gradient is the rows'
    f32 sum; a second backward through the same graph, or a gather owed
    that took no part, raises instead of leaving the gradient short."""
    table = torch.randn((6, 3), generator=torch.Generator().manual_seed(0),
                        requires_grad=True)
    ids = (torch.tensor([0, 2, 2, 5]), torch.tensor([1, 2, 0]))
    grads = RowGrads(3 if fault == "gather_missing" else 2)
    t = grads.watch(table)
    rows = [gather_rows(t, i, grads=grads) for i in ids]
    loss = sum((r * (k + 1)).sum() for k, r in enumerate(rows))
    if fault == "gather_missing":
        with pytest.raises(RuntimeError, match="took no part"):
            loss.backward()
        return
    loss.backward(retain_graph=True)
    want = torch.zeros(6, 3).index_add_(0, ids[0], torch.ones(4, 3)) \
        .index_add_(0, ids[1], torch.full((3, 3), 2.0))
    assert torch.equal(table.grad, want)
    if fault == "second_backward":
        with pytest.raises(RuntimeError, match="handed back"):
            loss.backward()


@pytest.mark.parametrize("edge_chunk", [CHUNK, gnn.EDGE_CHUNK])
def test_no_edge_rows_kept_for_the_backward(edge_chunk):
    """What autograd keeps for the backward outside the recomputed
    region: with chunks, of each chunk's edges only their ids and views
    of the batch (the sums' and gathers' transposes read nothing else,
    the recomputation its inputs); as one chunk, the edge MLPs'
    activations too (the check sees them)."""
    cfg = _cfg("reduced")
    batch = {k: torch.from_numpy(v)
             for k, v in chunk_batches()["node"].items()}
    _, params = egnn_params("reduced", batch["feat"].shape[1])
    sizes = {CHUNK, batch["edges"].shape[0]}
    inputs = {t.untyped_storage().data_ptr() for t in batch.values()}
    kept = []

    def pack(t):
        if t.ndim and t.shape[0] in sizes and t.is_floating_point() \
                and t.untyped_storage().data_ptr() not in inputs:
            kept.append(tuple(t.shape))
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tree.value_and_grad(gnn.train_loss, params, batch, cfg,
                            edge_chunk=edge_chunk)
    assert (kept == []) == (edge_chunk == CHUNK), kept[:5]


def test_ogb_products_bundle_in_chunks():
    """The abstract bundle holds the cell's padded graph on ``meta``; the
    concrete one at a thousandth of its nodes and edges (4096 nodes,
    63488 edges: 8 chunks of 8192) takes a step on the CPU whose loss is
    the one-chunk step's."""
    spec = registry.get_arch("egnn").SHAPES["ogb_products"]
    a = steps.build_bundle("egnn", "ogb_products", abstract=True)
    assert a.args[2]["feat"].shape == (2_449_408, 100)
    assert a.args[2]["edges"].shape == (61_859_840, 2)
    assert a.args[2]["feat"].device.type == "meta"
    small = dataclasses.replace(spec, n_nodes=spec.n_nodes // 1000,
                                n_edges=spec.n_edges // 1000)
    cfg = registry.get_arch("egnn").reduced_config()
    losses = []
    for chunk in (1 << 13, gnn.EDGE_CHUNK):
        b = steps.gnn_bundle("egnn", cfg, small, device="cpu",
                             edge_chunk=chunk)
        assert b.args[2]["edges"].shape == (63488, 2)
        losses.append(assert_takes_a_step(b))
    assert gnn.edge_chunks(63488, 1 << 13) == 8
    assert losses[0] == losses[1]
