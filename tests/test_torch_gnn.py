"""The EGNN and the graph data, the port against the JAX package on the
CPU: the config field for field, ``random_geometric_graph``,
``graph_batch``, ``NeighborSampler`` and ``molecule_batch`` array for array,
the forward (node embeddings and coordinates), both logits and both loss
levels at ``reduced_config()`` and at the published width (4 layers, d 64),
the forward's E(3) equivariance as a property of the port, and the graph
bundles' training step (N9b; ``ogb_products`` names N9e.7).  The JAX
side runs op by op; the bodies are in ``_torch_parity.py``.

Tolerances (max |port - JAX| over max |JAX|): 1e-2 -- the raw bf16
products sum in f32 in another order than XLA's dot, so a bf16 rounding of
h flips now and then and runs on through the layers (measured <= 1.2e-3,
the published width's node embeddings; 0 elsewhere but the f32
coordinates, <= 1.8e-4).  Equivariance: coordinates within 1e-5 of the
moved ones (f32 rounding of the rotated differences; measured <= 2.7e-7),
node embeddings within 1e-2 (a bf16 rounding of the invariant distances
may flip; measured 0).
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import (GNN_CLASSES, assert_takes_a_step, egnn_batches,
                           egnn_outputs, rel_dev)
from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.data import graph as jax_graph
from repro_torch.configs import base, registry
from repro_torch.data import graph
from repro_torch.launch import steps
from repro_torch.models import gnn

TOL = 1e-2


@pytest.mark.parametrize("which", ["CONFIG", "reduced_config"])
def test_egnn_config_equals_jax(which):
    ours, theirs = registry.get_arch("egnn"), jax_registry.get_arch("egnn")
    cfg, jcfg = getattr(ours, which), getattr(theirs, which)
    cfg = cfg() if callable(cfg) else cfg
    jcfg = jcfg() if callable(jcfg) else jcfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert {k: dataclasses.asdict(v) for k, v in ours.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.SHAPES.items()}
    assert ours.FAMILY == theirs.FAMILY == "gnn"
    assert ours.N_CLASSES == theirs.N_CLASSES == GNN_CLASSES


def test_gnn_config_has_every_jax_field_with_its_default():
    ours = {f.name: f for f in dataclasses.fields(base.GNNConfig)}
    theirs = {f.name: f for f in dataclasses.fields(jax_base.GNNConfig)}
    assert list(ours) == list(theirs)
    for name, f in theirs.items():
        assert ours[name].default == f.default, name


def _same_arrays(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("args", [(200, 5, 7, 4, 0), (1000, 12, 3, 16, 9)],
                         ids=["small", "dense"])
def test_random_geometric_graph_and_batch_equal_jax(args):
    n, deg, d_feat, n_classes, seed = args
    ours = graph.random_geometric_graph(n, deg, d_feat, n_classes, seed)
    theirs = jax_graph.random_geometric_graph(n, deg, d_feat, n_classes,
                                              seed)
    _same_arrays(dataclasses.asdict(ours), dataclasses.asdict(theirs))
    for pads in ((0, 0), (n + 40, len(ours.edges) + 100)):
        _same_arrays(graph.graph_batch(ours, *pads),
                     jax_graph.graph_batch(theirs, *pads))


@pytest.mark.parametrize("fanout,seeds", [((5, 3), 16), ((4,), 2100)],
                         ids=["two-hop", "one-hop-padded"])
def test_neighbor_sampler_equals_jax(fanout, seeds):
    g = graph.random_geometric_graph(3000, 8, 5, seed=4)
    jg = jax_graph.random_geometric_graph(3000, 8, 5, seed=4)
    ours = graph.NeighborSampler(g, fanout, seeds, seed=2)
    theirs = jax_graph.NeighborSampler(jg, fanout, seeds, seed=2)
    for step in (0, 3):
        _same_arrays(ours.sample_at(step), theirs.sample_at(step))


def test_molecule_batch_equals_jax():
    _same_arrays(graph.molecule_batch(6, 9, 14, 5, seed=3),
                 jax_graph.molecule_batch(6, 9, 14, 5, seed=3))


@pytest.mark.parametrize("level", ["node", "graph"])
@pytest.mark.parametrize("which", ["reduced_config", "CONFIG"])
def test_egnn_forward_logits_and_loss_match_jax(which, level):
    """A padded node-level graph (masked padding nodes and edges: the
    padding edges point at node N-1) and a batch of small graphs."""
    outs = egnn_outputs(which, level)
    for name, (ours, theirs) in outs.items():
        assert tuple(ours.shape) == theirs.shape, name
        assert bool(torch.isfinite(ours).all()), name
        assert rel_dev(ours, theirs) <= TOL, (name, rel_dev(ours, theirs))
    assert outs["coord"][0].dtype == torch.float32
    assert outs["h"][0].dtype == torch.bfloat16


@pytest.mark.parametrize("level", ["node", "graph"])
def test_egnn_forward_is_equivariant(level):
    cfg = registry.get_arch("egnn").CONFIG
    batch = {k: torch.from_numpy(v) for k, v in egnn_batches()[level].items()}
    params = gnn.init_egnn(torch.Generator().manual_seed(0), cfg,
                           batch["feat"].shape[1], GNN_CLASSES)
    for seed in range(3):
        err_x, err_h = gnn.equivariance_error(
            params, batch, cfg, torch.Generator().manual_seed(seed))
        assert err_x <= 1e-5 and err_h <= TOL, (err_x, err_h)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_graph_bundles_name_n9(shape):
    """Each graph cell takes a training step on the CPU at its own graph
    size (N9b), but ``ogb_products``, whose 61.86 M edges wait for chunked
    or sharded segment sums (N9e.7); the smoke bundles take one each."""
    if shape == "ogb_products":
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue N, item N9e\.7"):
            steps.build_bundle("egnn", shape, reduced=True, device="cpu")
        for b in steps.smoke_bundles("egnn", device="cpu"):
            assert_takes_a_step(b)
        return
    b = steps.build_bundle("egnn", shape, reduced=True, device="cpu")
    spec = registry.get_arch("egnn").SHAPES[shape]
    n = b.args[2]["feat"].shape[0]
    assert b.args[2]["feat"].shape[1] == spec.d_feat
    assert b.note == ("graph" if spec.global_batch else "node")
    assert b.args[2]["labels"].shape[0] == (spec.global_batch or n)
    assert_takes_a_step(b)
