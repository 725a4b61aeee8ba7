"""Row-sharded lookups and segment sums (ROADMAP.md queue N, items N9e.5
and N9e.10) against one rank and against the JAX package: gloo ranks on
the CPU, spawned once (one world-4 job; the rank bodies are
``tests/_torch_dist.py::rows_job``), on (1, 4) and (2, 2) under
``TRAIN_RULES`` and on (2, 2) under ``TRAIN_RULES_FSDP``.

* The four recsys families (reduced, the port's init from seed 0, a
  ``SyntheticInteractions`` batch of 16 users): their
  tables laid out on their rows over ``(data, model)`` and read where they
  lie, the towers replicated.  A train step's loss, gradients, and params,
  ``mu`` and ``nu`` after AdamW against the port's world 1; the scores
  (raw and PTQ'd towers) and one user's retrieval over 16 candidates under
  the serving rules (``INFER_RULES`` beside ``TRAIN_RULES``, the FSDP
  rules themselves); the history lookup, in f32 and bf16, bit-identical
  to world 1's (one nonzero row summed with zeros).  On (1, 4) the batch
  is whole on every rank (``data`` has one), so DIN's and DIEN's steps
  shard only their lookups and are world 1's bits.
* The EGNN (reduced) at both levels: a padded geometric graph of 64 nodes
  with masked padding, and 8 molecules of 8 nodes; nodes and edges split
  over ``(data, model)``.
* The bounds, fixed from world 1's own floor: its gradients move up to
  5.1e-3 relative L2 against JAX's when only the order of the f32 sums
  changes (``_torch_parity.GRAD_REL_L2``'s note), and a sharded step
  changes that order (the towers' gradients summed over ranks, the loss
  means, the segment sums): gradients and ``mu`` within
  ``GRAD_REL_L2`` (1.5e-2, ~3x that floor; measured <= 6.4e-3), ``nu``
  within ``NU_REL_L2`` (twice: nu ~ g^2; measured <= 9.4e-3), the loss
  within ``SHARD_LOSS_REL``, the scores within ``SCORE_REL`` (a product
  over fewer rows blocks its sums otherwise; measured <= 5e-8).  The
  params' update (after minus before) per family within
  ``DPARAM_REL_L2`` of the reference's, relative L2: AdamW's first step
  moves an element by about one learning rate whatever its gradient's
  size, so a gradient element near zero whose sign differs moves its
  param two steps apart.  The floor there is world 1 on the ranks' row
  blocks (``row_blocks``: each block's towers, products, in-batch scores,
  edge lookups and segment sums apart, their partials rounded as a
  rank's are, then added in the ranks' order); each bound is 1.5x its
  family's worst floor over 2 and 4 blocks
  (``test_world1_on_row_blocks_is_the_floor`` prints them).  Every >= 2-D
  param shard moves where world 1's slice does (a rank that lost its
  update fails there).
* The mechanism: on (2, 2) a rank's step is world 1's on its row blocks
  (2 for the recsys batch under ``TRAIN_RULES``, else 4) within
  ``BLOCKS_REL_L2`` (bit for bit but for a few f32 sums).
* Each collective's transpose against autograd's of the same computation
  on whole tensors, on integer-valued data (any order of the sums gives
  the same bits): the lookup's, the segment sum's, the EGNN's gathered
  node rows' and the in-batch softmax's gathered items'.
* ``embedding_bag`` and ``multi_hot_bag`` on a row-sharded table.
* ``at_use`` moves no table byte under ``TRAIN_RULES_FSDP`` (whose
  ``embed_fsdp`` axes would gather a storage-sharded weight), and the
  table's cotangent is not summed again.
* The node-level EGNN's (2, 2) step with each rank's own edges in
  chunks (several a rank): the one-chunk step's loss bit for bit, its
  gradients within ``CHUNK_GRAD_REL_L2``; world 1 within the bounds above.
* One DIN step and one node-level EGNN step against the JAX package's
  unsharded step under ``jax.disable_jit`` (computed in a thread while
  the ranks run).
* The runner over a sharded state (N9e.4; ``_torch_dist.runner_job``):
  reduced DIN on (2, 2) through ``FaultTolerantRunner``, a checkpoint
  every 2 of 4 steps and a fault at step 3, ends with every rank's shards
  bit-identical to a clean run's; its checkpoint holds the entries,
  bytes and hash of world 1's save of the gathered state (the zip's and
  the manifest's write times apart), which the port's world-1
  ``load_checkpoint`` and the JAX package's ``verify_checkpoint`` and
  ``load_checkpoint`` read bit for bit; no functional collective runs on
  the save path.
"""

import contextlib
import dataclasses
import json
import os
import threading
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import (egnn_params, flat_numpy, jax_value_and_grad,
                           recsys_batch, to_numpy)
from repro.checkpoint import store as jax_store
from repro_torch.checkpoint import store
from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.data import graph
from repro_torch.launch import steps
from repro_torch.layers.embedding import gather_rows
from repro_torch.models import gnn, recsys
from repro_torch.optim import adamw_init, adamw_update

GRAD_REL_L2 = 1.5e-2
NU_REL_L2 = 3e-2
SHARD_LOSS_REL = 1e-4
# 1.5x the larger of world 1's updates on 2 and 4 row blocks against its
# own (CPU): two-tower 8.85e-2, MIND 1.25e-1, DIN 5.10e-2, DIEN 6.88e-2,
# EGNN nodes 1.17e-1, molecules 1.25e-1
DPARAM_REL_L2 = {"two": 0.14, "mind": 0.19, "din": 0.08, "dien": 0.11,
                 "egnn_node": 0.18, "egnn_graph": 0.19}
# a rank against world 1 on its row blocks (measured <= 5.4e-8: DIEN)
BLOCKS_REL_L2 = 1e-7
# against the JAX package: 1.5x the larger of that floor and world 1's own
# update against JAX's (DIN's 1-D leaves 0.226, the EGNN's 1.35e-2)
JAX_DPARAM_REL_L2 = {"din": 0.34, "egnn_node": 0.16}
SCORE_REL = 1e-5
# chunked against one chunk (test_torch_graph_chunks.py's bound)
CHUNK_GRAD_REL_L2 = 5e-2
RECSYS = {"two": "two-tower-retrieval", "mind": "mind", "din": "din",
          "dien": "dien"}
EGNN = ("egnn_node", "egnn_graph")
MESHES = [(n_data, n_model, rules)
          for (n_data, n_model), rules in td.TRAIN_MESHES]
D_FEAT, N_CLASSES = 12, 16


def _recsys_cases():
    """Per family: the port's params from seed 0 and their PTQ (the
    paper's policy), a batch of 16 users and one user's 16 candidates."""
    out = []
    for name, arch in RECSYS.items():
        cfg = registry.get_arch(arch).reduced_config()
        params = recsys.init_recsys(torch.Generator().manual_seed(0), cfg,
                                    device="cpu")
        qparams = quantize_params(params, PAPER_POLICY)
        batch, one = recsys_batch(cfg)
        out.append((name, cfg, params, qparams,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    {k: torch.from_numpy(v) for k, v in one.items()}))
    return out


def _egnn_batches():
    """A geometric graph padded to 64 nodes and a multiple of 4 edges
    (masked padding), and 8 molecules of 8 nodes and 12 edges."""
    g = graph.random_geometric_graph(60, 6, D_FEAT, n_classes=N_CLASSES,
                                     seed=1)
    pad = (len(g.edges) + 9 + 3) // 4 * 4
    return {"node": graph.graph_batch(g, pad_nodes=64, pad_edges=pad),
            "graph": graph.molecule_batch(8, 8, 12, D_FEAT,
                                          n_classes=N_CLASSES, seed=2)}


def _egnn_cases():
    cfg = registry.get_arch("egnn").reduced_config()
    _, params = egnn_params("reduced", D_FEAT)
    out = []
    for level, batch in _egnn_batches().items():
        n_graphs = len(batch["labels"]) if level == "graph" else 0
        out.append((f"egnn_{level}", cfg, params,
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    level, n_graphs))
    return out


def _loss_fn(case):
    if case[0] in RECSYS:
        cfg = case[1]
        return lambda p, b: recsys.train_loss(p, b, cfg)
    _, cfg, _, _, level, n_graphs = case
    return lambda p, b: gnn.train_loss(p, b, cfg, level=level,
                                       n_graphs=n_graphs)


class _Fan(torch.autograd.Function):
    """``n`` views of ``t``, their cotangents summed as ``_mesh_sum``
    does: a rank's use of a tensor gathered whole over (2, n / 2)."""

    @staticmethod
    def forward(ctx, t, n):
        return tuple(t.view_as(t) for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        return _mesh_sum(list(grads)), None


def _mesh_sum(parts):
    """The sum of ``parts`` (one a row block, blocks in rank order over a
    (2, n / 2) mesh) in the order the ranks' all-reduces add them: over
    the first mesh dim, then the second."""
    inner = len(parts) // 2 or 1
    pairs = [sum(parts[m + inner:len(parts):inner], parts[m])
             for m in range(inner)]
    return sum(pairs[1:], pairs[0])


@contextlib.contextmanager
def row_blocks(n: int):
    """World 1 computing as ``n`` ranks that split its rows do: every
    dense tower and raw product of the recsys and EGNN modules (not the
    EGNN's graph readout: every rank reads out every graph), the in-batch
    scores (each block's users against its own view of the items), the
    EGNN's edge lookups (each block's edges from its own view of the
    nodes) and segment sums run on each of ``n`` row blocks apart (a
    block's weight, item and node cotangents rounded on their own) and the
    partials added in the ranks' order (inputs whose rows ``n`` does not
    divide whole)."""
    from repro_torch.layers import common
    apply, mm, pairs = (common.mlp_stack_apply, recsys.matmul_any,
                        recsys._in_batch)
    forward, edges, seg = gnn.egnn_forward, gnn._edge_rows, gnn.segment_sum
    split = set()           # the EGNN's node and edge counts: split rows

    def blocked(fn, x):
        if x.shape[0] % n:
            return fn(x)
        return torch.cat([fn(b) for b in x.chunk(n)])

    def seg_blocks(vals, ids, n_seg, **kw):
        if vals.shape[0] % n:
            return seg(vals, ids, n_seg, **kw)
        return _mesh_sum([seg(v, i, n_seg)
                          for v, i in zip(vals.chunk(n), ids.chunk(n))])

    def edge_blocks(t, src, dst, **kw):
        if src.shape[0] % n:
            return edges(t, src, dst, **kw)
        got = [edges(v, s, d) for v, s, d in zip(         # sorts of its own
            _Fan.apply(t, n), src.chunk(n), dst.chunk(n))]
        return tuple(torch.cat(rows) for rows in zip(*got))

    def in_batch(fn, users, items):
        if users.shape[0] % n:
            return pairs(fn, users, items)
        return torch.cat([pairs(fn, u, v) for u, v in zip(
            users.chunk(n), _Fan.apply(items, n))])

    def egnn_forward(params, batch, *args, **kw):
        split.update((batch["feat"].shape[0], batch["edges"].shape[0]))
        return forward(params, batch, *args, **kw)
    recsys.mlp_stack_apply = \
        lambda p, x, **kw: blocked(lambda b: apply(p, b, **kw), x)
    gnn.mlp_stack_apply = lambda p, x, **kw: (
        blocked(lambda b: apply(p, b, **kw), x) if x.shape[0] in split
        else apply(p, x, **kw))             # a graph readout: every rank's
    recsys.matmul_any = lambda x, w, **kw: blocked(
        lambda b: mm(b, w, **kw), x)
    recsys._in_batch = in_batch
    gnn.egnn_forward, gnn._edge_rows, gnn.segment_sum = \
        egnn_forward, edge_blocks, seg_blocks
    try:
        yield
    finally:
        recsys.mlp_stack_apply = gnn.mlp_stack_apply = apply
        recsys.matmul_any, recsys._in_batch = mm, pairs
        gnn.egnn_forward, gnn._edge_rows, gnn.segment_sum = \
            forward, edges, seg


def world1_step(loss_fn, params, batch):
    """The port's unsharded step: loss, gradients, params, mu, nu."""
    params = tree_util.map_with_path(lambda _, t: t.clone(), params)
    loss, grads = tree_util.value_and_grad(loss_fn, params, batch)
    keep = tree_util.map_with_path(lambda _, t: t.clone(), grads)
    opt = adamw_init(params)
    params, opt, _ = adamw_update(params, grads, opt, steps.OPT_CFG)
    return {"loss": loss, "grads": keep, "params": params, "mu": opt["mu"],
            "nu": opt["nu"]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' records, world 1's steps, and the JAX package's steps of
    DIN and the node-level EGNN (op by op, in a thread while the ranks
    run: they are separate processes)."""
    rc, ec = _recsys_cases(), _egnn_cases()
    cases = {c[0]: c for c in rc + ec}
    jax_out = {}

    def jax_side():
        try:
            jax_out.update(_jax_steps(cases))
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            jax_out["error"] = e
    thread = threading.Thread(target=jax_side)
    thread.start()
    try:
        ranks = td.run(4, td.rows_job, (
            rc, ec, str(tmp_path_factory.mktemp("ckpt"))),
            str(tmp_path_factory.mktemp("rows")))
    finally:
        thread.join()
    if "error" in jax_out:
        raise jax_out["error"]
    ref = {name: world1_step(_loss_fn(c), c[2], c[4] if name in RECSYS
                             else c[3])
           for name, c in cases.items()}
    return {"cases": cases, "ranks": ranks, "ref": ref, "jax": jax_out}


def _flat(t):
    return {p: v.double().numpy() for p, v in tree_util.leaves_with_path(t)}


def _numpy_ref(ref):
    return {"loss": float(ref["loss"]),
            **{k: _flat(ref[k]) for k in ("grads", "params", "mu", "nu")}}


def _rel_l2(got, ref) -> dict:
    """{path: rel. L2} of the >= 2-D leaves, and ``"1-D"`` for the 1-D
    leaves as one vector."""
    out, num, den = {}, 0.0, 0.0
    for path, r in ref.items():
        g = np.asarray(got[path], np.float64)
        r = np.asarray(r, np.float64)
        assert g.shape == r.shape, path
        err = np.linalg.norm(g - r)
        if r.ndim >= 2:
            out[path] = err / max(np.linalg.norm(r), 1e-30)
        else:
            num, den = num + err ** 2, den + np.linalg.norm(r) ** 2
    out["1-D"] = (num / max(den, 1e-60)) ** 0.5
    return out


def _update_gap(params, ref, start) -> dict:
    """``_rel_l2`` of the update ``params - start`` against ``ref -
    start`` (numpy leaves by path)."""
    return _rel_l2({p: params[p] - s for p, s in start.items()},
                   {p: ref[p] - s for p, s in start.items()})


def _check_step(res, ref, case, update_bound):
    """One rank's step (``sharded_step``'s record) of ``case`` against a
    reference (numpy leaves by path) within the module's bounds, the
    update within ``update_bound``."""
    loss = float(res["loss"])
    assert abs(loss - ref["loss"]) <= SHARD_LOSS_REL * abs(ref["loss"]), (
        loss, ref["loss"])
    for name, bound in (("grads", GRAD_REL_L2), ("mu", GRAD_REL_L2),
                        ("nu", NU_REL_L2)):
        rel = _rel_l2(_flat(res[name]), ref[name])
        worst = max(rel, key=rel.get)
        assert rel[worst] <= bound, (name, worst, rel[worst])
    start = _flat(case[2])
    rel = _update_gap(_flat(res["params"]), ref["params"], start)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= update_bound, (worst, rel[worst])
    for path, (local, ranges) in tree_util.leaves_with_path(
            res["params_local"]):
        if local.ndim < 2:
            continue
        before, want = start[path], ref["params"][path]
        for dim, (off, n) in enumerate(ranges):
            before = before.take(range(off, off + n), axis=dim)
            want = want.take(range(off, off + n), axis=dim)
        if not np.array_equal(want, before):
            assert not np.array_equal(local.double().numpy(), before), \
                ("did not move", path, ranges)


@pytest.mark.parametrize("name", list(RECSYS) + list(EGNN))
@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_sharded_step_matches_world1(runs, name, n_data, n_model, rules):
    ref = _numpy_ref(runs["ref"][name])
    for rank in runs["ranks"]:
        _check_step(rank[name, n_data, n_model, rules]["train"], ref,
                    runs["cases"][name], DPARAM_REL_L2[name])


def _blocks_step(runs, name, blocks):
    """World 1's step of ``name`` on ``blocks`` row blocks (kept)."""
    key = ("blocks", name, blocks)
    if key not in runs:
        case = runs["cases"][name]
        with row_blocks(blocks):
            runs[key] = world1_step(_loss_fn(case), case[2],
                                    case[4] if name in RECSYS else case[3])
    return runs[key]


@pytest.mark.parametrize("name", list(RECSYS) + list(EGNN))
@pytest.mark.parametrize("blocks", [2, 4])
def test_world1_on_row_blocks_is_the_floor(runs, name, blocks):
    """World 1 on ``blocks`` row blocks (``row_blocks``: the partials
    that ranks splitting the rows round on their own) against world 1:
    within the bounds the sharded steps are held to, the update within
    its family's ``DPARAM_REL_L2`` (printed: the floor it was set from)."""
    case = runs["cases"][name]
    got = _blocks_step(runs, name, blocks)
    ref = _numpy_ref(runs["ref"][name])
    gaps = {what: max(_rel_l2(_flat(got[what]), ref[what]).values())
            for what in ("grads", "mu", "nu")}
    gaps["update"] = max(_update_gap(_flat(got["params"]), ref["params"],
                                     _flat(case[2])).values())
    print(name, blocks, {k: f"{v:.3e}" for k, v in gaps.items()})
    assert gaps["grads"] <= GRAD_REL_L2 and gaps["mu"] <= GRAD_REL_L2
    assert gaps["nu"] <= NU_REL_L2
    assert 0 < gaps["update"] <= DPARAM_REL_L2[name]


@pytest.mark.parametrize("against", ["one_chunk", "world1"])
def test_chunked_sharded_step(runs, against):
    """The node-level EGNN on (2, 2) under ``TRAIN_RULES`` with each
    rank's own edges in chunks of ``MESH_EDGE_CHUNK`` (edge-MLP weights
    local, node rows gathered whole, the gathers' backward carried across
    the chunks, each chunk recomputed): against the same mesh at one
    chunk, the loss bit for bit (``index_add_`` adds rows in index order)
    and the gradients within ``CHUNK_GRAD_REL_L2``
    (``test_torch_graph_chunks.py``'s chunked-against-one-chunk bound);
    against world 1 within the bounds of every sharded step."""
    case = runs["cases"]["egnn_node"]
    per_rank = case[3]["edges"].shape[0] // 4
    assert gnn.edge_chunks(per_rank, td.MESH_EDGE_CHUNK) >= 4
    assert gnn.edge_chunks(per_rank) == 1
    for rank in runs["ranks"]:
        res = rank["egnn_node", 2, 2, "train"]
        got = res["chunked"]
        assert got["functional"] == []
        if against == "world1":
            _check_step(got, _numpy_ref(runs["ref"]["egnn_node"]), case,
                        DPARAM_REL_L2["egnn_node"])
            continue
        one = res["train"]
        assert torch.equal(got["loss"], one["loss"])
        rel = _rel_l2(_flat(got["grads"]), _flat(one["grads"]))
        worst = max(rel, key=rel.get)
        print(worst, f"{rel[worst]:.3e}")
        # > 0: the chunks' carried f32 sums ran (measured 1.42e-3)
        assert 0 < rel[worst] <= CHUNK_GRAD_REL_L2, (worst, rel[worst])


@pytest.mark.parametrize("name", ["din", "dien"])
def test_recsys_step_on_one_by_four_is_world1_bits(runs, name):
    """On (1, 4) every rank holds the whole batch, and a BCE family splits
    nothing but its tables (over ``model``): the loss and every gradient,
    the table's rows included, are world 1's bits.  (Two-tower's and
    MIND's in-batch softmaxes split their candidates over ``model`` there
    and sum the exponentials over ranks: a bound, not bits.)"""
    ref = runs["ref"][name]
    for rank in runs["ranks"]:
        got = rank[name, 1, 4, "train"]["train"]
        assert torch.equal(got["loss"], ref["loss"])
        want = dict(tree_util.leaves_with_path(ref["grads"]))
        for path, g in tree_util.leaves_with_path(got["grads"]):
            assert torch.equal(g, want[path]), path


@pytest.mark.parametrize("name", list(RECSYS))
@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_lookups_are_world1_bits(runs, name, n_data, n_model, rules):
    """The history lookup from the row-sharded table, ids split with the
    batch (``data``, and ``model`` under the FSDP rules), in f32 and cast
    to bf16 before the ranks' sum: bit-identical to world 1's."""
    _, _, params, _, batch, _ = runs["cases"][name]
    want = gather_rows(params["item_embed"]["table"], batch["hist_ids"])
    for rank in runs["ranks"]:
        got = rank[name, n_data, n_model, rules]["lookup"]
        assert got["table"] == "[Shard(dim=0), Shard(dim=0)]"
        assert torch.equal(got["f32"], want)
        assert torch.equal(got["bf16"], want.to(torch.bfloat16))


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / max(want.norm(), 1e-30))


@pytest.mark.parametrize("name", list(RECSYS))
@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_scores_and_retrieval_match_world1(runs, name, n_data, n_model,
                                           rules):
    """Scores of the batch's users (raw and PTQ'd towers, laid out with the
    batch) and one user's retrieval scores (laid out over ``(data,
    model)`` with the candidates) within ``SCORE_REL`` of world 1's."""
    _, cfg, params, qparams, batch, one = runs["cases"][name]
    users = {k: v for k, v in batch.items() if k != "labels"}
    with torch.no_grad():
        want = {"score": recsys.score(params, users, cfg),
                "score_fp8": recsys.score(qparams, users, cfg),
                "retrieval": recsys.retrieval_scores(params, one, cfg)}
    for rank in runs["ranks"]:
        res = rank[name, n_data, n_model, rules]
        for what, w in want.items():
            assert _rel(res[what]["out"], w) <= SCORE_REL, (what, rank)
        assert res["retrieval"]["placements"] == \
            "[Shard(dim=0), Shard(dim=0)]"


@pytest.mark.parametrize("name", list(RECSYS) + list(EGNN))
def test_no_gradient_shard_left_zero(runs, name):
    """Each rank's local shard of every gradient is nonzero wherever world
    1's slice of it is (a cut graph would fill zeros)."""
    ref = dict(tree_util.leaves_with_path(runs["ref"][name]["grads"]))
    for rank in runs["ranks"]:
        for key, res in rank.items():
            if isinstance(key, str) or key[0] != name:
                continue
            for path, (local, ranges) in tree_util.leaves_with_path(
                    res["train"]["local"]):
                want = ref[path]
                for dim, (off, n) in enumerate(ranges):
                    want = want.narrow(dim, off, n)
                if bool(want.ne(0).any()):
                    assert bool(local.ne(0).any()), (key, path)


def test_no_functional_collective_and_reruns_bit_identical(runs):
    for rank in runs["ranks"]:
        for key, res in rank.items():
            if isinstance(key, str):
                continue
            for what in ("train", "score", "score_fp8", "retrieval"):
                if what in res:
                    assert res[what]["functional"] == [], (key, what)
            if "rerun" not in res:
                continue
            first, again = res["train"], res["rerun"]
            assert torch.equal(first["loss"], again["loss"]), key
            for what in ("grads", "params", "mu", "nu"):
                for (path, a), (_, b) in zip(
                        tree_util.leaves_with_path(first[what]),
                        tree_util.leaves_with_path(again[what])):
                    assert torch.equal(a, b), (key, what, path)


@pytest.mark.parametrize("case", ["lookup", "segment_sum", "edge_rows",
                                  "in_batch"])
def test_collective_transposes_match_autograd(runs, case):
    """The sharded lookup's backward (the rows' cotangent gathered, summed
    into the rank's rows), the sharded segment sum's (gathered), the
    EGNN's gathered node rows' (summed back over the ranks) and the
    in-batch scores' gathered items' (summed) against autograd of the
    same computation on whole tensors, bit for bit on integer values."""
    for rank in runs["ranks"]:
        got, want = rank["rows_transposes"][case]
        assert got.shape == want.shape and torch.equal(got, want), case


@pytest.mark.parametrize("case", [f"{kind}_{mode}" for kind in (
    "bag", "multi_hot") for mode in ("sum", "mean", "max")])
def test_bags_reduce_on_the_ranks_rows(runs, case):
    """``embedding_bag`` (bags spanning both data shards: summed, or
    max-reduced, over them) and ``multi_hot_bag`` (a row's bag whole on
    its rank) from a row-sharded table equal world 1's, on integer
    values."""
    for rank in runs["ranks"]:
        got, want = rank["bags"][case]
        assert torch.equal(got, want), case


def test_at_use_moves_no_table_bytes(runs):
    """Under ``TRAIN_RULES_FSDP`` ``at_use`` runs no collective for the
    tables (their row shards are their use layout: the same local shard
    comes out), and a lookup's backward moves the ids and rows only: no
    weight gather, no gradient reduction."""
    for rank in runs["ranks"]:
        res = rank["at_use"]
        assert res["at_use"] == {}
        assert res["stored"] == res["used"] == res["grad"] == \
            "[Shard(dim=0), Shard(dim=0)]"
        assert res["same_local"]
        tags = {tag for tag, _ in res["lookup"]}
        assert tags == {"ids-gather", "rows-sum", "rows-sum-bwd", "total"}


def test_bundles_step_on_a_mesh(runs):
    """The DIN train bundle and the EGNN graph bundle laid out by
    ``steps.shard_args`` under ``TRAIN_RULES`` on (2, 2) take a step
    through their own ``fn``: the same finite loss on every rank, the
    counter at 1, every >= 2-D param moved."""
    first = runs["ranks"][0]["bundles"]
    for rank in runs["ranks"]:
        for arch, got in rank["bundles"].items():
            assert bool(torch.isfinite(got["loss"])) and got["step"] == 1
            assert got["moved"], arch
            assert torch.equal(got["loss"], first[arch]["loss"])


@pytest.mark.parametrize("name", list(RECSYS) + list(EGNN))
@pytest.mark.parametrize("rules", ["train", "train_fsdp"])
def test_sharded_step_is_world1_on_row_blocks(runs, name, rules):
    """On (2, 2) a rank computes what world 1 on its row blocks computes
    (``row_blocks``: 2 for the recsys batch over ``data`` under
    ``TRAIN_RULES``, else 4), its partials added in the same order: the
    loss, gradients, params, mu and nu within ``BLOCKS_REL_L2`` (a few
    f32 sums in another order: DIEN's, two-tower's under the FSDP
    rules)."""
    blocks = 2 if name in RECSYS and rules == "train" else 4
    ref = _numpy_ref(_blocks_step(runs, name, blocks))
    for rank in runs["ranks"]:
        got = rank[name, 2, 2, rules]["train"]
        assert abs(float(got["loss"]) - ref["loss"]) <= \
            BLOCKS_REL_L2 * abs(ref["loss"])
        for what in ("grads", "params", "mu", "nu"):
            rel = _rel_l2(_flat(got[what]), ref[what])
            worst = max(rel, key=rel.get)
            assert rel[worst] <= BLOCKS_REL_L2, (what, worst, rel[worst])


def _jax_step(loss_fn, raw, batch):
    """The JAX package's unsharded step, op by op: numpy leaves by path."""
    from repro.launch.steps import OPT_CFG as JAX_OPT
    from repro.optim import adamw_init as jax_init
    from repro.optim import adamw_update as jax_update
    jb = {k: jnp.asarray(v.numpy().copy()) for k, v in batch.items()}
    loss, grads = jax_value_and_grad(loss_fn, raw, jb)
    with jax.disable_jit():
        params, opt, _ = jax_update(raw, grads, jax_init(raw), JAX_OPT)
    return {"loss": float(loss), "grads": flat_numpy(to_numpy(grads)),
            "params": flat_numpy(to_numpy(params)),
            "mu": flat_numpy(to_numpy(opt["mu"])),
            "nu": flat_numpy(to_numpy(opt["nu"]))}


def _jax_steps(cases):
    """DIN's step (the port's params, bridged through numpy) and the
    node-level EGNN's (the JAX init the port's params came from) in the
    JAX package."""
    from repro.configs.base import RecsysConfig as JaxRecsysConfig
    from repro.models import gnn as jax_gnn
    from repro.models import recsys as jax_recsys
    _, cfg, params, _, batch, _ = cases["din"]
    jcfg = JaxRecsysConfig(**dataclasses.asdict(cfg))
    # copies: spawning the ranks moves the tensors' storage to shared
    # memory, freeing the buffers a zero-copy view would read
    raw = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy().copy()),
                                 params)
    out = {"din": _jax_step(lambda p, b: jax_recsys.train_loss(p, b, jcfg),
                            raw, batch)}
    _, gcfg, _, batch, level, n_graphs = cases["egnn_node"]
    out["egnn_node"] = _jax_step(
        lambda p, b: jax_gnn.train_loss(p, b, gcfg, level=level,
                                        n_graphs=n_graphs),
        egnn_params("reduced", D_FEAT)[0], batch)
    return out


@pytest.mark.parametrize("name", ["din", "egnn_node"])
@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_sharded_step_matches_jax(runs, name, n_data, n_model, rules):
    for rank in runs["ranks"]:
        _check_step(rank[name, n_data, n_model, rules]["train"],
                    runs["jax"][name], runs["cases"][name],
                    JAX_DPARAM_REL_L2[name])


# ---------------------------------------------------------------------------
# The runner over a sharded state: collective checkpoints (N9e.4)
# ---------------------------------------------------------------------------


def test_sharded_runner_restarts_to_the_clean_shards(runs):
    """With a fault at step 3 the runner restores step 2's checkpoint on
    every rank (the barrier first: rank 0's write whole) and replays:
    each rank's final shards are the clean run's bit for bit, the replayed
    step's loss too."""
    for rank in runs["ranks"]:
        faulted, clean = rank["runner"]["faulted"], rank["runner"]["clean"]
        assert faulted["restarts"] == 1 and clean["restarts"] == 0
        assert faulted["ckpts"] == clean["ckpts"] == [
            f"step_{s:010d}" for s in range(td.RUNNER_EVERY,
                                            td.RUNNER_STEPS + 1,
                                            td.RUNNER_EVERY)]
        assert faulted["losses"][:3] + faulted["losses"][4:] == \
            clean["losses"] and faulted["losses"][3] == clean["losses"][2]
        for (path, (a, ra)), (_, (b, rb)) in zip(
                tree_util.leaves_with_path(faulted["local"]),
                tree_util.leaves_with_path(clean["local"])):
            assert ra == rb and torch.equal(a, b), path


def _zip_entries(path):
    with zipfile.ZipFile(os.path.join(path, store.ARRAYS)) as z:
        return [(i.filename, z.read(i.filename)) for i in z.infolist()]


def _manifest(path):
    with open(os.path.join(path, store.MANIFEST)) as f:
        return {k: v for k, v in json.load(f).items() if k != "time"}


def test_sharded_checkpoint_is_world1s_file(runs, tmp_path):
    """The runners' last checkpoints and the synchronous sharded save hold
    the entries and bytes of world 1's ``save_checkpoint`` of the state
    gathered to rank 0, with its manifest (write time apart); the gathered
    state is every rank's shards put together, and world 1's
    ``load_checkpoint`` (no shardings) of the file returns it bit for
    bit."""
    ranks = runs["ranks"]
    gathered = ranks[0]["runner"]["gathered"]
    assert all(r["runner"]["gathered"] is None for r in ranks[1:])
    whole = dict(tree_util.leaves_with_path(gathered))
    for rank in ranks:
        for path, (local, ranges) in tree_util.leaves_with_path(
                rank["runner"]["clean"]["local"]):
            want = whole[path]
            for dim, (off, n) in enumerate(ranges):
                want = want.narrow(dim, off, n)
            assert torch.equal(local, want), path
    ours = store.save_checkpoint(str(tmp_path), td.RUNNER_STEPS, gathered)
    last = f"step_{td.RUNNER_STEPS:010d}"
    for path in (os.path.join(ranks[0]["runner"]["faulted"]["dir"], last),
                 os.path.join(ranks[0]["runner"]["clean"]["dir"], last),
                 ranks[0]["runner"]["sync_path"]):
        assert _zip_entries(path) == _zip_entries(ours), path
        assert _manifest(path) == _manifest(ours), path
        back, manifest = store.load_checkpoint(path, gathered)
        assert manifest["step"] == td.RUNNER_STEPS
        for (p, a), (_, b) in zip(tree_util.leaves_with_path(back),
                                  tree_util.leaves_with_path(gathered)):
            assert torch.equal(a, b), p


def test_jax_reads_the_sharded_checkpoint(runs):
    """The JAX package's ``verify_checkpoint`` accepts the sharded runner's
    checkpoint and its ``load_checkpoint`` returns the gathered state's
    bits."""
    gathered = runs["ranks"][0]["runner"]["gathered"]
    path = os.path.join(runs["ranks"][0]["runner"]["faulted"]["dir"],
                        f"step_{td.RUNNER_STEPS:010d}")
    assert jax_store.verify_checkpoint(path)

    def spec(t):
        if isinstance(t, dict):
            return {k: spec(v) for k, v in t.items()}
        return jax.ShapeDtypeStruct(tuple(t.shape), np.dtype(
            str(t.dtype).removeprefix("torch.")))
    back, _ = jax_store.load_checkpoint(path, spec(gathered))
    want = [t.numpy() for t in store._flatten(gathered)[1]]
    got = jax.tree_util.tree_leaves(back)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), b)


def test_no_functional_collective_on_the_save_path(runs):
    """Both runs (their steps, the ``AsyncCheckpointer`` saves' gathers,
    the restore) and the synchronous sharded save dispatch no functional
    collective: the gather is ``dist.gather`` of host bytes."""
    for rank in runs["ranks"]:
        res = rank["runner"]
        assert res["faulted"]["functional"] == []
        assert res["clean"]["functional"] == []
        assert res["sync_functional"] == []
