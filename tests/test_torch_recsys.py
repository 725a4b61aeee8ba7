"""The recsys family (two-tower, MIND, DIN, DIEN), the port against the JAX
package on the CPU: configs field for field, PTQ bit for bit, ``score``,
``retrieval_scores`` and the ``train_loss`` value on raw and fp8 weights at
``reduced_config()`` and at the published widths with the tables cut to
1000 item rows and 50 rows a field (what runs kernel ``fp8_gemm``'s K =
180, 200, 270 and N = 1 through its plain version), chunked retrieval, the
embedding bags, ``SyntheticInteractions`` and the bundles.  The JAX side
runs op by op (``jax.disable_jit``); the bodies are in
``_torch_parity.py``.

Tolerances (max |port - JAX| over max |JAX|): raw weights 1e-2 -- the raw
bf16 products sum in f32 in another order than XLA's dot, so a bf16
rounding flips now and then and runs down the tower (measured <= 5.1e-4,
two-tower at published widths); fp8 weights 1e-5 -- payloads and scales
are bit-identical and the products exact, only f32 summation order differs
(measured <= 2.1e-7).  Chunked retrieval equals the one-call scores within
1e-6 (the raw f32 products of a chunk may block their sums otherwise); the
embedding bags within 1e-6 (f32 sums of a few rows).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RECSYS_ARCHS, assert_takes_a_step, recsys_batch, recsys_cfg,
                           recsys_outputs, recsys_params, rel_dev)
from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
from repro.data.recsys_data import RecsysStreamConfig as JaxStreamConfig
from repro.data.recsys_data import SyntheticInteractions as JaxInteractions
from repro.layers import common as jax_common
from repro.layers import embedding as jax_embedding
from repro_torch.configs import base, registry
from repro_torch.core.quant import QuantizedTensor
from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                          SyntheticInteractions)
from repro_torch.launch import steps
from repro_torch.layers import common, embedding
from repro_torch.models import recsys
from repro_torch.tree import leaves_with_path

RAW_TOL, FP8_TOL = 1e-2, 1e-5
SIZES = ("reduced", "published")

# the quantized (K, N) of each arch at published widths (paper's policy)
QUANTIZED = {
    "two-tower-retrieval": {
        "user_tower/tower/0/kernel": (2304, 1024),
        "user_tower/tower/1/kernel": (1024, 512),
        "user_tower/tower/2/kernel": (512, 256),
        "item_tower/tower/0/kernel": (256, 1024),
        "item_tower/tower/1/kernel": (1024, 512),
        "item_tower/tower/2/kernel": (512, 256)},
    "mind": {"proj/tower/0/kernel": (576, 64)},
    "din": {"score/score_mlp/0/kernel": (180, 200),
            "score/score_mlp/1/kernel": (200, 80),
            "score/score_mlp/2/kernel": (80, 1)},
    "dien": {"score/score_mlp/0/kernel": (270, 200),
             "score/score_mlp/1/kernel": (200, 80),
             "score/score_mlp/2/kernel": (80, 1)},
}


@pytest.mark.parametrize("which", ["CONFIG", "reduced_config"])
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_configs_equal_field_for_field(arch, which):
    ours, theirs = registry.get_arch(arch), jax_registry.get_arch(arch)
    cfg, jcfg = getattr(ours, which), getattr(theirs, which)
    cfg = cfg() if callable(cfg) else cfg
    jcfg = jcfg() if callable(jcfg) else jcfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert {k: dataclasses.asdict(v) for k, v in ours.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.SHAPES.items()}
    assert ours.FAMILY == theirs.FAMILY == "recsys"


def test_recsys_config_has_every_jax_field_with_its_default():
    ours = {f.name: f for f in dataclasses.fields(base.RecsysConfig)}
    theirs = {f.name: f for f in dataclasses.fields(jax_base.RecsysConfig)}
    assert list(ours) == list(theirs)
    for name, f in theirs.items():
        assert ours[name].default == f.default, name


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_ptq_is_bit_identical(arch, size):
    """The paper's policy quantizes the same leaves on both sides, with
    bit-identical payloads (laid out K-major, rows padded to 16 bytes) and
    scales; at published widths they are the (K, N) the kernel runs.  The
    trees' ``param_count`` and each leaf's ``kernel_shape`` agree."""
    _, jq, _, tq = recsys_params(arch, size)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, JaxQuantizedTensor))[0])
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
               for path, leaf in jleaves.items()}
    tleaves = dict(leaves_with_path(tq))
    assert set(jleaves) == set(tleaves)
    shapes = {}
    for path, leaf in tleaves.items():
        ref = jleaves[path]
        assert isinstance(leaf, QuantizedTensor) == isinstance(
            ref, JaxQuantizedTensor), path
        if not isinstance(leaf, QuantizedTensor):
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref),
                                          path)
            continue
        shapes[path] = tuple(leaf.data.shape)
        assert common.kernel_shape(leaf) == jax_common.kernel_shape(ref)
        assert leaf.data.stride(-2) == 1 and leaf.data.stride(-1) % 16 == 0
        np.testing.assert_array_equal(
            leaf.data.contiguous().view(torch.uint8).numpy(),
            np.asarray(ref.data).view(np.uint8), err_msg=path)
        np.testing.assert_array_equal(leaf.scale.numpy(),
                                      np.asarray(ref.scale), path)
    assert set(shapes) == set(QUANTIZED[arch])
    assert common.param_count(tq) == jax_common.param_count(jq)
    if size == "published":
        assert shapes == QUANTIZED[arch]


@pytest.mark.parametrize("fp8", [False, True], ids=["raw", "fp8"])
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_outputs_match_jax(arch, size, fp8):
    """``score`` over a batch of users, ``retrieval_scores`` of the first
    against candidates, and the ``train_loss`` value."""
    tol = FP8_TOL if fp8 else RAW_TOL
    for name, (ours, theirs) in recsys_outputs(arch, size, fp8).items():
        assert tuple(ours.shape) == theirs.shape, name
        assert bool(torch.isfinite(ours).all()), name
        assert rel_dev(ours, theirs) <= tol, (name, rel_dev(ours, theirs))


@pytest.mark.parametrize("fp8", [False, True], ids=["raw", "fp8"])
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_chunked_retrieval_equals_one_call(arch, fp8):
    """Candidates fed 16 a call (a ragged last chunk) give the one-call
    scores (the reduced configs: DIEN's two GRU passes over every
    candidate at L = 100 would cost the parallel CPU run minutes)."""
    cfg = recsys_cfg(arch, "reduced")
    _, _, raw, q = recsys_params(arch, "reduced")
    _, one = recsys_batch(cfg, n=40)
    batch = {k: torch.from_numpy(v) for k, v in one.items()}
    params = q if fp8 else raw
    whole = recsys.retrieval_scores(params, batch, cfg)
    chunked = recsys.retrieval_scores_chunked(params, batch, cfg, 16)
    assert chunked.shape == whole.shape == (40,)
    assert rel_dev(chunked, whole.float().numpy()) <= 1e-6


def _bag_inputs(seed=0, vocab=30, dim=8, n_bags=7):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(vocab, dim)).astype(np.float32)
    ids = rng.integers(0, vocab, size=20).astype(np.int32)
    # bags 2 and 5 stay empty
    seg = np.sort(rng.choice([0, 1, 3, 4, 6], size=20)).astype(np.int32)
    weights = rng.uniform(0.1, 2.0, size=20).astype(np.float32)
    return table, ids, seg, weights, n_bags


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_jax(mode, weighted):
    table, ids, seg, w, n_bags = _bag_inputs()
    kw = dict(n_bags=n_bags, mode=mode, compute_dtype=jnp.float32)
    theirs = np.asarray(jax_embedding.embedding_bag(
        {"table": jnp.asarray(table)}, jnp.asarray(ids), jnp.asarray(seg),
        weights=jnp.asarray(w) if weighted else None, **kw))
    ours = embedding.embedding_bag(
        {"table": torch.from_numpy(table)}, torch.from_numpy(ids),
        torch.from_numpy(seg),
        weights=torch.from_numpy(w) if weighted else None,
        n_bags=n_bags, mode=mode, compute_dtype=torch.float32)
    assert ours.shape == theirs.shape == (n_bags, table.shape[1])
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-6)
    assert not ours[2].any() and not ours[5].any()      # empty bags give 0
    bf16 = embedding.embedding_bag(
        {"table": torch.from_numpy(table)}, torch.from_numpy(ids),
        torch.from_numpy(seg), n_bags=n_bags, mode=mode)
    assert bf16.dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_multi_hot_bag_and_lookup_match_jax(mode):
    """Rows of pad ids (0) only give 0; every mode, bf16 out."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(25, 6)).astype(np.float32)
    ids = rng.integers(0, 25, size=(9, 4)).astype(np.int32)
    ids[2] = 0
    ids[5, 1:] = 0
    jp, tp = {"table": jnp.asarray(table)}, {"table": torch.from_numpy(table)}
    theirs = np.asarray(jax_embedding.multi_hot_bag(
        jp, jnp.asarray(ids), mode=mode), np.float32)
    ours = embedding.multi_hot_bag(tp, torch.from_numpy(ids), mode=mode)
    assert ours.dtype == torch.bfloat16
    np.testing.assert_array_equal(ours.float().numpy(), theirs)
    assert not ours[2].float().any()
    np.testing.assert_array_equal(
        embedding.embed_lookup(tp, torch.from_numpy(ids)).float().numpy(),
        np.asarray(jax_embedding.embed_lookup(jp, jnp.asarray(ids)),
                   np.float32))


@pytest.mark.parametrize("fields", [
    dict(n_items=5000, n_fields=4, field_vocab=50, seq_len=12,
         global_batch=16, seed=3),
    dict(n_items=800, n_fields=8, field_vocab=100, seq_len=30,
         global_batch=12, seed=0, host_id=1, n_hosts=3, zipf_a=1.05)],
    ids=["one-host", "three-hosts"])
def test_synthetic_interactions_equal_jax(fields):
    ours = SyntheticInteractions(RecsysStreamConfig(**fields))
    theirs = JaxInteractions(JaxStreamConfig(**fields))
    np.testing.assert_array_equal(ours.item_latent, theirs.item_latent)
    for step in (0, 4):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b) == {"hist_ids", "target_ids", "field_ids",
                                    "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], k)


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16", "fp8"])
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_bundles_build_and_train_names_n9(arch, fp8):
    """The three serving cells build at reduced size on the CPU with the
    cell's shapes; the smoke bundles run; the train cell takes a step."""
    cfg = registry.get_arch(arch).reduced_config()
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        b = steps.build_bundle(arch, shape, reduced=True, fp8=fp8,
                               device="cpu")
        spec = registry.get_arch(arch).SHAPES[shape]
        batch = b.args[1]
        assert b.kind == spec.kind and b.note == ("fp8" if fp8 else "bf16")
        assert batch["hist_ids"].shape == (spec.global_batch, cfg.seq_len)
        if spec.kind == "retrieval":
            assert batch["candidate_ids"].shape == (spec.n_candidates,)
        n_q = sum(isinstance(leaf, QuantizedTensor)
                  for _, leaf in leaves_with_path(b.args[0]))
        assert n_q == (len(QUANTIZED[arch]) if fp8 else 0)
    for b in steps.smoke_bundles(arch, fp8=fp8, device="cpu"):
        if b.kind == "train":                 # its step: below
            continue
        out = b.fn(*b.args)
        n = b.args[1]["candidate_ids"].shape[0] if b.kind == "retrieval" \
            else b.args[1]["target_ids"].shape[0]
        assert out.shape == (n,) and bool(torch.isfinite(out).all())
    # the train cell takes a step (N9b) at the smoke batch: two-tower's and
    # MIND's in-batch softmax is B x B at the cell's 65536 users
    b = steps.build_bundle(arch, "train_batch", reduced=True, fp8=fp8,
                           device="cpu",
                           shape_override=steps.SMOKE_SHAPES["recsys"]
                           ["train"])
    assert b.kind == "train" and b.args[2]["labels"].dtype == torch.float32
    assert_takes_a_step(b)
