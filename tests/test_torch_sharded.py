"""The port's explicit-collective distribution against one rank and against
the JAX package (ROADMAP.md queue N, item N9d): gloo ranks on the CPU,
spawned with a ``FileStore`` under ``tmp_path``, one thread each (the rank
bodies are in ``tests/_torch_dist.py``).

* Expert parallelism: reduced OneRec-V2 (4 experts, ``ep_degree=4``,
  top-2), raw and FP8, on ``(1, 4)``, ``(1, 2)`` and ``(2, 2)``: layer 0's
  ``apply_moe`` (at the config's capacity and at a tight one that drops
  tokens), the prefill's logits and ``generate_items`` bit-identical to one
  rank (on ``(2, 2)``, to one rank's run of the data shard's rows alone).
  Experts held as DTensors sharded over ``model`` give the same bits.
  Each rank's ``_moe_local`` against the JAX ``_moe_local`` under
  ``jax.disable_jit``, within the MoE parity tolerance of
  ``tests/test_torch_model.py`` (1e-5 of the largest output).
* ``compressed_psum`` over ``data`` and ``model``: against the float64 sum
  of JAX's per-rank ``ef_compress``, the sum of two ranks correctly rounded
  and of four within 2 f32 ulps of the sum of the terms' magnitudes (three
  f32 adds; the terms may cancel, so not of the sum itself), residuals bit
  for bit, a rerun bitwise equal; its refusals.
* ``constrain`` on DTensors: a placement kept, one made ``Replicate``, an
  axis dropped by ``_divides``.
* Elastic restore: the port-side ``test_elastic_reshard_across_meshes``
  (save on ``(2, 4)`` from DTensors, restore on ``(4, 2)``, 8 shards), the
  sharded save's manifest hash equal to one rank's; a JAX-written PTQ'd
  reduced OneRec-V2 checkpoint restored onto ``(2, 2)`` under
  ``TRAIN_RULES`` and ``INFER_RULES`` from a ``meta`` template: local
  shards equal the global leaves' slices, fp8 payloads K-major, placements
  those of ``shardings_for_tree``'s specs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import jax_cfg, onerec_params
from repro.checkpoint import store as jax_store
from repro.core.ptq import quantize_params as jax_quantize_params
from repro.distributed.compression import ef_compress as jax_ef_compress
from repro.layers import moe as jax_moe
from repro.models import onerec as jax_onerec
from repro_torch import tree as tree_util
from repro_torch.checkpoint import store
from repro_torch.configs import onerec_v2
from repro_torch.core.ptq import quantize_params
from repro_torch.distributed import compression, elastic
from repro_torch.distributed import sharding as sh
from repro_torch.layers import moe
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm

CFG = onerec_v2.reduced_config()
SPEC = tfm.moe_spec_for(CFG.transformer)
B = 4
MOE_REL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    s = CFG.history_len * CFG.n_codebooks + 1
    x = torch.from_numpy(rng.normal(size=(B, s, CFG.transformer.d_model))
                         .astype(np.float32)).to(torch.bfloat16)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, CFG.vocab_size, size=(B, s - 1)).astype(np.int32)),
             "profile": torch.from_numpy(rng.normal(
                 size=(B, onerec.PROFILE_DIM)).astype(np.float32))}
    return x, batch


@functools.lru_cache(maxsize=None)
def _reference(fp8: bool, n_data: int, d: int):
    """One rank's outputs on data shard ``d`` of ``n_data``."""
    x, batch = _inputs()
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    params = onerec.init_onerec(0, CFG, device="cpu")
    if fp8:
        params = quantize_params(params)
    return td.ep_outputs(params, CFG, x[rows],
                         {k: v[rows] for k, v in batch.items()}, SPEC)


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    raw = jax_onerec.init_onerec(jax.random.PRNGKey(3), jax_cfg(CFG))
    return jax_store.save_checkpoint(
        str(tmp_path_factory.mktemp("jax_ckpt")), 1,
        jax_quantize_params(raw))


@pytest.fixture(scope="module")
def world4(tmp_path_factory, jax_ckpt):
    x, batch = _inputs()
    return td.run(4, td.world4_job, (x, batch, jax_ckpt),
                  str(tmp_path_factory.mktemp("world4")))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    x, batch = _inputs()
    return td.run(2, td.ep_job, (((1, 2),), x, batch),
                  str(tmp_path_factory.mktemp("world2")))


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    d = tmp_path_factory.mktemp("world8")
    return td.run(8, td.elastic_job, (str(d / "ckpt"),), str(d))


def _equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.view(torch.uint8) if a.dtype.itemsize == 1 else a,
        b.view(torch.uint8) if b.dtype.itemsize == 1 else b)


@pytest.mark.parametrize("fp8", [False, True], ids=["raw", "fp8"])
@pytest.mark.parametrize("mesh", [(1, 4), (1, 2), (2, 2)],
                         ids=["1x4", "1x2", "2x2"])
def test_expert_parallel_matches_one_rank(mesh, fp8, request):
    n_data, n_model = mesh
    ranks = request.getfixturevalue("world2" if n_model == 2 and
                                    n_data == 1 else "world4")
    if n_model == 2 and n_data == 1:
        outs = [r[(1, 2, fp8)] for r in ranks]
    else:
        outs = [r["ep"][(n_data, n_model, fp8)] for r in ranks]
    for rank, out in enumerate(outs):
        d = rank // n_model          # the mesh's data coordinate
        ref = _reference(fp8, n_data, d)
        for key in ("moe", "moe_tight", "logits", "items"):
            assert _equal(out[key], ref[key]), (rank, key)
        # the tight capacity drops tokens: the two calls differ
        assert not torch.equal(ref["moe"], ref["moe_tight"])


def test_expert_parallel_takes_dtensor_experts(world4):
    """Experts held as DTensors sharded over ``model``: each rank runs its
    local shard, bit-identical to one rank."""
    ref = _reference(False, 1, 0)["moe"]
    for out in world4:
        assert _equal(out["moe_dtensor"], ref)


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_moe_local_matches_jax(ep):
    raw, ours = onerec_params()
    lp_j = jax.tree_util.tree_map(
        lambda a: a[0], raw["backbone"]["stacks"]["0"]["p0"]["moe"])
    lp = tree_util.index(ours["backbone"]["stacks"]["0"]["p0"]["moe"], 0)
    jspec = jax_moe.MoESpec(**SPEC._asdict())
    xt = np.random.default_rng(1).normal(
        size=(50, CFG.transformer.d_model)).astype(np.float32)
    e_local = SPEC.n_experts_padded // ep
    cap = moe._capacity(50 * 2, SPEC, 2)        # two data shards of 50
    for r in range(ep):
        e0 = r * e_local
        mine = moe._moe_local(moe.keep_experts(lp, e0, e_local),
                              torch.from_numpy(xt), SPEC, e_start=e0,
                              e_local=e_local, capacity=cap)
        p_j = {"router": lp_j["router"], "experts": jax.tree_util.tree_map(
            lambda a: a[e0:e0 + e_local], lp_j["experts"])}
        with jax.disable_jit():
            theirs = np.asarray(jax_moe._moe_local(
                p_j, jnp.asarray(xt), jspec, e_start=jnp.int32(e0),
                e_local=e_local, capacity=cap))
        dev = np.abs(mine.numpy() - theirs).max() / np.abs(theirs).max()
        assert dev <= MOE_REL, (r, dev)


def test_expert_parallel_refuses_a_full_tree():
    """A rank never cuts a full expert tree per call, and the experts must
    split over the model ranks."""
    class Mesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}
    _, ours = onerec_params()
    lp = tree_util.index(ours["backbone"]["stacks"]["0"]["p0"]["moe"], 0)
    x = torch.zeros(1, 3, CFG.transformer.d_model)
    with sh.use_mesh(Mesh()):
        with pytest.raises(ValueError, match="holds 4 experts"):
            moe.apply_moe(lp, x, SPEC)
        Mesh.shape = {"data": 1, "model": 3}
        with pytest.raises(ValueError, match="do not split over 3"):
            moe.apply_moe(lp, x, SPEC)


@pytest.mark.parametrize("mesh,axis,groups", [
    ("22", "data", ((0, 2), (1, 3))), ("22", "model", ((0, 1), (2, 3))),
    ("14", "model", ((0, 1, 2, 3),))])
def test_compressed_psum(world4, mesh, axis, groups):
    def as_jax(t):
        return jax.tree_util.tree_map(lambda a: jnp.asarray(a.numpy()), t)
    comp = {}
    for rank in range(4):
        g, r = td.psum_grads(rank)
        ghat, res = jax_ef_compress(as_jax(g), as_jax(r))
        comp[rank] = (ghat, res)
    for group in groups:
        for rank in group:
            out = world4[rank]["psum"][(mesh, axis)]
            for path, got in tree_util.leaves_with_path(out["reduced"]):
                keys = path.split("/")
                terms = [np.asarray(functools.reduce(
                    lambda t, k: t[k], keys, comp[q][0]), np.float64)
                    for q in group]
                total = sum(terms)
                if len(group) == 2:      # one f32 add: correctly rounded
                    np.testing.assert_array_equal(got.numpy(),
                                                  total.astype(np.float32))
                # n - 1 f32 adds, each within half an ulp of a partial sum
                # <= sum |terms|: within 2 ulps of that (terms may cancel)
                ulp = np.spacing(sum(np.abs(t) for t in terms)
                                 .astype(np.float32))
                assert np.all(np.abs(got.numpy() - total) <= 2 * ulp), path
                want = np.asarray(functools.reduce(
                    lambda t, k: t[k], keys, comp[rank][1]))
                res = dict(tree_util.leaves_with_path(out["residuals"]))[path]
                np.testing.assert_array_equal(res.numpy(), want)
                rerun = dict(tree_util.leaves_with_path(out["rerun"]))[path]
                assert torch.equal(rerun, got)


def test_compressed_psum_refusals():
    class Mesh:
        axis_names = ("data",)
        shape = {"data": 2}
    g = {"w": torch.ones(3)}
    with pytest.raises(ValueError, match="active mesh"):
        compression.compressed_psum(g, "data", compression.ef_init(g))
    with sh.use_mesh(Mesh()):
        with pytest.raises(ValueError, match="no axis 'model'"):
            compression.compressed_psum(g, "model", compression.ef_init(g))


def test_constrain_on_dtensors(world4):
    g = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    for rank, out in enumerate(world4):
        d, m = world4[rank]["coord22"]
        c = out["constrain"]
        assert c["kept"][0] == "[Shard(dim=0), Shard(dim=2)]"
        assert torch.equal(c["kept"][1], g)
        assert torch.equal(c["kept"][2], g[2 * d:2 * d + 2, :,
                                           4 * m:4 * m + 4])
        # no mlp axis: the model shard is gathered
        assert c["replicate"][0] == "[Shard(dim=0), Replicate()]"
        assert torch.equal(c["replicate"][2], g[2 * d:2 * d + 2])
        # 3 rows do not split over data: _divides drops it
        assert c["dropped"][0] == "[Replicate(), Shard(dim=2)]"
        assert torch.equal(c["dropped"][1], g[:3])
        assert torch.equal(c["dropped"][2], g[:3, :, 4 * m:4 * m + 4])


class _Mesh22:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


def _slice(t, spec, coord):
    sizes = dict(zip(_Mesh22.mesh_dim_names, _Mesh22.shape))
    index = dict(zip(_Mesh22.mesh_dim_names, coord))
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        idx, count = 0, 1
        for a in axes:
            idx, count = idx * sizes[a] + index[a], count * sizes[a]
        n = t.shape[dim] // count
        t = t.narrow(dim, idx * n, n)
    return t


@pytest.mark.parametrize("rules", ["train", "infer"])
def test_jax_checkpoint_restores_sharded(world4, jax_ckpt, rules):
    template = quantize_params(onerec.init_onerec(0, CFG, device="cpu"))
    full, _ = store.load_checkpoint(jax_ckpt, template)
    flat = dict(td.jax_leaves(full))
    specs = dict(td.jax_leaves(elastic.shardings_for_tree(
        template, _Mesh22(), sh.RULE_SETS[rules])))
    sharded = 0
    for rank, out in enumerate(world4):
        coord = out["coord22"]
        got = out[rules]
        assert set(got) == set(flat)
        for path, (local, places, stride) in got.items():
            spec = specs[path].spec
            assert places == str(sh.placements(_Mesh22(), spec)), path
            want = _slice(flat[path], spec, coord)
            assert _equal(local, want), (rank, path)
            sharded += local.shape != flat[path].shape
            if local.dtype == torch.float8_e4m3fn and local.ndim >= 2:
                k = local.shape[-2]
                assert stride[-2] == 1 and stride[-1] == -(-k // 16) * 16
    assert sharded > 0
    if rules == "train":   # embed_fsdp shards K of q_proj and the experts
        for rank in range(4):
            q = world4[rank][rules][
                "backbone/stacks/0/p0/attn/q_proj/kernel/0"]
            assert q[0].shape[-2] == CFG.transformer.d_model // 2


def test_elastic_reshard_across_meshes(world8):
    """Save on a (2, 4) mesh, restore on (4, 2): the values, 8 shards."""
    tree = td.elastic_tree()
    g = tree["stacks"]["0"]["p0"]["attn"]["q_proj"]["kernel"]
    coords = set()
    for out in world8:
        assert torch.equal(out["full"], g)
        d, m = out["coord"]
        assert out["placements"] == "[Shard(dim=1), Shard(dim=2)]"
        assert torch.equal(out["local"], g[:, 4 * d:4 * d + 4,
                                           16 * m:16 * m + 16])
        coords.add((d, m))
    assert len(coords) == 8
    assert len({out["path"] for out in world8}) == 1


def test_sharded_save_matches_one_rank(world8, tmp_path):
    path = store.save_checkpoint(str(tmp_path), 1, td.elastic_tree())
    _, manifest = store.load_checkpoint(path, td.elastic_tree())
    assert {out["hash"] for out in world8} == {manifest["hash"]}
    assert store.verify_checkpoint(world8[0]["path"])
