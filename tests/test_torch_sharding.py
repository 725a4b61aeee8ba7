"""The port's logical-axis sharding rules against the JAX package's
(ROADMAP.md queue N, item N9d), in one process, no process group:

* the four rule sets equal JAX's dicts;
* ``infer_param_axes``, ``logical_to_spec`` and ``_divides`` give JAX's
  specs for every leaf of every registry architecture's reduced param tree
  (and of reduced OneRec-V2 after PTQ: ``QuantizedTensor`` children, paths
  ``.../0`` and ``.../1`` as JAX's pytree paths name them), under the four
  rule sets and five mesh shapes; ``elastic.shardings_for_tree`` walks the
  port's tree to the same paths and specs;
* the port-side forms of ``tests/test_distributed.py``'s example tests
  and its hypothesis invariant;
* ``param_sharding``'s DTensor placements (a tuple entry split over two
  mesh dims in mesh order, and its refusal of another order), ``constrain``
  as the identity on plain tensors;
* ``make_production_mesh`` / ``make_debug_mesh`` under the ``"fake"``
  process group backend in a subprocess, and their refusal without one.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from _hypothesis_compat import hypothesis, st
from repro.configs import registry as jax_registry
from repro.core.ptq import quantize_params as jax_quantize_params
from repro.distributed import sharding as jax_sh
from repro.launch.steps import _path_str as jax_path_str
from repro.models import gnn as jax_gnn
from repro.models import onerec as jax_onerec
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_tfm
from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.core.ptq import quantize_params
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed import elastic
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import gnn, onerec, recsys
from repro_torch.models import transformer as tfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RULES = ("train", "infer", "train_sp", "train_fsdp")
D_FEAT, N_CLASSES = 16, 16      # the EGNN's input and output widths


class _FakeMesh:
    """A mesh stand-in both packages take: axis names and a size map."""

    def __init__(self, shape):
        names = ("pod", "data", "model") if len(shape) == 3 \
            else ("data", "model")
        self.axis_names = names
        self.shape = dict(zip(names, shape))
        self.size = int(np.prod(shape))

    def __repr__(self):
        return f"mesh{tuple(self.shape.values())}"


MESHES = [_FakeMesh(s) for s in ((2, 16, 16), (16, 16), (2, 4), (4, 2),
                                 (1, 4))]


class _NamedMesh:
    """A ``DeviceMesh`` stand-in for placements: names and sizes only."""
    mesh_dim_names = ("data", "model")
    shape = (2, 4)


def _jax_tree(arch: str, ptq: bool):
    mod = jax_registry.get_arch(arch)
    cfg = mod.reduced_config()
    key = jax.random.PRNGKey(0)
    init = {"lm": lambda: jax_tfm.init_transformer(key, cfg),
            "onerec": lambda: jax_onerec.init_onerec(key, cfg),
            "recsys": lambda: jax_recsys.init_recsys(key, cfg),
            "gnn": lambda: jax_gnn.init_egnn(key, cfg, d_feat=D_FEAT,
                                             n_classes=N_CLASSES)
            }[mod.FAMILY]
    fn = (lambda: jax_quantize_params(init())) if ptq else init
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.eval_shape(fn))
    return {jax_path_str(p): tuple(leaf.shape) for p, leaf in flat}


def _port_tree(arch: str, ptq: bool):
    mod = registry.get_arch(arch)
    cfg = mod.reduced_config()
    gen = torch.Generator().manual_seed(0)
    params = {"lm": lambda: tfm.init_transformer(gen, cfg, device="cpu"),
              "onerec": lambda: onerec.init_onerec(0, cfg, device="cpu"),
              "recsys": lambda: recsys.init_recsys(gen, cfg, device="cpu"),
              "gnn": lambda: gnn.init_egnn(gen, cfg, D_FEAT, N_CLASSES,
                                           device="cpu")}[mod.FAMILY]()
    return quantize_params(params) if ptq else params


def _port_leaves(tree):
    """(JAX path, leaf) of every tensor, ``QuantizedTensor`` children as
    ``/0``, ``/1``, ``/2``."""
    for path, leaf in tree_util.leaves_with_path(tree):
        if isinstance(leaf, QuantizedTensor):
            for i, name in enumerate(("data", "scale", "act_scale")):
                part = getattr(leaf, name)
                if part is not None:
                    yield f"{path}/{i}", part
        else:
            yield path, leaf


def _spec(p):
    return tuple(p)


@pytest.mark.parametrize("name", RULES)
def test_rule_sets_equal_jax(name):
    assert set(sh.RULE_SETS) == set(jax_sh.RULE_SETS)
    assert sh.RULE_SETS[name].rules == jax_sh.RULE_SETS[name].rules


TREES = [(arch, False) for arch in registry.list_archs()] + \
    [("onerec-v2", True)]


@pytest.mark.parametrize("arch,ptq", TREES,
                         ids=[a + ("-ptq" if q else "") for a, q in TREES])
def test_param_specs_equal_jax(arch, ptq):
    """Every leaf x four rule sets x five meshes: the same logical axes,
    the same spec before and after ``_divides``, and the port's
    ``shardings_for_tree`` lands on it."""
    theirs = _jax_tree(arch, ptq)
    params = _port_tree(arch, ptq)
    ours = {p: tuple(t.shape) for p, t in _port_leaves(params)}
    assert ours == theirs
    if ptq:
        assert any(p.endswith("/1") for p in ours)     # scale children
    n = 0
    for rules in RULES:
        r_ours, r_jax = sh.RULE_SETS[rules], jax_sh.RULE_SETS[rules]
        for mesh in MESHES:
            by_path = dict(_port_leaves(elastic.shardings_for_tree(
                params, mesh, r_ours)))
            for path, shape in ours.items():
                axes = sh.infer_param_axes(path, len(shape))
                assert axes == jax_sh.infer_param_axes(path, len(shape))
                spec = sh.logical_to_spec(axes, rules=r_ours, mesh=mesh)
                jspec = jax_sh.logical_to_spec(axes, rules=r_jax, mesh=mesh)
                assert _spec(spec) == _spec(jspec), (path, rules, mesh)
                fixed = sh._divides(mesh, spec, shape)
                jfixed = jax_sh._divides(mesh, jspec, shape)
                assert _spec(fixed) == _spec(jfixed), (path, rules, mesh)
                assert by_path[path].spec == fixed
                n += 1
    assert n == len(ours) * len(RULES) * len(MESHES)


def test_logical_to_spec_drops_missing_and_reused_axes():
    spec = sh.logical_to_spec(("batch", "candidates"), rules=sh.TRAIN_RULES,
                              mesh=MESHES[0])
    # batch takes (pod, data); candidates must not reuse data
    assert spec[0] == ("pod", "data")
    assert spec[1] == "model"
    assert isinstance(spec, sh.P) and spec == sh.P(("pod", "data"), "model")


def test_divides_fixup():
    spec = sh._divides(MESHES[0], sh.P(("pod", "data"), "model"), (24, 56))
    # 24 % 2 == 0 keeps pod, then 12 % 16 drops data; 56 % 16 drops model
    assert spec == sh.P("pod")


def test_infer_param_axes_conventions():
    assert sh.infer_param_axes("stacks/0/p0/attn/q_proj/kernel", 3) == \
        (None, "embed_fsdp", "qkv_out")
    assert sh.infer_param_axes("stacks/0/p0/moe/experts/down", 4) == \
        (None, "expert", "mlp", "embed_fsdp")
    assert sh.infer_param_axes("stacks/0/p0/moe/router/kernel", 3) == \
        (None, None, None)
    assert sh.infer_param_axes("embed/table", 2) == ("vocab", "embed_fsdp")
    assert sh.infer_param_axes("item_embed/table", 2) == ("table_rows", None)
    assert sh.infer_param_axes("score/score_mlp/0/kernel", 2) == (None, None)
    # optimizer state mirrors the param path
    assert sh.infer_param_axes("mu/stacks/0/p0/attn/q_proj/kernel", 3) == \
        (None, "embed_fsdp", "qkv_out")


@hypothesis.settings(deadline=None, max_examples=50)
@hypothesis.given(
    st.lists(st.integers(1, 4096), min_size=1, max_size=4),
    st.lists(st.sampled_from([None, "batch", "heads", "mlp", "vocab",
                              "expert", "table_rows", "candidates"]),
             min_size=1, max_size=4))
def test_divides_invariant(shape, axes):
    """After _divides, the product of mesh-axis sizes on every dim divides
    that dim, and the spec is JAX's."""
    mesh = MESHES[0]
    axes = (axes + [None] * len(shape))[:len(shape)]
    spec = sh.logical_to_spec(axes, rules=sh.TRAIN_RULES, mesh=mesh)
    fixed = sh._divides(mesh, spec, tuple(shape))
    jspec = jax_sh.logical_to_spec(axes, rules=jax_sh.TRAIN_RULES, mesh=mesh)
    assert _spec(fixed) == _spec(jax_sh._divides(mesh, jspec, tuple(shape)))
    for dim, entry in zip(shape, tuple(fixed)):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else entry
        assert dim % int(np.prod([mesh.shape[n] for n in names])) == 0


def test_param_sharding_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _NamedMesh()
    # table_rows -> ("data", "model"): one dim over both mesh dims
    s = sh.param_sharding(("table_rows", None), (64, 8), mesh=mesh,
                          rules=sh.TRAIN_RULES)
    assert s.spec == sh.P(("data", "model"))
    assert s.placements == [Shard(0), Shard(0)]
    s = sh.param_sharding((None, "embed_fsdp", "qkv_out"), (2, 16, 32),
                          mesh=mesh, rules=sh.TRAIN_RULES)
    assert s.spec == sh.P(None, "data", "model")
    assert s.placements == [Shard(1), Shard(2)]
    s = sh.param_sharding(("embed_fsdp", "qkv_out"), (3, 32), mesh=mesh,
                          rules=sh.INFER_RULES)
    assert s.placements == [Replicate(), Shard(1)]
    with pytest.raises(ValueError, match="requires a mesh"):
        sh.param_sharding(("vocab",), (8,))


def test_placements_refuse_a_tuple_out_of_mesh_order():
    with pytest.raises(ValueError, match="mesh's axis order"):
        sh.placements(_NamedMesh(), sh.P(("model", "data")))
    rules = sh.AxisRules({"rows": ("model", "data")})
    spec = sh.logical_to_spec(("rows",), rules=rules, mesh=_NamedMesh())
    with pytest.raises(ValueError, match="mesh's axis order"):
        sh.NamedSharding(_NamedMesh(), spec).placements


def test_constrain_is_the_identity_on_plain_tensors():
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert sh.constrain(x, ("batch", "seq", "embed")) is x
    assert sh.current_mesh() is None
    with sh.use_mesh(MESHES[1], sh.INFER_RULES):
        assert sh.current_mesh() is MESHES[1]
        assert sh.current_rules() is sh.INFER_RULES
        assert sh.constrain(x, ("batch", "seq", "embed")) is x
        with sh.use_mesh(None):
            assert sh.current_mesh() is None
        assert sh.current_mesh() is MESHES[1]
    assert sh.current_mesh() is None and sh.current_rules() is None


_MESH_SCRIPT = textwrap.dedent("""
    import sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh
    world, rank = int(sys.argv[1]), int(sys.argv[2])
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    if world == 512:
        m = mesh.make_production_mesh(multi_pod=True, device_type="cpu")
    elif world == 256:
        m = mesh.make_production_mesh(device_type="cpu")
    else:
        m = mesh.make_debug_mesh(2, world // 2, device_type="cpu")
    try:
        mesh.make_debug_mesh(3, 5, device_type="cpu")
    except RuntimeError as e:
        refused = "15 ranks" in str(e)
    print("MESH", m.mesh_dim_names, tuple(m.shape), list(m.get_coordinate()),
          refused)
""")


@pytest.mark.parametrize("world,rank,names,shape,coord", [
    (512, 300, ("pod", "data", "model"), (2, 16, 16), [1, 2, 12]),
    (256, 17, ("data", "model"), (16, 16), [1, 1]),
    (8, 5, ("data", "model"), (2, 4), [1, 1])])
def test_meshes_under_the_fake_backend(world, rank, names, shape, coord):
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", _MESH_SCRIPT, str(world),
                          str(rank)], env=env, capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert f"MESH {names} {shape} {coord} True" in out.stdout, \
        out.stdout + out.stderr


def test_meshes_need_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        mesh_mod.make_debug_mesh(1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="256 ranks"):
        mesh_mod.make_production_mesh(device_type="cpu")
