"""The LM zoo's configs and pieces, the port against the JAX package on
the CPU: every config field, the layer plan and both parameter counts of
the five LMs (``CONFIG`` and ``reduced_config()``), their shape cells, the
registry (all eleven JAX names; the training cells take a step, the
abstract train bundle on ``meta``), ``SyntheticLMStream``,
chunked and windowed attention, and ``batch_attention``'s plain version
above one 512-key block.  The per-arch model parity is in
``test_torch_zoo_dense.py`` and ``test_torch_zoo_moe.py``.

Tolerances: attention outputs within 2**-8 of the max |output| (one bf16
ulp: f32 sums in another order flip a bf16 rounding now and then);
``_chunked_attention`` equals ``_full_attention`` exactly (the same rows
through the same ops).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import ZOO_ARCHS, assert_takes_a_step
from repro.configs import registry as jax_registry
from repro.data.lm import LMStreamConfig as JaxLMStreamConfig
from repro.data.lm import SyntheticLMStream as JaxSyntheticLMStream
from repro.kernels.batch_attention.ops import \
    batch_attention as jax_batch_attention
from repro.layers import attention as jax_attn
from repro.models import transformer as jax_tfm
from repro_torch.configs import registry
from repro_torch.data.lm import LMStreamConfig, SyntheticLMStream
from repro_torch.kernels.batch_attention import ops as attn_ops
from repro_torch.launch import steps
from repro_torch.layers import attention as attn
from repro_torch.models import transformer as tfm

RECSYS_GNN = ("egnn", "two-tower-retrieval", "mind", "din", "dien")


@pytest.mark.parametrize("which", ["CONFIG", "reduced_config"])
@pytest.mark.parametrize("arch", ZOO_ARCHS)
def test_lm_configs_equal_field_for_field(arch, which):
    """Fields, the layer plan (stacks, periods, kinds), both parameter
    counts, the shape cells and the family equal the JAX package's."""
    ours, theirs = registry.get_arch(arch), jax_registry.get_arch(arch)
    cfg, jcfg = getattr(ours, which), getattr(theirs, which)
    cfg = cfg() if callable(cfg) else cfg
    jcfg = jcfg() if callable(jcfg) else jcfg
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [(s.n_periods, [tuple(k) for k in s.kinds])
            for s in tfm.layer_plan(cfg)] == \
        [(s.n_periods, [tuple(k) for k in s.kinds])
         for s in jax_tfm.layer_plan(jcfg)]
    for kind in {k for s in tfm.layer_plan(cfg) for k in s.kinds}:
        assert tuple(tfm.attn_spec_for(cfg, kind)) == tuple(
            jax_tfm.attn_spec_for(jcfg, jax_tfm.LayerKind(*kind)))
    assert cfg.param_count_estimate() == jcfg.param_count_estimate()
    assert cfg.active_param_count_estimate() == \
        jcfg.active_param_count_estimate()
    assert {k: dataclasses.asdict(v) for k, v in ours.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in theirs.SHAPES.items()}
    assert ours.FAMILY == theirs.FAMILY == "lm"


def test_gemma3_and_deepseek_moe_plans():
    """gemma3-1b: 4 periods of (window x5, full) and a stack of 2 window
    layers; deepseek-moe-16b: one dense layer, then 27 MoE layers."""
    g = tfm.layer_plan(registry.get_arch("gemma3-1b").CONFIG)
    w, f = tfm.LayerKind("window", "dense"), tfm.LayerKind("full", "dense")
    assert g == [tfm.StackSpec(4, (w,) * 5 + (f,)), tfm.StackSpec(1, (w, w))]
    d = tfm.layer_plan(registry.get_arch("deepseek-moe-16b").CONFIG)
    assert d == [tfm.StackSpec(1, (f,)),
                 tfm.StackSpec(27, (tfm.LayerKind("full", "moe"),))]


def test_registry_lists_the_ported_archs():
    assert registry.list_archs() == jax_registry.list_archs()
    for arch in registry.list_archs():
        assert registry.get_arch(arch).SHAPES
    with pytest.raises(KeyError):
        registry.get_arch("no-such-arch")


@pytest.mark.parametrize("arch", RECSYS_GNN)
def test_recsys_and_gnn_archs_name_their_roadmap_item(arch):
    """Each name resolves to the JAX config's values; its training cell
    (recsys ``train_batch`` at the smoke batch: two-tower's and MIND's
    in-batch softmax is B x B at the cell's 65536 users; the GNN's
    ``full_graph_sm``) takes a step on the CPU (N9b)."""
    mod, jmod = registry.get_arch(arch), jax_registry.get_arch(arch)
    assert dataclasses.asdict(mod.CONFIG) == dataclasses.asdict(jmod.CONFIG)
    assert mod.FAMILY == jmod.FAMILY
    if mod.FAMILY == "recsys":
        b = steps.build_bundle(arch, "train_batch", reduced=True,
                               device="cpu", shape_override=steps.
                               SMOKE_SHAPES["recsys"]["train"])
    else:
        b = steps.build_bundle(arch, "full_graph_sm", reduced=True,
                               device="cpu")
    assert_takes_a_step(b)


def test_bundles_refuse_what_waits_for_n9():
    """The LM train cell takes a step (at the smoke shape: train_4k is 256
    x 4096 tokens) and its abstract bundle is built on ``meta`` (N9e.3), as
    the abstract prefill bundle is, and so are a recsys abstract train
    bundle (N9e.5: its tables row-sharded where they are used) and the
    EGNN's ``ogb_products`` (N9e.7: its edges in chunks)."""
    b = steps.build_bundle("llama3-8b", "train_4k", reduced=True,
                           device="cpu",
                           shape_override=steps.SMOKE_SHAPES["lm"]["train"])
    assert b.args[2]["tokens"].shape == (2, 16)
    assert_takes_a_step(b)
    train = steps.build_bundle("llama3-8b", "train_4k", abstract=True,
                               device="cpu")
    assert train.kind == "train"
    assert train.args[2]["tokens"].device.type == "meta"
    assert train.args[1]["mu"]["embed"]["table"].device.type == "meta"
    din = steps.build_bundle("din", "train_batch", abstract=True,
                             device="cpu")
    assert din.kind == "train"
    assert din.args[2]["hist_ids"].device.type == "meta"
    assert din.args[2]["hist_ids"].shape == (65536, 100)
    assert din.args[1]["mu"]["item_embed"]["table"].device.type == "meta"
    ogb = steps.build_bundle("egnn", "ogb_products", abstract=True,
                             device="cpu")
    assert ogb.kind == "graph"
    assert ogb.args[2]["edges"].shape == (61_859_840, 2)
    assert ogb.args[2]["edges"].device.type == "meta"
    abstract = steps.build_bundle("llama3-8b", "prefill_32k", abstract=True)
    assert abstract.args[1]["tokens"].device.type == "meta"
    with pytest.raises(ValueError, match="N/A"):
        steps.build_bundle("llama3-8b", "long_500k", device="cpu")


@pytest.mark.parametrize("fields", [
    dict(vocab_size=97, seq_len=12, global_batch=4, seed=3),
    dict(vocab_size=512, seq_len=16, global_batch=6, seed=0, host_id=1,
         n_hosts=2, branching=3)], ids=["one-host", "two-hosts"])
def test_synthetic_lm_stream_equals_jax(fields):
    ours = SyntheticLMStream(LMStreamConfig(**fields))
    theirs = JaxSyntheticLMStream(JaxLMStreamConfig(**fields))
    np.testing.assert_array_equal(ours.table, theirs.table)
    for step in (0, 5):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _qkv(seed, b=2, t=24, h=4, kv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, t, h * hd), (b, t, kv, hd), (b, t, kv, hd))]


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_equals_full(window):
    spec = attn.AttnSpec(n_heads=4, n_kv_heads=2, head_dim=16, window=window,
                         chunk_size=6)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(1))
    pos = torch.arange(24, dtype=torch.int32)
    full = attn._full_attention(q, k, v, pos, spec)
    chunked = attn._chunked_attention(q, k, v, pos, spec)
    assert torch.equal(full, chunked)


@pytest.mark.parametrize("window", [0, 5], ids=["causal", "window5"])
def test_chunked_attention_layer_matches_jax(window):
    """One attention layer with QK-norm over 24 tokens in chunks of 6 (the
    chunked path engages: 24 > 2 * 6, 24 % 6 == 0), the port against the
    JAX layer, the same raw params."""
    rng = np.random.default_rng(2)
    d, h, kv, hd = 32, 4, 2, 8
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, rope_theta=1e4,
              window=window, use_qk_norm=True, chunk_size=6)
    params = {name: {"kernel": (rng.normal(size=shape) / math.sqrt(shape[0])
                                ).astype(np.float32)}
              for name, shape in (("q_proj", (d, h * hd)),
                                  ("k_proj", (d, kv * hd)),
                                  ("v_proj", (d, kv * hd)),
                                  ("o_proj", (h * hd, d)))}
    params["q_norm"] = {"scale": rng.uniform(0.5, 1.5, hd).astype(np.float32)}
    params["k_norm"] = {"scale": rng.uniform(0.5, 1.5, hd).astype(np.float32)}
    x = rng.normal(size=(2, 24, d)).astype(np.float32)
    with jax.disable_jit():
        theirs, _ = jax_attn.apply_attention(
            jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(x, jnp.bfloat16), jax_attn.AttnSpec(**kw))
    tp = {n: {k: torch.from_numpy(a) for k, a in leaf.items()}
          for n, leaf in params.items()}
    ours, _ = attn.apply_attention(tp, torch.from_numpy(x).to(torch.bfloat16),
                                   attn.AttnSpec(**kw))
    theirs = np.asarray(theirs, np.float32)
    assert np.abs(ours.float().numpy() - theirs).max() \
        <= 2.0 ** -8 * np.abs(theirs).max()


def test_batch_attention_plain_over_many_blocks_matches_jax():
    """S = 576 (the JAX wrapper's block: 512 halved to 64, nine blocks),
    a window of 100 over a wrapped ring (positions 125 .. 700, the ring's
    start at slot 124), every seventh slot of one row empty, G = 2: the
    plain version against the Pallas kernel in interpret mode, through the
    wrapper."""
    rng = np.random.default_rng(4)
    b, t, h, kv, hd, s = 2, 1, 4, 2, 32, 576
    assert attn_ops.block_size(s) == 64 and attn_ops.block_size(4112) == 16
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    ring = (np.arange(s) - 700) % s + 700 - s + 1       # positions 125..700
    k_pos = np.stack([ring, np.where(np.arange(s) % 7 == 0, -1, ring)])
    q_pos = np.full((b, t), 700)
    args = [q, k, v, q_pos.astype(np.int32), k_pos.astype(np.int32)]
    with jax.disable_jit():
        theirs = jax_batch_attention(
            *[jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
              else jnp.asarray(a) for a in args], scale=hd ** -0.5,
            window=100)
    ours = attn_ops.batch_attention(
        *[torch.from_numpy(a).to(torch.bfloat16) if a.dtype == np.float32
          else torch.from_numpy(a) for a in args], scale=hd ** -0.5,
        window=100)
    theirs = np.asarray(theirs, np.float32)
    assert ours.shape == theirs.shape == (b, t, h * hd)
    assert np.abs(ours.float().numpy() - theirs).max() \
        <= 2.0 ** -8 * np.abs(theirs).max()


def test_embed_scale_is_the_bf16_rounding_of_sqrt_d():
    """gemma3's 1152: sqrt = 33.94.., 34.0 in bf16, as the JAX package."""
    cfg = registry.get_arch("gemma3-1b").reduced_config()
    cfg = dataclasses.replace(cfg, d_model=1152, vocab_size=4)
    params = {"embed": {"table": torch.ones(4, 1152)}}
    x = tfm.embed_tokens(params, torch.tensor([[1]]), cfg)
    assert x.dtype == torch.bfloat16 and bool((x == 34.0).all())


def test_window_caches_hold_the_window():
    """gemma3-1b's window layers get ``sliding_window`` slots, its global
    layers the whole length; per-slot caches refuse a window (JAX's
    ``ValueError``), as do the paged pools."""
    cfg = registry.get_arch("gemma3-1b").reduced_config()
    cache = tfm.init_kv_cache(cfg, 2, 40, per_slot=False)
    lens = {(si, key): leaf["k"].shape[2]
            for si, st in cache["stacks"].items() for key, leaf in st.items()}
    jcache = jax_tfm.init_kv_cache(
        jax_registry.get_arch("gemma3-1b").reduced_config(), 2, 40)
    assert lens == {(si, key): leaf["k"].shape[2]
                    for si, st in jcache["stacks"].items()
                    for key, leaf in st.items()}
    assert sorted(set(lens.values())) == [cfg.sliding_window, 40]
    with pytest.raises(ValueError, match="per-slot KV caches require full"):
        tfm.init_kv_cache(cfg, 2, 40, per_slot=True)
    with pytest.raises(ValueError, match="paged KV caches require full"):
        tfm.init_kv_page_pool(cfg, 4, 8)
