"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the small configs both packages run, the params bridge JAX -> numpy ->
``repro_torch``, and the serving parity helpers (``serve_both``,
``drive_both``) that run the JAX engine and the port's with the same
settings and compare items and counters."""

import dataclasses
import functools
import time

import jax
import numpy as np

from repro.configs.base import OneRecConfig as JaxOneRecConfig
from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro_torch.configs.base import OneRecConfig, TransformerConfig
from repro_torch.weights import params_from_numpy


def to_numpy(tree):
    """JAX param pytree (nested dicts) -> nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def torch_params(jax_params, device="cpu"):
    return params_from_numpy(to_numpy(jax_params), device)


def jax_cfg(cfg: OneRecConfig) -> JaxOneRecConfig:
    """The JAX package's config with the same fields as a port config."""
    tfm = JaxTransformerConfig(**dataclasses.asdict(cfg.transformer))
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tfm
    return JaxOneRecConfig(**fields)


def paged_test_cfg() -> OneRecConfig:
    """``tests/test_paged_kv.py::_cfg``: capacity lifted so MoE batch
    composition cannot perturb outputs."""
    return OneRecConfig(
        name="onerec-paged-test",
        history_len=8,
        transformer=TransformerConfig(
            name="onerec-paged-test-backbone",
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=64, capacity_factor=64.0, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)


def aligned_cfg() -> OneRecConfig:
    """A small 128-aligned config: experts meet the block-size check, so
    the block-scaled fp8 grouped GEMM runs end to end (reduced_config's
    64-wide experts fall back to per-channel scales)."""
    return OneRecConfig(
        name="onerec-aligned-test",
        history_len=4,
        transformer=TransformerConfig(
            name="onerec-aligned-test-backbone",
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab_size=256, moe=True, n_experts=3, top_k=2,
            d_expert=256, capacity_factor=1.5, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)


# the counters both engines keep, compared by the serving parity tests:
# executor counters, then engine stats
COUNTERS = ("prefill_calls", "resume_calls", "decode_steps",
            "prefix_row_copies", "cow_copies")
STATS = ("prefix_hits", "preemptions", "rejected", "cancelled",
         "hold_rounds", "pages_total")


def policy_requests(cfg, n: int, seed: int, n_full: int = 2):
    """``tests/test_scheduling.py::_request_dicts``: ragged histories, the
    last ``n_full`` at the full context, so chunked prefill always has
    several segments."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        n_items = cfg.history_len if i >= n - n_full else \
            int(rng.integers(2, cfg.history_len + 1))
        reqs.append({
            "tokens": rng.integers(0, 192, size=n_items * cfg.n_codebooks
                                   ).astype(np.int32),
            "profile": rng.normal(size=64).astype(np.float32)})
    return reqs


def counts(engine, stats):
    """The compared counters of one engine's last window."""
    return {**{k: engine.executor.counters[k] for k in COUNTERS},
            **{k: stats[k] for k in STATS}}


def _engines(jax_params, cfg, port_fused, settings):
    """The JAX engine (paged: decode unfused) and the port's on the CPU
    (paged: ``port_fused``, default ``"auto"``), with the same settings
    (the layout given to both: their defaults differ)."""
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    from repro_torch.serving import EngineConfig, ServingEngine
    settings = {"paged": True, **settings}
    fused = port_fused or ("auto" if settings["paged"] else "off")
    return (JaxServingEngine(jax_params, jax_cfg(cfg), JaxEngineConfig(
                fused_decode=False, **settings)),
            ServingEngine(torch_params(jax_params), cfg, EngineConfig(
                fused_decode=fused, **settings), device="cpu"))


def serve_both(jax_params, cfg, requests, *, passes: int = 1,
               port_fused=None, **settings):
    """Serve ``requests`` ``passes`` times (one engine each, so the prefix
    store carries over) through the JAX engine, op by op, and the port's
    engine on the CPU.  Returns one (JAX outputs, port outputs, JAX
    counts, port counts) per pass."""
    jax_engine, engine = _engines(jax_params, cfg, port_fused, settings)
    runs = []
    for _ in range(passes):
        with jax.disable_jit():
            ref, ref_stats = jax_engine.serve_requests(requests)
        out, stats = engine.serve_requests(requests)
        runs.append((ref, out, counts(jax_engine, ref_stats),
                     counts(engine, stats)))
    return runs


def assert_same_runs(runs):
    """Token-identical completions and equal counters, pass by pass."""
    for ref, out, ref_counts, our_counts in runs:
        assert len(out) == len(ref)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a, b)
        assert our_counts == ref_counts


def drive_both(jax_params, cfg, script, *, port_fused=None, **settings):
    """Run ``script(engine, base_s)`` -> handles on the JAX engine (op by
    op) and on the port's engine on the CPU, each with a ``base_s`` taken
    just before its script runs, so both see the same schedule however
    long the other engine took.  Returns (JAX handles, port handles, JAX
    counts, port counts)."""
    jax_engine, engine = _engines(jax_params, cfg, port_fused, settings)
    with jax.disable_jit():
        ref = script(jax_engine, time.perf_counter())
    out = script(engine, time.perf_counter())
    return (ref, out, counts(jax_engine, jax_engine.stats()),
            counts(engine, engine.stats()))


def complete_both(jax_params, cfg, requests, *, port_fused=None,
                  **settings):
    """Submit ``requests`` and drain, on the JAX engine (op by op) and on
    the port's engine on the CPU.  Returns (JAX completions, port
    completions, JAX counts, port counts), counts with the tree decode's
    ``decode_multi_steps`` and ``branch_tokens``."""
    jax_engine, engine = _engines(jax_params, cfg, port_fused, settings)
    runs = []
    with jax.disable_jit():
        handles = [jax_engine.submit(r) for r in requests]
        jax_engine.drain()
    runs.append([h.completion for h in handles])
    handles = [engine.submit(r) for r in requests]
    engine.drain()
    runs.append([h.completion for h in handles])
    tree_keys = ("decode_multi_steps", "branch_tokens")
    for eng in (jax_engine, engine):
        stats = eng.stats()
        runs.append({**counts(eng, stats),
                     **{k: stats[k] for k in tree_keys}})
    return tuple(runs)


def assert_same_completions(ref, out, score_atol=1e-5):
    """Token-identical ranked items, scores within ``score_atol`` (f32
    log-probs summed in another order)."""
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert len(a.items) == len(b.items) == len(a.scores)
        for x, y in zip(a.items, b.items):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a.scores, b.scores, rtol=0,
                                   atol=score_atol)


def assert_same_handles(ref, out):
    """Equal status per handle, token-identical items where done."""
    assert [h.status for h in out] == [h.status for h in ref]
    for a, b in zip(out, ref):
        if b.completion is not None:
            np.testing.assert_array_equal(a.completion.item,
                                          b.completion.item)


# ---------------------------------------------------------------------------
# The LM zoo (tests/test_torch_zoo*.py)
# ---------------------------------------------------------------------------

ZOO_ARCHS = ("llama3-8b", "gemma3-1b", "qwen2-moe-a2.7b", "deepseek-moe-16b",
             "deepseek-coder-33b")
ZOO_B, ZOO_PROMPT, ZOO_STEPS = 2, 16, 4    # the smoke prefill's B x S


def jax_lm_cfg(cfg: TransformerConfig) -> JaxTransformerConfig:
    return JaxTransformerConfig(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=None)
def zoo_params(arch: str):
    """(JAX raw params, JAX PTQ'd, port raw, port PTQ'd) of the arch's
    ``reduced_config()``: one JAX init (key 0, as the JAX bundles), PTQ'd
    with the paper's policy on each side."""
    from repro.configs import registry as jax_registry
    from repro.core.policy import PAPER_POLICY as JAX_PAPER
    from repro.core.ptq import quantize_params as jax_quantize_params
    from repro.models import transformer as jax_tfm
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    jcfg = jax_registry.get_arch(arch).reduced_config()
    raw = jax_tfm.init_transformer(jax.random.PRNGKey(0), jcfg)
    ours = torch_params(raw)
    return (raw, jax_quantize_params(raw, JAX_PAPER), ours,
            quantize_params(ours, PAPER_POLICY))


def zoo_prompt(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(ZOO_B, ZOO_PROMPT)).astype(
        np.int32)


# raw bf16 products sum in f32 in another order than XLA's dot (a bf16
# rounding of a projection output flips now and then and runs down its row):
# measured 0.58-0.90% of the max |logit| on the dense archs, 1.5e-7 on the
# MoE ones; the PTQ'd forward (per-token e4m3 activations) is equal up to
# f32 summation order (1e-5)
RAW_LOGIT_TOL = 2e-2
FP8_LOGIT_TOL = 1e-5


def check_raw_forward(arch: str):
    """The uncached forward on raw weights, the port against JAX (op by
    op): logits within ``RAW_LOGIT_TOL`` of the max |logit|."""
    import jax.numpy as jnp
    import torch
    from repro.models import transformer as jax_tfm
    from repro_torch.configs import registry
    from repro_torch.models import transformer as tfm
    cfg = registry.get_arch(arch).reduced_config()
    raw, _, ours, _ = zoo_params(arch)
    toks = zoo_prompt(cfg, seed=3)
    with jax.disable_jit():
        theirs, _ = jax_tfm.forward(raw, jnp.asarray(toks), jax_lm_cfg(cfg))
    got, _ = tfm.forward(ours, torch.from_numpy(toks), cfg)
    theirs = np.asarray(theirs)
    assert got.shape == theirs.shape == (ZOO_B, ZOO_PROMPT, cfg.vocab_size)
    dev = np.abs(got.numpy() - theirs).max() / np.abs(theirs).max()
    assert dev <= RAW_LOGIT_TOL, dev


def check_ptq(arch: str):
    """PTQ with the paper's policy: the same leaves quantized, payloads
    and scales bit-identical, the rest equal; the port's layer-by-layer
    PTQ at init (``init_transformer(..., transform=...)``) gives the same
    bytes as PTQ of the whole raw tree.  Returns the quantized leaves'
    module paths within a layer (``attn/q_proj``, ``moe/experts``, ..)."""
    import torch
    from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
    from repro_torch.configs import registry
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    from repro_torch.core.quant import QuantizedTensor
    from repro_torch.models import transformer as tfm
    from repro_torch.tree import leaves_with_path
    _, jq, _, tq = zoo_params(arch)
    jleaves = dict(jax.tree_util.tree_flatten_with_path(
        jq, is_leaf=lambda x: isinstance(x, JaxQuantizedTensor))[0])
    jleaves = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
               for path, leaf in jleaves.items()}
    tleaves = dict(leaves_with_path(tq))
    assert set(jleaves) == set(tleaves)
    kinds = set()
    for path, leaf in tleaves.items():
        ref = jleaves[path]
        assert isinstance(leaf, QuantizedTensor) == isinstance(
            ref, JaxQuantizedTensor), path
        if isinstance(leaf, QuantizedTensor):
            kinds.add("/".join(path.split("/")[3:-1]))
            assert leaf.granularity == ref.granularity, path
            np.testing.assert_array_equal(
                leaf.data.contiguous().view(torch.uint8).numpy(),
                np.asarray(ref.data).view(np.uint8), err_msg=path)
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(ref.scale), path)
        else:
            np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref),
                                          path)
    cfg = registry.get_arch(arch).reduced_config()
    whole = quantize_params(tfm.init_transformer(
        torch.Generator().manual_seed(5), cfg), PAPER_POLICY)
    made = tfm.init_transformer(
        torch.Generator().manual_seed(5), cfg,
        transform=lambda p, t: quantize_params(t, PAPER_POLICY, prefix=p))
    made = dict(leaves_with_path(made))
    for path, leaf in leaves_with_path(whole):
        other = made[path]
        if isinstance(leaf, QuantizedTensor):
            assert other.tag == leaf.tag == path
            assert other.data.stride() == leaf.data.stride(), path
            assert torch.equal(other.data.view(torch.uint8),
                               leaf.data.view(torch.uint8)), path
            assert torch.equal(other.scale, leaf.scale), path
        else:
            assert torch.equal(other, leaf), path
    return kinds


def check_bundle_decode(arch: str, use_kernel: bool):
    """``build_bundle``'s prefill step (the smoke prefill shape) on the
    PTQ'd params, then greedy decode through the decode bundle's step over
    a shared cache of prompt + ``ZOO_STEPS`` positions, the port against
    the JAX bundles' steps: prefill logits and every step's logits within
    ``FP8_LOGIT_TOL`` of the max |logit|, greedy tokens identical, the
    caches' positions equal.  ``use_kernel``: the shared-index decode
    through ``batch_attention`` (its plain version here, the Pallas kernel
    in interpret mode there)."""
    import jax.numpy as jnp
    import torch
    from repro.configs.base import ShapeSpec as JaxShapeSpec
    from repro.launch import steps as jax_steps
    from repro.models import transformer as jax_tfm
    from repro_torch.configs import registry
    from repro_torch.kernels.batch_attention import ops as attn_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(registry.get_arch(arch).reduced_config(),
                              use_attention_kernel=use_kernel)
    jcfg = jax_lm_cfg(cfg)
    _, jq, _, tq = zoo_params(arch)
    s_len = ZOO_PROMPT + ZOO_STEPS
    shapes = [steps.SMOKE_SHAPES["lm"]["prefill"], dataclasses.replace(
        steps.SMOKE_SHAPES["lm"]["decode"], seq_len=s_len)]
    ours = [steps.lm_bundle(arch, cfg, sh, fp8=False, device="cpu")
            for sh in shapes]
    theirs = [jax_steps._lm_bundle(arch, jcfg, JaxShapeSpec(
        **dataclasses.asdict(sh)), fp8=False, abstract=True)
        for sh in shapes]
    assert [b.kind for b in ours] == [b.kind for b in theirs]
    toks = zoo_prompt(cfg)

    def close(a, ref):
        ref = np.asarray(ref)
        dev = np.abs(a.numpy() - ref).max() / np.abs(ref).max()
        assert dev <= FP8_LOGIT_TOL, dev

    with jax.disable_jit():
        jl, jcache = theirs[0].fn(jq, {"tokens": jnp.asarray(toks)})
    tl, tcache = ours[0].fn(tq, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == (ZOO_B, cfg.vocab_size)
    close(tl, jl)
    for si, stack in tcache["stacks"].items():
        for key, leaf in stack.items():
            np.testing.assert_array_equal(
                leaf["pos"].numpy(),
                np.asarray(jcache["stacks"][si][key]["pos"]))
    with jax.disable_jit():
        jcache = jax_tfm.init_kv_cache(jcfg, ZOO_B, s_len)
        jl, jcache = jax_tfm.prefill(jq, jnp.asarray(toks), jcfg, jcache)
        jtoks = [np.asarray(jnp.argmax(jl, -1)).astype(np.int32)]
        for i in range(ZOO_STEPS):
            jl, jcache = theirs[1].fn(
                jq, jcache, {"tokens": jnp.asarray(jtoks[-1][:, None])},
                jnp.int32(ZOO_PROMPT + i))
            jtoks.append(np.asarray(jnp.argmax(jl, -1)).astype(np.int32))
    tcache = tfm.init_kv_cache(cfg, ZOO_B, s_len, per_slot=False)
    tl, tcache = tfm.prefill(tq, torch.from_numpy(toks), cfg, tcache)
    ttoks = [tl.argmax(-1).to(torch.int32).numpy()]
    before = attn_ops.batch_attention.launches
    for i in range(ZOO_STEPS):
        tl, tcache = ours[1].fn(tq, tcache, {"tokens": torch.from_numpy(
            ttoks[-1][:, None])}, ZOO_PROMPT + i)
        ttoks.append(tl.argmax(-1).to(torch.int32).numpy())
    assert attn_ops.batch_attention.launches == before   # plain on the CPU
    np.testing.assert_array_equal(np.stack(ttoks), np.stack(jtoks))
    close(tl, jl)
    for si, stack in tcache["stacks"].items():
        for key, leaf in stack.items():
            np.testing.assert_array_equal(
                leaf["pos"].numpy(),
                np.asarray(jcache["stacks"][si][key]["pos"]))


# ---------------------------------------------------------------------------
# The recsys family (tests/test_torch_recsys.py)
# ---------------------------------------------------------------------------

RECSYS_ARCHS = ("two-tower-retrieval", "mind", "din", "dien")
RECSYS_B = RECSYS_N = 16     # users a score batch, candidates a user (one
# size: the op-by-op JAX side compiles each op once a shape)
CUT_ITEMS, CUT_FIELD_VOCAB = 1000, 50   # the published widths' cut tables


def recsys_cfg(arch: str, size: str):
    """The arch's ``reduced_config()`` (size "reduced"), or its ``CONFIG``
    at published widths with the tables cut to ``CUT_ITEMS`` item rows and
    ``CUT_FIELD_VOCAB`` rows a field (size "published")."""
    from repro_torch.configs import registry
    mod = registry.get_arch(arch)
    if size == "reduced":
        return mod.reduced_config()
    return dataclasses.replace(mod.CONFIG, n_items=CUT_ITEMS,
                               n_users=CUT_ITEMS,
                               field_vocab=CUT_FIELD_VOCAB)


@functools.lru_cache(maxsize=None)
def recsys_params(arch: str, size: str):
    """(JAX raw params, JAX PTQ'd, port raw, port PTQ'd): one JAX init (key
    0, as the JAX bundles), bridged through numpy, PTQ'd with the paper's
    policy on each side."""
    from repro.configs.base import RecsysConfig as JaxRecsysConfig
    from repro.core.policy import PAPER_POLICY as JAX_PAPER
    from repro.core.ptq import quantize_params as jax_quantize_params
    from repro.models import recsys as jax_recsys
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    cfg = recsys_cfg(arch, size)
    raw = jax_recsys.init_recsys(jax.random.PRNGKey(0), JaxRecsysConfig(
        **dataclasses.asdict(cfg)))
    ours = torch_params(raw)
    return (raw, jax_quantize_params(raw, JAX_PAPER), ours,
            quantize_params(ours, PAPER_POLICY))


def recsys_batch(cfg, b: int = RECSYS_B, n: int = RECSYS_N, step: int = 0):
    """``SyntheticInteractions``' batch ``step`` (Zipf histories, targets,
    fields, labels) for ``b`` users, and ``n`` candidates for the first."""
    from repro_torch.data.recsys_data import (RecsysStreamConfig,
                                              SyntheticInteractions)
    stream = SyntheticInteractions(RecsysStreamConfig(
        n_items=cfg.n_items, n_fields=cfg.n_sparse_fields,
        field_vocab=cfg.field_vocab, seq_len=cfg.seq_len, global_batch=b,
        seed=7))
    batch = stream.batch_at(step)
    cand = np.random.default_rng(step).integers(
        0, cfg.n_items, size=n).astype(np.int32)
    one = {k: batch[k][:1] for k in ("hist_ids", "target_ids", "field_ids")}
    return batch, dict(one, candidate_ids=cand)


def rel_dev(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got = np.asarray(got.float() if hasattr(got, "float") else got,
                     np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def recsys_outputs(arch: str, size: str, fp8: bool):
    """Scores, retrieval scores and the train loss value of both packages
    (the JAX side op by op) on one batch: {name: (port, JAX)}."""
    import jax.numpy as jnp
    import torch
    from repro.configs.base import RecsysConfig as JaxRecsysConfig
    from repro.models import recsys as jax_recsys
    from repro_torch.models import recsys
    cfg = recsys_cfg(arch, size)
    jcfg = JaxRecsysConfig(**dataclasses.asdict(cfg))
    jraw, jq, traw, tq = recsys_params(arch, size)
    jp, tp = (jq, tq) if fp8 else (jraw, traw)
    batch, one = recsys_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j1 = {k: jnp.asarray(v) for k, v in one.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    t1 = {k: torch.from_numpy(v) for k, v in one.items()}
    with jax.disable_jit():
        theirs = {"score": jax_recsys.score(jp, jb, jcfg),
                  "retrieval": jax_recsys.retrieval_scores(jp, j1, jcfg),
                  "loss": jax_recsys.train_loss(jp, jb, jcfg)}
    ours = {"score": recsys.score(tp, tb, cfg),
            "retrieval": recsys.retrieval_scores(tp, t1, cfg),
            "loss": recsys.train_loss(tp, tb, cfg)}
    return {k: (ours[k], np.asarray(theirs[k], np.float32)) for k in ours}


# ---------------------------------------------------------------------------
# The EGNN (tests/test_torch_gnn.py)
# ---------------------------------------------------------------------------

GNN_CLASSES = 16


@functools.lru_cache(maxsize=None)
def egnn_params(which: str, d_feat: int):
    """(JAX params, port params) of ``egnn``'s ``CONFIG`` or
    ``reduced_config()``: one JAX init (key 0), bridged through numpy."""
    from repro.configs import registry as jax_registry
    from repro.models import gnn as jax_gnn
    mod = jax_registry.get_arch("egnn")
    cfg = mod.CONFIG if which == "CONFIG" else mod.reduced_config()
    raw = jax_gnn.init_egnn(jax.random.PRNGKey(0), cfg, d_feat=d_feat,
                            n_classes=GNN_CLASSES)
    return raw, torch_params(raw)


def egnn_batches(d_feat: int = 12):
    """A padded node-level graph (``random_geometric_graph`` +
    ``graph_batch``, masked padding nodes and edges) and a batch of small
    graphs (``molecule_batch``)."""
    from repro_torch.data import graph
    g = graph.random_geometric_graph(60, 6, d_feat, n_classes=GNN_CLASSES,
                                     seed=1)
    node = graph.graph_batch(g, pad_nodes=64, pad_edges=len(g.edges) + 9)
    mol = graph.molecule_batch(5, 7, 12, d_feat, n_classes=GNN_CLASSES,
                               seed=2)
    return {"node": node, "graph": mol}


def egnn_outputs(which: str, level: str):
    """The forward's h and coordinates, the level's logits and loss value
    of both packages (the JAX side op by op): {name: (port, JAX)}."""
    import jax.numpy as jnp
    import torch
    from repro.models import gnn as jax_gnn
    from repro_torch.configs import registry
    from repro_torch.models import gnn
    mod = registry.get_arch("egnn")
    cfg = mod.CONFIG if which == "CONFIG" else mod.reduced_config()
    batch = egnn_batches()[level]
    jp, tp = egnn_params(which, batch["feat"].shape[1])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    n_graphs = len(batch["labels"]) if level == "graph" else 0
    with jax.disable_jit():
        jh, jx = jax_gnn.egnn_forward(jp, jb, cfg)
        jl = (jax_gnn.graph_logits(jp, jb, cfg, n_graphs) if n_graphs
              else jax_gnn.node_logits(jp, jb, cfg))
        jloss = jax_gnn.train_loss(jp, jb, cfg, level=level,
                                   n_graphs=n_graphs)
    th, tx = gnn.egnn_forward(tp, tb, cfg)
    tl = (gnn.graph_logits(tp, tb, cfg, n_graphs) if n_graphs
          else gnn.node_logits(tp, tb, cfg))
    tloss = gnn.train_loss(tp, tb, cfg, level=level, n_graphs=n_graphs)
    return {name: (ours, np.asarray(theirs, np.float32))
            for name, ours, theirs in (("h", th, jh), ("coord", tx, jx),
                                       ("logits", tl, jl),
                                       ("loss", tloss, jloss))}


# ---------------------------------------------------------------------------
# The distribution analysis and the auto-tuner (tests/test_torch_stats.py,
# tests/test_torch_autotune.py)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def onerec_params():
    """(JAX raw params, port raw params) of OneRec-V2's ``reduced_config()``:
    one JAX init (key 0), bridged through numpy."""
    from repro.configs import registry as jax_registry
    from repro.models import onerec as jax_onerec
    cfg = jax_registry.get_arch("onerec-v2").reduced_config()
    raw = jax_onerec.init_onerec(jax.random.PRNGKey(0), cfg)
    return raw, torch_params(raw)


def onerec_batch(cfg, b: int = 4, seed: int = 0):
    """A numpy batch of ``b`` full histories (tokens and profiles)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(
                b, cfg.history_len * cfg.n_codebooks)).astype(np.int32),
            "profile": rng.normal(size=(b, 64)).astype(np.float32)}


# ---------------------------------------------------------------------------
# Gradients (tests/test_torch_train*.py)
# ---------------------------------------------------------------------------

# loss: equal up to f32 summation order; gradients: both packages round
# each f32 gradient product to bf16 once at the cast, in another summation
# order.  Kernels and tables are held leaf by leaf; the 1-D leaves (biases,
# norm scales) together, as one vector a model: each is a batch sum of
# bf16 cotangents, which XLA adds in bf16 and the port in f32 (rounded
# once), a few bf16 ulps apart on a scalar whose terms cancel (DIEN's last
# score bias: 1.4%), and a bias under a softmax has a gradient of pure
# rounding noise (DIN's last attention bias).  Measured worst: 8.7e-3 for
# a >= 2-D leaf (reduced OneRec-V2's router kernel; qwen2-moe's q_proj
# 8.5e-3, the recsys and EGNN leaves <= 5.1e-3), 7.0e-3 for the 1-D
# vector (DIEN); losses within 7.5e-8.
LOSS_REL = 1e-5
GRAD_REL_L2 = 1e-2


def flat_numpy(nested, prefix=""):
    """A JAX gradient tree (nested dicts) as {path: float64 array}."""
    out = {}
    for k, v in nested.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(flat_numpy(v, path) if isinstance(v, dict)
                   else {path: np.asarray(v, np.float64)})
    return out


def jax_value_and_grad(fn, params, *args, **kw):
    """``jax.value_and_grad`` of ``fn(params, *args, **kw)``, op by op."""
    with jax.disable_jit():
        return jax.value_and_grad(lambda p: fn(p, *args, **kw))(params)


def grad_deviation(ours, theirs):
    """(loss rel. difference, {leaf path: rel. L2} of the >= 2-D leaves,
    rel. L2 of the 1-D leaves as one vector) of the port's ``(loss,
    grads)`` against JAX's."""
    from repro_torch import tree
    (tl, tg), (jl, jg) = ours, theirs
    jl = float(jl)
    loss_rel = abs(float(tl) - jl) / max(abs(jl), 1e-30)
    ref = flat_numpy(to_numpy(jg))
    got = {p: t.detach().double().numpy()
           for p, t in tree.leaves_with_path(tg)}
    assert set(ref) == set(got)
    rel, num, den = {}, 0.0, 0.0
    for path, r in ref.items():
        assert got[path].shape == r.shape, path
        err = np.linalg.norm(got[path] - r)
        if r.ndim >= 2:
            rel[path] = float(err / max(np.linalg.norm(r), 1e-30))
        else:
            num, den = num + err ** 2, den + np.linalg.norm(r) ** 2
    return loss_rel, rel, float(np.sqrt(num / max(den, 1e-60)))


def check_grads(ours, theirs):
    loss_rel, rel, rel_1d = grad_deviation(ours, theirs)
    worst = max(rel, key=rel.get)
    assert loss_rel <= LOSS_REL, loss_rel
    assert rel[worst] <= GRAD_REL_L2, (worst, rel[worst])
    assert rel_1d <= GRAD_REL_L2, rel_1d
    return rel


def assert_takes_a_step(bundle):
    """A train / graph bundle takes one step: a finite scalar loss, every
    kernel (>= 2-D leaf) moved, the step counter at 1."""
    import torch
    from repro_torch import tree
    assert bundle.kind in ("train", "graph")
    params, opt, batch = bundle.args
    before = {p: t.clone() for p, t in tree.leaves_with_path(params)}
    loss, params, opt = bundle.fn(params, opt, batch)
    assert loss.shape == () and bool(torch.isfinite(loss)), loss
    assert int(opt["step"]) == 1
    for path, t in tree.leaves_with_path(params):
        assert bool(torch.isfinite(t).all()), path
        if t.ndim >= 2:
            assert not torch.equal(t, before[path]), path
    return float(loss)
