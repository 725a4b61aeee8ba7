"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the small configs both packages run, the params bridge JAX -> numpy ->
``repro_torch``, and the serving parity helpers (``serve_both``,
``drive_both``) that run the JAX engine and the port's with the same
settings and compare items and counters."""

import dataclasses
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
