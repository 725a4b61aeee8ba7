"""The port's fixed-batch mode (``mode="fixed"``) against the JAX package's,
on the CPU: the same params and requests through the JAX engine (op by
op, ``jax.disable_jit``; its Pallas kernels in interpret mode) and the
port's engine on ``device="cpu"`` (plain versions of every kernel), over
the contiguous pool, with the plain softmax and with
``use_attention_kernel`` and ``use_radix_topk``.

Completions are token-identical and the schedules equal: the same
prefill programs, decode steps, selects, padded rows, join steps and
occupancy samples.  The config lifts the MoE capacity
(``capacity_factor=64``), so the tail batch's padding rows cannot perturb
the real rows.  Every fixed-mode setting the JAX engine refuses is a
``ValueError`` in the port too, and ``--mode fixed`` runs through the
launcher.
"""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import jax_cfg, paged_test_cfg, torch_params
from repro.models import onerec as jax_onerec
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.requests import make_request
from repro_torch.launch import serve
from repro_torch.serving import EngineConfig, ServingEngine

SEED = 29
FIXED = dict(mode="fixed", paged=False, fused_decode="off")


@pytest.fixture(scope="module")
def setup():
    cfg = paged_test_cfg()
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(cfg))
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(7):          # two batches of 4, the second a tail of 3
        n_items = int(rng.integers(2, cfg.history_len + 1))
        reqs.append(make_request(
            rng.integers(0, 192, size=n_items * cfg.n_codebooks),
            rng.normal(size=jax_onerec.PROFILE_DIM)))
    return cfg, params, reqs


SCHEDULE = ("prefill_calls", "decode_steps", "select_calls",
            "prefill_padded_rows", "prefill_tokens", "join_steps",
            "slot_occupancy", "decode_multi_steps", "fused_decode_steps",
            "n_requests", "mode", "kv_bytes", "kv_row_bytes")


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"],
                         ids=["bf16", "fp8kv"])
@pytest.mark.parametrize("kernels", [False, True],
                         ids=["plain", "attention-kernel-radix-topk"])
def test_fixed_mode_matches_jax(setup, kernels, kv):
    cfg, params, reqs = setup
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, use_attention_kernel=kernels))
    base = dict(batch_size=4, n_slots=4, use_fp8=kv != "bfloat16",
                kv_dtype=kv, use_radix_topk=kernels)
    jax_engine = JaxServingEngine(params, jax_cfg(cfg), JaxEngineConfig(
        mode="fixed", **base))
    with jax.disable_jit():
        ref, ref_stats = jax_engine.serve_requests(reqs)
    engine = ServingEngine(torch_params(params), cfg,
                           EngineConfig(**FIXED, **base), device="cpu")
    out, stats = engine.serve_requests(reqs)
    assert len(out) == len(ref) == 7
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    stats["prefill_tokens"] = stats["prefill_tokens_batched"]
    for key in SCHEDULE:
        assert stats[key] == ref_stats[key], key
    assert stats["prefill_calls"] == 2           # one prefill per batch
    assert stats["decode_steps"] == 2 * (cfg.decode_len - 1)
    assert stats["select_calls"] == stats["prefill_calls"] \
        + stats["decode_steps"]


def test_fixed_mode_lifecycle_matches_jax(setup):
    """A partial batch waits for more submissions until a drain releases
    it; a queued request cancels, an admitted one does not."""
    cfg, params, reqs = setup

    def script(engine):
        handles = [engine.submit(r) for r in reqs[:3]]
        engine.step()                 # 3 of 4 queued: no batch forms
        formed_early = engine.executor.counters["prefill_calls"]
        queued = handles[2].cancel()
        engine.drain()                # the tail of 2 launches
        late = engine.submit(reqs[3])
        engine.step()
        engine.drain()
        return (formed_early, queued, late.cancel(),
                [h.status for h in handles],
                [h.completion.item if h.completion is not None else None
                 for h in handles + [late]])

    jax_engine = JaxServingEngine(params, jax_cfg(cfg), JaxEngineConfig(
        mode="fixed", batch_size=4, n_slots=4, use_fp8=False))
    with jax.disable_jit():
        ref = script(jax_engine)
    ours = script(ServingEngine(torch_params(params), cfg, EngineConfig(
        **FIXED, batch_size=4, n_slots=4, use_fp8=False), device="cpu"))
    assert ours[:4] == ref[:4]
    assert ours[0] == 0 and ours[1] and not ours[2]
    for a, b in zip(ours[4], ref[4]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("setting", [
    dict(mode="fixed"),                                  # the paged default
    dict(mode="fixed", paged=True, fused_decode="off"),
    dict(FIXED, prefix_cache=True),
    dict(FIXED, prefill_chunk=8),
    dict(FIXED, preemption=True),
    dict(FIXED, hold_k=2),
    dict(FIXED, hold_ms=5.0),
    dict(FIXED, max_candidates=2),
    dict(FIXED, batch_size=4, max_queue=2)])
def test_fixed_mode_refusals_match_jax(setup, setting):
    """Every fixed-mode setting the JAX engine refuses (the paged layout,
    the prefix store, chunked prefill, preemption, hold windows, tree
    decode, a queue shorter than a batch) is a ``ValueError`` in the port,
    as it is there; the port's default ``paged=True`` does not switch
    layouts quietly."""
    cfg, params, _ = setup
    jax_setting = {k: v for k, v in setting.items() if k != "fused_decode"}
    jax_setting.setdefault("paged", False)
    if setting == dict(mode="fixed"):
        jax_setting["paged"] = True      # what the port's default asks for
    with pytest.raises(ValueError):
        JaxServingEngine(params, jax_cfg(cfg), JaxEngineConfig(**jax_setting))
    with pytest.raises(ValueError):
        ServingEngine({}, cfg, EngineConfig(**setting), device="cpu")


def test_fixed_mode_launcher_on_cpu(setup, capsys):
    """``--mode fixed`` serves the contiguous layout in lock-step batches:
    ``ceil(requests / batch)`` prefills, ``decode_len - 1`` decode steps a
    batch."""
    argv = ["--reduced", "--requests", "6", "--batch", "4", "--ragged",
            "--device", "cpu", "--mode", "fixed"]
    outs, stats = serve.main(argv)
    assert len(outs) == 6 and stats["mode"] == "fixed"
    assert stats["prefill_calls"] == 2 and stats["decode_steps"] == 4
    assert "mode=fixed" in capsys.readouterr().out
    with pytest.raises(ValueError, match="continuous"):
        serve.main(argv + ["--paged"])
