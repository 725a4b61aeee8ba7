"""The port's serving engine against the JAX engine, on the CPU: the same
params and request dicts (``tests/test_paged_kv.py``'s config and workload,
MoE capacity lifted so batch composition cannot perturb outputs) through
the JAX engine with the paged layout (page_size 8, decode unfused, which
``test_paged_kv`` shows token-identical to fused) and through the port's
engine on ``device="cpu"`` (plain versions of every kernel) give
TOKEN-IDENTICAL completions, for bf16 and fp8 KV.

The JAX engine runs op by op (``jax.disable_jit``): its compiled CPU
programs keep excess precision and skip roundings its code spells out (see
``tests/test_torch_model.py``); the port implements the op-by-op
semantics.
"""

import jax
import numpy as np
import pytest

from _torch_parity import jax_cfg, paged_test_cfg, torch_params
from repro.models import onerec as jax_onerec
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.requests import make_request
from repro_torch.serving import EngineConfig, ServingEngine

SEED = 23
PAGE = 8


@pytest.fixture(scope="module")
def setup():
    cfg = paged_test_cfg()
    jcfg = jax_cfg(cfg)
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(8):          # test_paged_kv._request_dicts
        n_items = int(rng.integers(2, cfg.history_len + 1))
        reqs.append(make_request(
            rng.integers(0, 192, size=n_items * cfg.n_codebooks),
            rng.normal(size=jax_onerec.PROFILE_DIM)))
    return cfg, jcfg, params, reqs


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"],
                         ids=["bf16", "fp8kv"])
def test_engine_token_identical_to_jax(setup, kv):
    cfg, jcfg, params, reqs = setup
    base = dict(batch_size=4, n_slots=3, use_fp8=False, kv_dtype=kv,
                page_size=PAGE)
    jax_engine = JaxServingEngine(params, jcfg, JaxEngineConfig(
        paged=True, fused_decode=False, **base))
    with jax.disable_jit():
        ref, ref_stats = jax_engine.serve_requests(reqs)
    engine = ServingEngine(torch_params(params), cfg, EngineConfig(**base),
                           device="cpu")
    out, stats = engine.serve_requests(reqs)
    assert len(out) == len(ref) == 8
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    # the same batches: same prefill programs, decode steps and padding
    for key in ("prefill_calls", "decode_steps", "prefill_padded_rows",
                "prefill_tokens"):
        assert stats[key if key != "prefill_tokens"
                     else "prefill_tokens_batched"] == ref_stats[key], key
    assert stats["fused_decode_steps"] == stats["decode_steps"] > 0
    assert stats["fused_select_hits"] == stats["decode_steps"]
    assert stats["pages_free"] == stats["pages_total"]   # all released


def test_engine_serves_fp8_weights_on_cpu(setup):
    """FP8 PTQ weights through the engine (fp8_gemm and the per-channel
    expert path on their plain versions): every request completes with
    in-vocabulary tokens."""
    cfg, _, params, reqs = setup
    engine = ServingEngine(torch_params(params), cfg, EngineConfig(
        batch_size=4, n_slots=3, kv_dtype="float8_e4m3fn", page_size=PAGE),
        device="cpu")
    out, stats = engine.serve_requests(reqs)
    assert stats["n_requests"] == 8
    for item in out:
        assert item.shape == (cfg.decode_len,)
        assert ((item >= 0) & (item < cfg.vocab_size)).all()
