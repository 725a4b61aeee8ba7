"""The port's scheduling policy against the JAX engine's, on the CPU:
the unfused paged decode (case a) and chunked prefill (c), each in the
layouts the case applies to (cases d and e, which go through the prefix
store, are in ``test_torch_preemption.py``).  Same params, config
(``paged_test_cfg()``: MoE capacity lifted, so chunking's changed batch
composition cannot perturb outputs, as in the JAX tests), request dicts
and ``base_s`` through both engines; completions token-identical, and the
counters equal: ``prefill_calls``, ``resume_calls``, ``decode_steps``,
``prefix_row_copies``, ``cow_copies``, ``prefix_hits``, ``preemptions``,
``rejected``, ``cancelled`` and ``hold_rounds``.

The JAX engine runs op by op (``jax.disable_jit``), paged with
``fused_decode=False``; the port's paged engine decodes through kernel
``paged_decode``'s plain version (``"auto"``) except in case (a).
"""

import jax
import pytest

from _torch_parity import (assert_same_runs, jax_cfg, paged_test_cfg,
                           policy_requests, serve_both)
from repro.models import onerec as jax_onerec

PAGE = 8
LAYOUTS = pytest.mark.parametrize("paged", [True, False],
                                  ids=["paged", "contiguous"])


@pytest.fixture(scope="module")
def setup():
    cfg = paged_test_cfg()
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(cfg))
    return cfg, params, policy_requests(cfg, 5, seed=11)


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"],
                         ids=["bf16kv", "fp8kv"])
def test_unfused_paged_decode_matches_jax(setup, kv):
    """Case (a): ``fused_decode="off"`` decodes through the gathered view,
    the select a call of its own."""
    cfg, params, reqs = setup
    runs = serve_both(params, cfg, reqs, port_fused="off", batch_size=4,
                      n_slots=3, use_fp8=False, kv_dtype=kv,
                      page_size=PAGE)
    assert_same_runs(runs)
    assert runs[0][3]["decode_steps"] > 0


@LAYOUTS
def test_chunked_prefill_matches_jax(setup, paged):
    """Case (c): histories of up to 24 tokens in segments of 8, each
    resumed in a later step while the other rows decode."""
    cfg, params, reqs = setup
    runs = serve_both(params, cfg, reqs, batch_size=4, n_slots=3,
                      use_fp8=False, page_size=PAGE, paged=paged,
                      prefill_chunk=8)
    assert_same_runs(runs)
    assert runs[0][3]["resume_calls"] >= 2
