"""The port's scheduling policy over the prefix store against the JAX
engine's, on the CPU: chunked prefill over a warm prefix store (case d)
and preemption that parks its victim in the store (case e), in both
layouts.  Same params, config (``paged_test_cfg()``: MoE capacity lifted,
as in the JAX tests), request dicts and schedule through both engines;
completions token-identical and the counters of
``_torch_parity.COUNTERS`` / ``STATS`` equal.  The JAX engine runs op by
op (``jax.disable_jit``), paged with ``fused_decode=False``; the port's
paged engine decodes through kernel ``paged_decode``'s plain version
(``"auto"``).
"""

import jax
import pytest

from _torch_parity import (assert_same_handles, assert_same_runs,
                           drive_both, jax_cfg, paged_test_cfg,
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


@LAYOUTS
def test_chunked_prefill_over_prefix_store_matches_jax(setup, paged):
    """Case (d): a chunked cold pass stores the histories, a warm pass
    resumes from the store; fp8 KV."""
    cfg, params, reqs = setup
    runs = serve_both(params, cfg, reqs, passes=2, batch_size=4, n_slots=3,
                      use_fp8=False, kv_dtype="float8_e4m3fn",
                      page_size=PAGE, paged=paged, prefill_chunk=8,
                      prefix_cache=True)
    assert_same_runs(runs)
    cold, warm = runs[0][3], runs[1][3]
    assert cold["resume_calls"] >= 2 and cold["prefix_hits"] == 0
    assert warm["prefix_hits"] == len(reqs)


@LAYOUTS
def test_preemption_parks_and_resumes_like_jax(setup, paged):
    """Case (e): two priority-1 requests hold both slots mid-decode; a
    priority-0 arrival preempts one, whose history parks in the store, and
    the victim resumes from it after the arrival."""
    cfg, params, reqs = setup

    def script(engine, base):
        low = [engine.submit(dict(r, priority=1), base_s=base)
               for r in reqs[:2]]
        engine.step()                      # both join and decode once
        high = engine.submit(dict(reqs[2], priority=0), base_s=base)
        engine.step()                      # the arrival preempts a low
        assert engine._sched.preemptions == 1
        assert [h.status for h in low].count("queued") == 1
        engine.drain()
        return low + [high]

    ref, out, ref_counts, our_counts = drive_both(
        params, cfg, script, batch_size=2, n_slots=2, use_fp8=False,
        page_size=PAGE, paged=paged, preemption=True, prefix_cache=True)
    assert_same_handles(ref, out)
    assert our_counts == ref_counts
    assert our_counts["preemptions"] == 1 and our_counts["prefix_hits"] >= 1
    assert our_counts["resume_calls"] >= 1
