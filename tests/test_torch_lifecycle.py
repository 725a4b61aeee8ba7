"""The port's open-system lifecycle against the JAX engine's, on the CPU:
the ``EngineConfig`` fields, hold windows (case f), backpressure and
shedding, cancellation and what it releases, handle status, deadline
accounting, the refused livelock settings, and the launcher's policy
flags.

Where both engines run, they take the same params, config
(``paged_test_cfg()``, MoE capacity lifted), request dicts and ``base_s``,
and no sleep decides an outcome: hold windows release on a count, on a
drain, or on an arrival placed in the past; the open loop's requests all
arrive at once.  The JAX engine runs op by op (``jax.disable_jit``).
"""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_parity import (assert_same_handles, assert_same_runs,
                           drive_both, jax_cfg, paged_test_cfg,
                           policy_requests, serve_both, torch_params)
from repro.models import onerec as jax_onerec
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving import run_open_loop as jax_run_open_loop
from repro_torch.configs import onerec_v2
from repro_torch.launch import serve
from repro_torch.serving import (AdmissionFull, EngineConfig,
                                 RequestCancelled, ServingEngine,
                                 run_open_loop)

PAGE = 8
# the port's deliberate defaults: the paged layout, decode through kernel
# paged_decode (the JAX engine's are False, False)
PORT_DEFAULTS = {"paged": True, "fused_decode": "auto"}


@pytest.fixture(scope="module")
def setup():
    cfg = paged_test_cfg()
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(cfg))
    return cfg, params, policy_requests(cfg, 5, seed=3)


@pytest.fixture(scope="module")
def port_params(setup):
    return torch_params(setup[1])


def _engine(setup, port_params, **kw):
    cfg = setup[0]
    return ServingEngine(port_params, cfg, EngineConfig(
        **{**dict(batch_size=4, n_slots=3, use_fp8=False, page_size=PAGE),
           **kw}), device="cpu")


def test_engine_config_has_every_jax_field_with_its_default():
    theirs = {f.name: f.default for f in dataclasses.fields(JaxEngineConfig)}
    ours = {f.name: f.default for f in dataclasses.fields(EngineConfig)}
    assert set(ours) == set(theirs)
    for name, default in theirs.items():
        assert ours[name] == PORT_DEFAULTS.get(name, default), name
    assert set(PORT_DEFAULTS) < set(theirs)


@pytest.mark.parametrize("name", ["greedy", "max_queue", "prefix_rows",
                                  "prefix_bytes_budget",
                                  "store_on_first_sight"])
def test_jax_only_fields_are_accepted(name, setup, port_params):
    """Each field the port's config lacked takes a non-default value
    without ``TypeError`` (second sight needs the store)."""
    value = {"greedy": False, "max_queue": 8, "prefix_rows": 4,
             "prefix_bytes_budget": 1 << 20,
             "store_on_first_sight": False}[name]
    engine = _engine(setup, port_params, prefix_cache=True, **{name: value})
    assert getattr(engine.ecfg, name) == value


# ---------------------------------------------------------------------------
# Hold windows (case f)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_hold_k_matches_jax(setup, paged):
    """hold_k=3: two arrivals are held, the third releases one join; the
    tail of a later submission releases under drain."""
    cfg, params, reqs = setup

    def script(engine, base):
        hs = [engine.submit(r, base_s=base) for r in reqs[:2]]
        engine.step()
        assert engine.pool.n_used == 0 and engine._sched.holds == 1
        hs.append(engine.submit(reqs[2], base_s=base))
        engine.step()
        assert engine.pool.n_used == 3
        hs += [engine.submit(r, base_s=base) for r in reqs[3:]]
        engine.drain()
        return hs

    ref, out, ref_counts, our_counts = drive_both(
        params, cfg, script, batch_size=4, n_slots=3, use_fp8=False,
        page_size=PAGE, paged=paged, hold_k=3)
    assert_same_handles(ref, out)
    assert our_counts == ref_counts and our_counts["hold_rounds"] >= 1


def test_hold_ms_matches_jax(setup):
    """hold_k=8, hold_ms=600000: a fresh arrival is held; one that arrived
    1000 s past the bound before ``base_s`` releases the window at the
    next step.  The bound dwarfs any run time, so no clock decides it."""
    cfg, params, reqs = setup
    hold_ms = 600_000.0

    def script(engine, base):
        hs = [engine.submit(reqs[0], base_s=base)]
        engine.step()
        assert engine.pool.n_used == 0
        assert engine.idle_wait_s() > 0          # wake at the hold bound
        hs.append(engine.submit(reqs[1],
                                base_s=base - hold_ms / 1e3 - 1000.0))
        engine.step()
        assert engine.pool.n_used == 2
        engine.drain()
        return hs

    ref, out, ref_counts, our_counts = drive_both(
        params, cfg, script, batch_size=4, n_slots=3, use_fp8=False,
        page_size=PAGE, hold_k=8, hold_ms=hold_ms)
    assert_same_handles(ref, out)
    assert our_counts == ref_counts


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------


def test_admission_full_at_max_queue(setup, port_params):
    cfg, _, reqs = setup
    engine = _engine(setup, port_params, batch_size=2, n_slots=2,
                     max_queue=2)
    engine.submit(reqs[0])
    engine.submit(reqs[1])
    with pytest.raises(AdmissionFull):
        engine.submit(reqs[2])
    engine.drain()
    assert engine.stats()["rejected"] == 0.0      # retried, not shed
    engine.submit(reqs[2]).result()               # room again after drain


def test_bounded_queue_serves_like_jax(setup):
    """The closed shim serves more requests than ``max_queue`` by stepping
    between submissions, as the JAX shim does."""
    cfg, params, reqs = setup
    runs = serve_both(params, cfg, reqs, batch_size=2, n_slots=2,
                      use_fp8=False, page_size=PAGE, max_queue=2)
    assert_same_runs(runs)


def test_open_loop_sheds_like_jax(setup, port_params):
    """``drop_on_full``: with one slot and a one-deep queue, every request
    after the first arrives to a full queue and is shed (output None,
    counted in ``rejected``); without it ``AdmissionFull`` propagates."""
    cfg, params, reqs = setup
    kw = dict(batch_size=1, n_slots=1, use_fp8=False, page_size=PAGE,
              max_queue=1)
    jax_engine = JaxServingEngine(params, jax_cfg(cfg), JaxEngineConfig(
        paged=True, fused_decode=False, **kw))
    with jax.disable_jit():
        ref, ref_stats = jax_run_open_loop(jax_engine, reqs,
                                           drop_on_full=True)
    engine = _engine(setup, port_params, **kw)
    out, stats = run_open_loop(engine, reqs, drop_on_full=True)
    assert [o is None for o in out] == [o is None for o in ref]
    assert sum(o is None for o in out) == len(reqs) - 1
    for a, b in zip(out, ref):
        if b is not None:
            np.testing.assert_array_equal(a, b)
    for key in ("rejected", "n_requests"):
        assert stats[key] == ref_stats[key] == \
            {"rejected": len(reqs) - 1, "n_requests": 1}[key]
    with pytest.raises(AdmissionFull):
        run_open_loop(engine, reqs, drop_on_full=False)
    engine.drain()


def test_open_loop_with_arrivals_serves_everything(setup, port_params):
    cfg, _, reqs = setup
    engine = _engine(setup, port_params, hold_k=2, hold_ms=2.0,
                     prefill_chunk=8)
    timed = [dict(r, arrival_s=0.002 * i, deadline_s=60.0)
             for i, r in enumerate(reqs)]
    out, stats = run_open_loop(engine, timed)
    ref, _ = _engine(setup, port_params).serve_requests(reqs)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert stats["n_requests"] == len(reqs)
    assert stats["deadline_misses"] == 0.0


# ---------------------------------------------------------------------------
# Cancellation and status
# ---------------------------------------------------------------------------


def test_cancel_queued_and_completed(setup, port_params):
    cfg, _, reqs = setup
    engine = _engine(setup, port_params, n_slots=2)
    handles = [engine.submit(r) for r in reqs[:4]]
    assert handles[3].cancel()                    # still queued
    assert handles[3].status == "cancelled"
    assert not handles[3].cancel()                # already gone
    engine.drain()
    with pytest.raises(RequestCancelled):
        handles[3].result()
    assert not handles[0].cancel()                # completed: too late
    assert engine.stats()["cancelled"] == 1.0
    assert engine.stats()["pages_free"] == engine.stats()["pages_total"]


def test_cancel_matches_jax(setup):
    """One request cancelled mid-decode, one mid-chunk and one queued:
    the survivors' items and the counters (``cancelled`` included) are
    the JAX engine's."""
    cfg, params, reqs = setup

    def script(engine, base):
        hs = [engine.submit(r, base_s=base) for r in reqs]
        engine.step()
        statuses = [h.status for h in hs]
        assert statuses == ["running"] * 3 + ["queued"] * 2
        assert hs[0].cancel() and hs[4].cancel()
        engine.step()
        assert hs[2].cancel()
        engine.drain()
        return hs

    ref, out, ref_counts, our_counts = drive_both(
        params, cfg, script, batch_size=4, n_slots=3, use_fp8=False,
        page_size=PAGE, prefill_chunk=8, prefix_cache=True)
    assert_same_handles(ref, out)
    assert our_counts == ref_counts and our_counts["cancelled"] == 3


@pytest.mark.parametrize("cancel_ids,pre_steps", [
    ((0, 4), 0), ((1, 3), 1), ((4,), 2), ((0, 1, 2, 3), 3), ((2,), 5)])
def test_cancel_releases_slots_pages_and_pins(setup, port_params,
                                              cancel_ids, pre_steps):
    """Cancelling requests queued, mid-chunked-prefill or mid-decode
    leaves no slot, page or prefix pin held: after the drain every store
    entry is unpinned and, once the store is emptied, every page is free;
    the survivors' items are the uncancelled run's."""
    cfg, _, reqs = setup
    ref, _ = _engine(setup, port_params).serve_requests(reqs)
    engine = _engine(setup, port_params, prefill_chunk=8, prefix_cache=True)
    handles = [engine.submit(r) for r in reqs]
    for _ in range(pre_steps):
        engine.step()
    cancelled = {i for i in cancel_ids if handles[i].cancel()}
    engine.drain()
    assert engine.pool.n_used == 0 and engine.pool.n_free == engine.n_slots
    store = engine.prefix_store
    assert all(e.refcount == 0 for e in store._entries.values())
    while store.evict_for_pages():
        pass
    stats = engine.stats()
    assert stats["pages_free"] == stats["pages_total"] > 0
    for i, (h, item) in enumerate(zip(handles, ref)):
        if i in cancelled:
            assert h.status == "cancelled" and h.poll() is None
        else:
            assert h.status == "done"
            np.testing.assert_array_equal(h.poll().item, item)


def test_status_moves_queued_running_done(setup, port_params):
    cfg, _, reqs = setup
    engine = _engine(setup, port_params, n_slots=1)
    handles = [engine.submit(r) for r in reqs[:2]]
    assert [h.status for h in handles] == ["queued", "queued"]
    assert all(h.poll() is None for h in handles)
    engine.step()
    assert [h.status for h in handles] == ["running", "queued"]
    assert engine.busy
    while engine.busy:
        engine.step()
    assert [h.status for h in handles] == ["done", "done"]
    assert handles[1].result() is handles[1].poll().item
    assert handles[0].rid == 0 and handles[1].rid == 1


# ---------------------------------------------------------------------------
# Deadlines, refused settings, shims, launcher
# ---------------------------------------------------------------------------


def test_sla_stats_match_jax(setup):
    """Misses count against requests WITH deadlines, per class: one past
    at ``base_s``, one far, one without."""
    cfg, params, reqs = setup
    staged = [dict(reqs[0], deadline_s=-0.001),
              dict(reqs[1], deadline_s=1000.0, priority=1),
              dict(reqs[2])]

    def script(engine, base):
        hs = [engine.submit(r, base_s=base) for r in staged]
        engine.drain()
        return hs

    ref, out, _, _ = drive_both(params, cfg, script, batch_size=4, n_slots=3,
                                use_fp8=False, page_size=PAGE)
    assert_same_handles(ref, out)
    ours = ServingEngine._sla_stats([h.completion for h in out])
    theirs = JaxServingEngine._sla_stats([h.completion for h in ref])
    assert ours.keys() == theirs.keys()
    assert ours["deadline_misses"] == theirs["deadline_misses"] == 1.0
    assert ours["deadline_miss_rate"] == theirs["deadline_miss_rate"] == 0.5
    assert ours["class_stats"].keys() == theirs["class_stats"].keys()
    for cls, st in theirs["class_stats"].items():
        for key in ("n", "deadline_misses", "deadline_miss_rate"):
            assert ours["class_stats"][cls][key] == st[key], (cls, key)


@pytest.mark.parametrize("setting", [
    dict(hold_k=8, max_queue=4),
    dict(mode="fixed", batch_size=4, max_queue=2),
    dict(store_on_first_sight=False),
    dict(mode="fixed", prefill_chunk=8),
    dict(mode="fixed", preemption=True)])
def test_refused_settings_match_jax(setup, setting):
    """The livelock bounds, second sight without a store and the policy
    knobs outside continuous mode are ``ValueError`` in both engines."""
    cfg, params, _ = setup
    with pytest.raises(ValueError):
        JaxServingEngine(params, jax_cfg(cfg), JaxEngineConfig(**setting))
    with pytest.raises(ValueError):
        ServingEngine({}, cfg, EngineConfig(**setting), device="cpu")


def test_generate_batch_is_the_closed_shim(setup, port_params):
    cfg, _, _ = setup
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 192, size=(3, cfg.history_len
                                        * cfg.n_codebooks)).astype(np.int32)
    profile = rng.normal(size=(3, 64)).astype(np.float32)
    engine = _engine(setup, port_params)
    out = engine.generate_batch(tokens, profile)
    ref, _ = engine.serve_requests([{"tokens": t, "profile": p}
                                    for t, p in zip(tokens, profile)])
    np.testing.assert_array_equal(out, np.stack(ref))


@pytest.mark.parametrize("layout", [["--paged"],
                                    ["--paged", "--fused-decode", "off"],
                                    []],
                         ids=["paged", "paged-unfused", "contiguous"])
def test_launcher_policy_flags(layout, capsys):
    argv = ["--reduced", "--requests", "6", "--batch", "3", "--ragged",
            "--kv-fp8", "--device", "cpu", "--prefix-cache",
            "--prefix-rows", "8", "--prefill-chunk", "8", "--preemption",
            "--hold-k", "2", "--hold-ms", "5", "--max-queue", "6"]
    outs, stats = serve.main(argv + layout)
    assert len(outs) == 6 and stats["n_requests"] == 6
    assert stats["resume_calls"] > 0
    printed = capsys.readouterr().out
    assert "prefix cache: hit-rate" in printed and "preemptions=" in printed
    outs, stats = serve.main(argv + layout + ["--rate", "200",
                                              "--second-sight"])
    assert sum(o is not None for o in outs) + stats["rejected"] == 6
    assert "open loop @ 200.0 req/s" in capsys.readouterr().out


def test_launcher_refuses_unfused_flag_without_paged_only_for_auto():
    argv = ["--reduced", "--requests", "2", "--batch", "2", "--device",
            "cpu"]
    with pytest.raises(SystemExit):
        serve.main(argv + ["--fused-decode", "auto"])
    outs, stats = serve.main(argv + ["--fused-decode", "off"])
    assert stats["fused_decode_mode"] == "off" and len(outs) == 2


def test_reduced_config_serves_a_return_visit_from_the_store():
    """The launcher's config at its default capacity: a return visit (the
    same profile, the history grown by one item) hits the first visit's
    stored prefix and resumes only the new tokens."""
    cfg = onerec_v2.reduced_config()
    from repro_torch.models.onerec import init_onerec
    engine = ServingEngine(init_onerec(0, cfg, device="cpu"), cfg,
                           EngineConfig(batch_size=2, prefix_cache=True),
                           device="cpu")
    rng = np.random.default_rng(0)
    first = {"tokens": rng.integers(0, 192, size=15).astype(np.int32),
             "profile": rng.normal(size=64).astype(np.float32)}
    engine.serve_requests([first])
    back = dict(first, tokens=np.concatenate(
        [first["tokens"], [5, 6, 7]]).astype(np.int32))
    _, stats = engine.serve_requests([back])
    assert stats["prefix_hits"] == 1 and stats["prefix_tokens_saved"] == 15
    assert stats["resume_calls"] == 1 and stats["cow_copies"] == 1
