"""The port's prefix store and resume prefill against the JAX package's, on
the CPU.

* Resume fill (``layers/attention.py`` through the executor): a first
  segment prefilled, the rest resumed at per-row offsets, then two decode
  steps, in the contiguous layout and in the paged layout (gathered view,
  decode unfused), bf16 and fp8 KV, on ``reduced_config()``.  Tolerance:
  1e-5 of the max |logit|, the bound ``tests/test_torch_model.py`` holds
  the reduced config to (f32 summation order only); every pool leaf equal
  (fp8 payloads byte for byte).  The port's resume fill is also held to
  its own full fill (``tests/test_prefix_cache.py``'s JAX counterpart).
* The store (``serving/kv_cache.py``): digests byte-identical to JAX's,
  and seeded random sequences of insert / lookup / acquire / release /
  evict through both stores give the same answers and stats, arena and
  page mode, with and without the second-sight doorkeeper.
* The engine: a warm prefix store (case b) in both layouts, and
  second-sight admission (case g), token-identical with equal counters.

The JAX side runs op by op (``jax.disable_jit``), as in
``tests/test_torch_engine.py``.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (assert_same_runs, jax_cfg, paged_test_cfg,
                           policy_requests, serve_both, torch_params)
from repro.models import onerec as jax_onerec
from repro.serving import kv_cache as jax_kv
from repro.serving.executor import PhaseExecutor as JaxExecutor
from repro_torch.configs import onerec_v2
from repro_torch.layers.attention import (AttnSpec, KVWrite, apply_attention,
                                          init_attention, init_cache)
from repro_torch.models import onerec
from repro_torch.serving import kv_cache
from repro_torch.serving.executor import PhaseExecutor

PAGE = 8
SLOTS = (2, 0, 3)           # non-identity slot placement, slot 1 stays empty
FIRST = (6, 3, 9)           # first-segment tokens of each row


@pytest.fixture(scope="module")
def reduced_params():
    return jax_onerec.init_onerec(jax.random.PRNGKey(1),
                                  jax_cfg(onerec_v2.reduced_config()))


def _executors(params, cfg, paged, kv):
    kw = dict(n_slots=4, use_fp8=False, kv_dtype=kv, paged=paged)
    if paged:
        kw.update(page_size=PAGE, n_pages=4 * -(-(cfg.context_len + 1)
                                                // PAGE))
    jex = JaxExecutor(params, jax_cfg(cfg), fused_decode=False, **kw)
    tex = PhaseExecutor(torch_params(params), cfg,
                        device=torch.device("cpu"), fused_decode=False, **kw)
    return jex, tex


def _histories(cfg, seed):
    rng = np.random.default_rng(seed)
    n_hist = cfg.history_len * cfg.n_codebooks
    hists = [rng.integers(0, cfg.vocab_size - 64, size=n).astype(np.int32)
             for n in (n_hist - 5, 7, n_hist)]
    profs = [rng.normal(size=onerec.PROFILE_DIM).astype(np.float32)
             for _ in hists]
    return hists, profs


def _assert_close(ours, theirs, rows):
    dev = np.abs(ours[rows] - theirs[rows]).max()
    assert dev <= 1e-5 * np.abs(theirs[rows]).max(), dev


def _assert_pools_equal(tex, jex):
    for si, stack in tex.cache["stacks"].items():
        for key, leaves in stack.items():
            for name, leaf in leaves.items():
                ref = np.asarray(jex.cache["stacks"][si][key][name])
                if leaf.dtype == torch.float8_e4m3fn:
                    np.testing.assert_array_equal(
                        leaf.view(torch.uint8).numpy(), ref.view(np.uint8))
                elif name == "pos":
                    np.testing.assert_array_equal(leaf.numpy(), ref)


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"],
                         ids=["bf16kv", "fp8kv"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_resume_fill_and_unfused_decode_match_jax(reduced_params, paged, kv):
    """Prefill a first segment of three ragged rows into non-identity
    slots, resume the rest at per-row offsets, then two decode steps
    teacher-forced with the JAX arm's greedy tokens (paged: through the
    gathered view on both sides)."""
    cfg = onerec_v2.reduced_config()
    jex, tex = _executors(reduced_params, cfg, paged, kv)
    hists, profs = _histories(cfg, 4)
    slots = list(SLOTS)
    if paged:
        for ex in (jex, tex):
            for s, h in zip(slots, hists):
                assert ex.grant_slot(s, len(h) + 1 + ex.branch_stride)
    heads = [h[:n] for h, n in zip(hists, FIRST)]
    tails = [h[n:] for h, n in zip(hists, FIRST)]
    starts = [n + 1 for n in FIRST]               # + the profile token
    with jax.disable_jit():
        jex.prefill_insert(heads, profs, slots)
        theirs = np.asarray(jex.resume_prefill(tails, slots, starts))
    tex.prefill_insert(heads, profs, slots)
    ours = tex.resume_prefill(tails, slots, starts).numpy()
    _assert_close(ours, theirs, slice(0, 3))
    _assert_pools_equal(tex, jex)
    assert tex.counters["resume_calls"] == 1

    lengths = np.zeros(4, np.int32)
    toks = np.zeros((4, 1), np.int32)
    lengths[slots] = [len(h) + 1 for h in hists]
    toks[slots, 0] = np.argmax(theirs[:3], -1)
    for _ in range(2):
        with jax.disable_jit():
            theirs = np.asarray(jex.decode(toks, lengths))
        ours = tex.decode(toks, lengths).numpy()
        _assert_close(ours, theirs, slots)
        lengths[slots] += 1
        toks[slots, 0] = np.argmax(theirs[slots], -1)
    _assert_pools_equal(tex, jex)
    assert tex.counters["fused_decode_steps"] == 0


def test_resume_fill_matches_full_fill():
    """The port's layer: filling [0..L) in one shot == filling [0..p) then
    resuming [p..L): identical stored K/V and positions, matching outputs
    at the suffix positions (``tests/test_prefix_cache.py``'s JAX test,
    with its tolerance)."""
    spec = AttnSpec(n_heads=4, n_kv_heads=2, head_dim=8)
    gen = torch.Generator().manual_seed(0)
    params = init_attention(gen, 32, spec)
    b, s_len, t_len = 3, 16, 12
    lengths = np.array([5, 9, 12])
    starts = np.array([2, 4, 6])
    x = torch.randn(b, t_len, 32, generator=gen)
    out_full, cache_full = apply_attention(
        params, x, spec, cache=init_cache(b, s_len, spec,
                                          dtype=torch.float32),
        fill_cache=True, lengths=torch.from_numpy(lengths))
    _, cache_pre = apply_attention(
        params, x[:, :int(starts.max())], spec,
        cache=init_cache(b, s_len, spec, dtype=torch.float32),
        fill_cache=True, lengths=torch.from_numpy(starts))
    suf = lengths - starts
    t = int(suf.max())
    xs = torch.zeros(b, t, 32)
    for i in range(b):
        xs[i, :suf[i]] = x[i, starts[i]:lengths[i]]
    rows, cols = np.nonzero(np.arange(t)[None] < suf[:, None])
    write = KVWrite(torch.from_numpy(rows * s_len + starts[rows] + cols),
                    torch.from_numpy(rows * t + cols))
    out_res, cache_res = apply_attention(
        params, xs, spec, cache=cache_pre, fill_cache=True,
        lengths=torch.from_numpy(suf), starts=torch.from_numpy(starts),
        kv_write=write)
    for i in range(b):
        n = lengths[i]
        assert torch.equal(cache_full["pos"][i, :n], cache_res["pos"][i, :n])
        assert (cache_res["pos"][i, n:] == -1).all()
        assert torch.equal(cache_full["k"][i, :n], cache_res["k"][i, :n])
        assert torch.equal(cache_full["v"][i, :n], cache_res["v"][i, :n])
        np.testing.assert_allclose(out_full[i, starts[i]:n].numpy(),
                                   out_res[i, :suf[i]].numpy(),
                                   rtol=2e-5, atol=2e-6)


# ---------------------------------------------------------------------------
# The store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_codebooks,n_tokens", [(3, 0), (3, 14), (2, 9)])
def test_prefix_hash_chain_digests_equal_jax(n_codebooks, n_tokens):
    rng = np.random.default_rng(n_tokens)
    prof = rng.normal(size=64).astype(np.float32)
    toks = rng.integers(0, 1000, size=n_tokens).astype(np.int32)
    ours = list(kv_cache.prefix_hash_chain(prof, toks, n_codebooks))
    assert ours == list(jax_kv.prefix_hash_chain(prof, toks, n_codebooks))
    assert len(ours) == n_tokens // n_codebooks


def _store_ops(mod, seed, page_mode, first_sight):
    """One seeded random op sequence through ``mod``'s store; returns the
    transcript of answers and stats."""
    rng = np.random.default_rng(seed)
    log = []
    released = []
    store = mod.PrefixStore(
        5, 100, max_bytes=1400 if page_mode else 400, n_codebooks=3,
        store_on_first_sight=first_sight, seen_capacity=40,
        release_pages=released.append if page_mode else None)
    profs = [np.full(4, p, np.float32) for p in range(3)]
    base = [rng.integers(0, 50, size=24).astype(np.int32) for _ in profs]
    live = []
    next_page = [0]
    for _ in range(120):
        op = rng.integers(0, 6)
        p = int(rng.integers(0, 3))
        n_items = int(rng.integers(1, 9))
        toks = base[p][:3 * n_items]
        if rng.random() < 0.2:       # a history that diverges at its end
            toks = np.concatenate([toks[:-3], [99, 98, 97]]).astype(np.int32)
        if op <= 1:
            n_tok = 3 * int(rng.integers(1, n_items + 1))
            e = store.insert(profs[p], toks, n_tok, force=bool(op == 1
                             and rng.random() < 0.3))
            if e is not None and page_mode:
                e.pages = list(range(next_page[0],
                                     next_page[0] + 1 + n_tok // 8))
                next_page[0] += len(e.pages)
            if e is not None:
                live.append(e)
            log.append(("insert", None if e is None else
                        (e.key, e.row, e.n_tokens)))
        elif op == 2:
            hit = store.lookup_longest(profs[p], toks,
                                       max_tokens=len(toks) - 1)
            log.append(("lookup", None if hit is None else
                        (hit[0].key, hit[1])))
            store.note_admission(None if hit is None else hit[1])
        elif op == 3 and live:
            e = live[int(rng.integers(0, len(live)))]
            if store.is_live(e):
                store.acquire(e)
            log.append(("acquire", e.key, store.is_live(e)))
        elif op == 4:
            pinned = [e for e in live if e.refcount > 0]
            if pinned:
                e = pinned[int(rng.integers(0, len(pinned)))]
                store.release(e)
                log.append(("release", e.key))
        elif page_mode:
            log.append(("evict", store.evict_for_pages()))
        log.append((store.n_entries, store.bytes_used, store.bytes_pinned))
    log.append(("stats", store.admissions, store.hits, store.tokens_saved,
                store.evictions, store.insertions, store.first_sights,
                store.peak_bytes_pinned, store.hit_rate))
    log.append(("released", released))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("first_sight", [True, False],
                         ids=["first-sight", "second-sight"])
@pytest.mark.parametrize("page_mode", [False, True], ids=["arena", "pages"])
def test_store_ops_match_jax(seed, page_mode, first_sight):
    ours = _store_ops(kv_cache, seed, page_mode, first_sight)
    theirs = _store_ops(jax_kv, seed, page_mode, first_sight)
    assert ours == theirs
    kinds = {entry[0] for entry in ours if isinstance(entry[0], str)}
    assert {"insert", "lookup", "acquire"} <= kinds
    assert any(e[0] == "lookup" and e[1] is not None for e in ours)


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_setup():
    cfg = paged_test_cfg()
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(cfg))
    return cfg, params, policy_requests(cfg, 5, seed=11)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_warm_prefix_store_matches_jax(engine_setup, paged):
    """Case (b): a cold pass stores every history, the warm pass hits
    (paged: mapped pages and one COW boundary page; contiguous: arena row
    copies) and resumes the suffix; fp8 KV, so the stored bytes must
    round-trip."""
    cfg, params, reqs = engine_setup
    runs = serve_both(params, cfg, reqs, passes=2, batch_size=4, n_slots=3,
                      use_fp8=False, kv_dtype="float8_e4m3fn",
                      page_size=PAGE, paged=paged, prefix_cache=True)
    assert_same_runs(runs)
    warm = runs[1][3]
    assert warm["prefix_hits"] == len(reqs) and warm["resume_calls"] > 0
    assert warm["cow_copies" if paged else "prefix_row_copies"] > 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_second_sight_matches_jax(engine_setup, paged):
    """Case (g): the first pass only records digests, the second stores,
    the third hits."""
    cfg, params, reqs = engine_setup
    runs = serve_both(params, cfg, reqs[:3], passes=3, batch_size=4,
                      n_slots=3, use_fp8=False, page_size=PAGE, paged=paged,
                      prefix_cache=True, store_on_first_sight=False)
    assert_same_runs(runs)
    assert [r[3]["prefix_hits"] for r in runs] == [0, 0, 3]
