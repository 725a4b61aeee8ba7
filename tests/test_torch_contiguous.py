"""The port's contiguous slot-pool layout against the JAX package's, on the
CPU: per-slot decode (kernel ``batch_attention``'s plain version, or the
plain masked softmax) and the serving engine with every select through
kernel ``radix_topk``'s plain version.

The JAX side runs op by op (``jax.disable_jit``), its Pallas kernels in
interpret mode, as in ``tests/test_torch_model.py`` and
``tests/test_torch_engine.py``.  Tolerances:
  * decode logits on ``reduced_config()``: 1e-5 of the max |logit|, the
    bound ``tests/test_torch_model.py`` holds the reduced config to (f32
    summation order only);
  * engine completions: token-identical, with the same batches (prefill
    programs, decode steps, selects, padded rows).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import jax_cfg, paged_test_cfg, torch_params
from repro.models import onerec as jax_onerec
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.executor import PhaseExecutor as JaxExecutor
from repro.serving.requests import make_request
from repro_torch.configs import onerec_v2
from repro_torch.kernels.batch_attention import ops as attn_ops
from repro_torch.kernels.radix_topk import ops as topk_ops
from repro_torch.launch import serve
from repro_torch.models import onerec
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.executor import PhaseExecutor

SEED = 23
SLOTS = (2, 0, 3)           # non-identity slot placement, slot 1 stays empty


def _with_kernel(cfg, use_kernel: bool):
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, use_attention_kernel=use_kernel))


@pytest.fixture(scope="module")
def reduced_params():
    return jax_onerec.init_onerec(jax.random.PRNGKey(1),
                                  jax_cfg(onerec_v2.reduced_config()))


@pytest.mark.parametrize("fp8,kv", [(False, "bfloat16"),
                                    (True, "float8_e4m3fn")],
                         ids=["bf16w-bf16kv", "fp8w-fp8kv"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-softmax", "batch_attention"])
def test_slot_prefill_and_decode_logits_match(reduced_params, use_kernel,
                                              fp8, kv):
    """Prefill three ragged requests into non-identity slots of the
    contiguous pool, then two decode steps teacher-forced with the JAX
    arm's greedy tokens; the free slot rides along at index 0."""
    cfg = _with_kernel(onerec_v2.reduced_config(), use_kernel)
    kw = dict(n_slots=4, use_fp8=fp8, kv_dtype=kv)
    jex = JaxExecutor(reduced_params, jax_cfg(cfg), paged=False, **kw)
    tex = PhaseExecutor(torch_params(reduced_params), cfg,
                        device=torch.device("cpu"), paged=False, **kw)
    rng = np.random.default_rng(4)
    n_hist = cfg.history_len * cfg.n_codebooks
    hists = [rng.integers(0, cfg.vocab_size - 64, size=n).astype(np.int32)
             for n in (n_hist - 5, 7, n_hist)]
    profs = [rng.normal(size=onerec.PROFILE_DIM).astype(np.float32)
             for _ in hists]
    with jax.disable_jit():
        theirs = np.asarray(jex.prefill_insert(hists, profs, list(SLOTS)))
    ours = tex.prefill_insert(hists, profs, list(SLOTS)).numpy()
    assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max()

    lengths = np.zeros(4, np.int32)
    toks = np.zeros((4, 1), np.int32)
    lengths[list(SLOTS)] = [len(h) + 1 for h in hists]
    toks[list(SLOTS), 0] = np.argmax(theirs[:3], -1)
    before = attn_ops.batch_attention.launches
    for _ in range(2):
        with jax.disable_jit():
            theirs = np.asarray(jex.decode(toks, lengths))
        ours = tex.decode(toks, lengths).numpy()
        live = list(SLOTS)
        dev = np.abs(ours[live] - theirs[live]).max()
        assert dev <= 1e-5 * np.abs(theirs[live]).max(), dev
        lengths[live] += 1
        toks[live, 0] = np.argmax(theirs[live], -1)
    # the CPU runs the plain versions: no kernel launch is counted
    assert attn_ops.batch_attention.launches == before
    # every pool leaf (payload, pos lane, fp8 scales) matches JAX's
    for si, stack in tex.cache["stacks"].items():
        for key, leaves in stack.items():
            for name, leaf in leaves.items():
                ref = np.asarray(jex.cache["stacks"][si][key][name])
                if leaf.dtype == torch.float8_e4m3fn:
                    np.testing.assert_array_equal(
                        leaf.view(torch.uint8).numpy(), ref.view(np.uint8))
                elif name == "pos":
                    np.testing.assert_array_equal(leaf.numpy(), ref)


@pytest.fixture(scope="module")
def workload():
    cfg = _with_kernel(paged_test_cfg(), True)
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(cfg))
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(8):          # test_paged_kv._request_dicts
        n_items = int(rng.integers(2, cfg.history_len + 1))
        reqs.append(make_request(
            rng.integers(0, 192, size=n_items * cfg.n_codebooks),
            rng.normal(size=jax_onerec.PROFILE_DIM)))
    return cfg, params, reqs


@pytest.fixture(scope="module", params=["bfloat16", "float8_e4m3fn"],
                ids=["bf16", "fp8kv"])
def served(request, workload):
    """Both engines, contiguous layout, ``use_attention_kernel`` and
    ``use_radix_topk``, over the same params and requests."""
    cfg, params, reqs = workload
    base = dict(batch_size=4, n_slots=3, use_fp8=False,
                kv_dtype=request.param, paged=False, fused_decode="off",
                use_radix_topk=True)
    jax_engine = JaxServingEngine(params, jax_cfg(cfg),
                                  JaxEngineConfig(**base))
    with jax.disable_jit():
        ref, ref_stats = jax_engine.serve_requests(reqs)
    engine = ServingEngine(torch_params(params), cfg, EngineConfig(**base),
                           device="cpu")
    before = topk_ops.radix_topk.launches
    out, stats = engine.serve_requests(reqs)
    assert topk_ops.radix_topk.launches == before       # plain on the CPU
    return out, stats, ref, ref_stats


def test_engine_token_identical_to_jax(served):
    out, stats, ref, ref_stats = served
    assert len(out) == len(ref) == 8
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    for key in ("prefill_calls", "decode_steps", "select_calls",
                "prefill_padded_rows"):
        assert stats[key] == ref_stats[key], key
    assert stats["select_calls"] == stats["prefill_calls"] \
        + stats["decode_steps"] > 0
    assert stats["fused_decode_steps"] == stats["fused_select_hits"] == 0


def test_engine_stats_layout_matches_jax(served):
    """The layout keys of ``stats()`` read as the JAX contiguous engine's:
    no pages, no fused decode, the same pool bytes."""
    _, stats, _, ref_stats = served
    for key in ("pages_total", "pages_free", "page_size", "kv_bytes_pinned",
                "fused_decode_mode", "kv_dtype", "kv_row_bytes", "kv_bytes",
                "n_slots"):
        assert stats[key] == ref_stats[key], key
    assert stats["fused_decode_mode"] == "off"
    assert stats["pages_total"] == 0.0


def test_contiguous_layout_has_no_fused_decode():
    cfg = onerec_v2.reduced_config()
    for fused in ("auto", True):
        with pytest.raises(ValueError, match="no fused decode"):
            ServingEngine({}, cfg, EngineConfig(paged=False,
                                                fused_decode=fused),
                          device="cpu")


def test_paged_select_through_radix_topk(workload):
    """The paged layout's fused select stash through ``radix_topk``: the
    same completions as through the stable sort."""
    cfg, params, reqs = workload
    outs = []
    for radix in (False, True):
        engine = ServingEngine(torch_params(params), cfg, EngineConfig(
            batch_size=4, n_slots=3, use_fp8=False, page_size=8,
            use_radix_topk=radix), device="cpu")
        out, stats = engine.serve_requests(reqs)
        assert stats["fused_select_hits"] == stats["decode_steps"] > 0
        outs.append(out)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def test_layouts_token_identical_with_capacity_lifted(workload):
    """The contiguous and the paged layout serve the same completions in
    the same batches when MoE capacity cannot drop tokens (plain softmax
    decode in both)."""
    cfg, params, reqs = workload
    cfg = _with_kernel(cfg, False)
    runs = []
    for layout in (dict(page_size=8),
                   dict(paged=False, fused_decode="off")):
        engine = ServingEngine(torch_params(params), cfg, EngineConfig(
            batch_size=4, n_slots=3, use_fp8=False, **layout), device="cpu")
        runs.append(engine.serve_requests(reqs))
    (paged, p_stats), (contig, c_stats) = runs
    for a, b in zip(paged, contig):
        np.testing.assert_array_equal(a, b)
    for key in ("prefill_calls", "decode_steps", "prefill_padded_rows"):
        assert p_stats[key] == c_stats[key], key


def test_launcher_honours_paged(capsys):
    """Without ``--paged`` the launcher serves the contiguous layout and
    prints no paged-KV line; ``--fused-decode auto`` needs ``--paged``."""
    argv = ["--reduced", "--requests", "6", "--batch", "3", "--ragged",
            "--device", "cpu"]
    outs, stats = serve.main(argv)
    assert len(outs) == 6 and stats["pages_total"] == 0.0
    assert stats["fused_decode_mode"] == "off"
    assert "paged KV" not in capsys.readouterr().out
    outs, stats = serve.main(argv + ["--paged"])
    assert stats["pages_total"] > 0 and stats["fused_decode_steps"] > 0
    assert "paged KV" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(argv + ["--fused-decode", "auto"])


def test_paged_prefill_writes_only_real_rows(monkeypatch):
    """A join group of 5 is padded to 8 by duplicating its last request.
    The paged prefill scatters only the 5 real rows (every ``KVWrite.src``
    lies in a real row, every real position is written), and afterwards
    the paged and the contiguous pool hold the same K/V bytes for every
    slot.  The reduced config at its default capacity factor (1.5), fp8
    weights and fp8 KV: in this group the duplicates lose MoE capacity
    where the real row does not, so a scatter that wrote them too would
    leave other bytes on the real row's pages."""
    from repro_torch.serving.requests import build_requests
    cfg = onerec_v2.reduced_config()
    params = onerec.init_onerec(3, cfg, device="cpu")
    reqs = build_requests(cfg, 5, 5, seed=3, ragged=True)
    hists = [np.asarray(r["tokens"]) for r in reqs]
    profs = [np.asarray(r["profile"]) for r in reqs]
    slots = [6, 0, 3, 1, 4]
    kw = dict(n_slots=8, device=torch.device("cpu"),
              kv_dtype="float8_e4m3fn")
    paged = PhaseExecutor(params, cfg, page_size=8, n_pages=40, **kw)
    contig = PhaseExecutor(params, cfg, paged=False, **kw)
    for s, h in zip(slots, hists):
        assert paged.grant_slot(s, len(h) + 3)
    writes = []
    page_write = paged._page_write

    def spy(psc):
        writes.append((psc, page_write(psc)))
        return writes[-1][1]

    monkeypatch.setattr(paged, "_page_write", spy)
    paged.prefill_insert(hists, profs, slots)
    contig.prefill_insert(hists, profs, slots)
    (psc, write), = writes
    b, t_eff = psc.shape
    assert b == 8 and paged.counters["prefill_padded_rows"] == 3
    assert (write.src.numpy() // t_eff < len(slots)).all()
    assert len(write.src) == sum(len(h) + 1 for h in hists)

    ps = paged.page_size
    for pool, rows in zip(paged._pool_leaves(), contig._pool_leaves()):
        assert set(pool) == set(rows) and "k_scale" in pool
        for s, h in zip(slots, hists):
            pos = np.arange(len(h) + 1)
            phys = torch.as_tensor(paged._table_mat[s][pos // ps] * ps
                                   + pos % ps, dtype=torch.int64)
            for name in pool:
                a = pool[name][:, phys]
                c = rows[name][:, s, :len(pos)]
                if a.dtype.is_floating_point and a.element_size() == 1:
                    a, c = a.view(torch.uint8), c.view(torch.uint8)
                assert torch.equal(a, c), (s, name)
