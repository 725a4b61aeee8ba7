"""OneRec generation over the batch-shared cache, the port against the JAX
package, on the CPU: ``generate_items``, ``beam_generate`` (W = 1 and 4)
and ``transformer.decode_fused``, and the shared-index decode step with
``use_attention_kernel`` (kernel ``batch_attention``'s plain version here,
the Pallas kernel in interpret mode there).

The same params (JAX init -> numpy -> ``repro_torch``; unquantized, and
PTQ'd with the paper's policy on both sides) and histories go through
both; the JAX side runs op by op (``jax.disable_jit``), as in the other
parity files.  Tolerances: generated ids token-identical; beam scores
(f32 log-probs summed over three steps) within 1e-5 absolute; decode
logits within 1e-5 of the max |logit| (``tests/test_torch_model.py``'s
bound for the reduced config, f32 summation order only).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import jax_cfg, torch_params
from repro.core.policy import PAPER_POLICY as JAX_PAPER
from repro.core.ptq import quantize_params as jax_quantize_params
from repro.models import onerec as jax_onerec
from repro.models import transformer as jax_tfm
from repro_torch.configs import onerec_v2
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.kernels.batch_attention import ops as attn_ops
from repro_torch.kernels.radix_topk import ops as topk_ops
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm

B = 3
SCORE_ATOL = 1e-5


def _cfg(use_kernel: bool = False):
    cfg = onerec_v2.reduced_config()
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, use_attention_kernel=use_kernel))


@pytest.fixture(scope="module")
def jax_params():
    return jax_onerec.init_onerec(jax.random.PRNGKey(3),
                                  jax_cfg(_cfg()))


def _params(jax_params, fp8: bool):
    """(JAX params, port params): raw f32, or PTQ'd on each side with the
    paper's policy (bit-identical payloads and scales)."""
    if not fp8:
        return jax_params, torch_params(jax_params)
    return (jax_quantize_params(jax_params, JAX_PAPER),
            quantize_params(torch_params(jax_params), PAPER_POLICY))


def _batch(cfg, seed: int, n_items: int = 0):
    rng = np.random.default_rng(seed)
    t = (n_items or cfg.history_len) * cfg.n_codebooks
    tokens = rng.integers(0, cfg.vocab_size - 64, size=(B, t)).astype(
        np.int32)
    profile = rng.normal(size=(B, onerec.PROFILE_DIM)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "profile": jnp.asarray(profile)},
            {"tokens": torch.from_numpy(tokens),
             "profile": torch.from_numpy(profile)})


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16w", "fp8w"])
@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-softmax", "batch_attention"])
def test_generate_items_matches_jax(jax_params, use_kernel, fp8):
    cfg = _cfg(use_kernel)
    jp, tp = _params(jax_params, fp8)
    jb, tb = _batch(cfg, seed=1)
    with jax.disable_jit():
        theirs = np.asarray(jax_onerec.generate_items(jp, jb, jax_cfg(cfg)))
    before = attn_ops.batch_attention.launches
    ours = onerec.generate_items(tp, tb, cfg)
    assert attn_ops.batch_attention.launches == before   # plain on the CPU
    assert ours.dtype == torch.int32 and ours.shape == (B, cfg.decode_len)
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("fp8", [False, True], ids=["bf16w", "fp8w"])
@pytest.mark.parametrize("width", [1, 4])
def test_beam_generate_matches_jax(jax_params, width, fp8):
    """Beams token-identical, scores within 1e-5, sorted by score; a
    history shorter than the context (the shared cache's tail empty)."""
    cfg = _cfg()
    jp, tp = _params(jax_params, fp8)
    jb, tb = _batch(cfg, seed=2, n_items=5)
    with jax.disable_jit():
        j_items, j_scores = jax_onerec.beam_generate(jp, jb, jax_cfg(cfg),
                                                     beam_width=width)
    items, scores = onerec.beam_generate(tp, tb, cfg, beam_width=width)
    assert items.shape == (B, width, cfg.decode_len)
    np.testing.assert_array_equal(items.numpy(), np.asarray(j_items))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores),
                               rtol=0, atol=SCORE_ATOL)
    s = scores.numpy()
    assert (np.diff(s, axis=1) <= 0).all()


def test_beam_of_one_is_greedy(jax_params):
    """``beam_generate(beam_width=1)`` is ``generate_items``, with the
    radix_topk select (its plain version here) as ``topk_fn`` too."""
    cfg = _cfg(use_kernel=True)
    _, tp = _params(jax_params, True)
    _, tb = _batch(cfg, seed=4)
    greedy = onerec.generate_items(tp, tb, cfg, topk_fn=topk_ops.radix_topk)
    items, _ = onerec.beam_generate(tp, tb, cfg, beam_width=1,
                                    topk_fn=topk_ops.radix_topk)
    np.testing.assert_array_equal(items[:, 0].numpy(), greedy.numpy())
    np.testing.assert_array_equal(greedy.numpy(),
                                  onerec.generate_items(tp, tb, cfg).numpy())


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-softmax", "batch_attention"])
def test_decode_fused_matches_jax(jax_params, use_kernel):
    """``transformer.prefill`` then ``decode_fused`` over four steps from
    the prefill's argmax: the tokens token-identical, the caches' pos rows
    equal."""
    cfg = _cfg(use_kernel)
    jb, tb = _batch(cfg, seed=5, n_items=6)
    t = tb["tokens"].shape[1]
    tt = cfg.transformer
    jparams = jax_params["backbone"]
    tparams = torch_params(jax_params)["backbone"]
    with jax.disable_jit():
        jcache = jax_tfm.init_kv_cache(jax_cfg(cfg).transformer, B, t + 8)
        logits, jcache = jax_tfm.prefill(jparams, jb["tokens"],
                                         jax_cfg(cfg).transformer, jcache)
        first = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        j_toks, jcache = jax_tfm.decode_fused(
            jparams, first, jax_cfg(cfg).transformer, jcache, jnp.int32(t), 4)
    tcache = tfm.init_kv_cache(tt, B, t + 8, per_slot=False)
    logits, tcache = tfm.prefill(tparams, tb["tokens"], tt, tcache)
    first = torch.argmax(logits, -1)[:, None].to(torch.int32)
    toks, tcache = tfm.decode_fused(tparams, first, tt, tcache, t, 4)
    assert toks.shape == (B, 4)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(
        tcache["stacks"]["0"]["p0"]["pos"].numpy(),
        np.asarray(jcache["stacks"]["0"]["p0"]["pos"]))


@pytest.mark.parametrize("kv", ["bfloat16", "float8_e4m3fn"],
                         ids=["bf16kv", "fp8kv"])
def test_shared_index_decode_logits_match(jax_params, kv):
    """The shared-index decode with ``use_attention_kernel`` (and an fp8
    cache): prefill, then two steps teacher-forced with the JAX arm's
    greedy tokens; logits within 1e-5 of the max |logit|."""
    cfg = _cfg(use_kernel=True)
    jcfg = jax_cfg(cfg)
    jb, tb = _batch(cfg, seed=6, n_items=4)
    tp = torch_params(jax_params)
    with jax.disable_jit():
        jcache = jax_onerec.init_cache(jcfg, B, dtype=jnp.dtype(kv))
        jl, jcache = jax_onerec.prefill(jax_params, jb, jcfg, jcache)
    tcache = onerec.init_cache(cfg, B, dtype=getattr(torch, kv))
    tl, tcache = onerec.prefill(tp, tb, cfg, tcache)
    index = tb["tokens"].shape[1] + 1
    for step in range(3):
        theirs = np.asarray(jl, np.float32)
        ours = tl.float().numpy()
        assert np.abs(ours - theirs).max() <= 1e-5 * np.abs(theirs).max(), \
            step
        tok = np.argmax(theirs, -1).astype(np.int32)[:, None]
        with jax.disable_jit():
            jl, jcache = jax_onerec.decode_step(
                jax_params, jnp.asarray(tok), jcfg, jcache,
                jnp.int32(index))
        tl, tcache = onerec.decode_step(tp, torch.from_numpy(tok), cfg,
                                        tcache, index)
        index += 1
    leaf = tcache["stacks"]["0"]["p0"]
    assert leaf["pos"].ndim == 2                      # (layers, S): shared
    assert set(leaf) == ({"k", "v", "pos", "k_scale", "v_scale"}
                         if kv != "bfloat16" else {"k", "v", "pos"})
