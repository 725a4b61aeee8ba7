"""Gradients, AdamW and the training step of the port against the JAX
package (ROADMAP.md queue N, item N9b): reduced OneRec-V2 here, the MoE LM
and the EGNN in ``test_torch_train_models.py``, the recsys family in
``test_torch_train_recsys.py`` (one file each, to keep each under a
minute: the op-by-op JAX gradient dominates).

* Gradient parity: ``jax.value_and_grad`` run op by op
  (``jax.disable_jit``) against ``tree.value_and_grad`` on the CPU, from
  the same weights (``weights.py``): the loss within ``LOSS_REL``, the
  gradients within relative L2 ``GRAD_REL_L2`` (``_torch_parity``'s
  ``check_grads`` says how).
* AdamW: both packages update from the same numpy gradients over 3 steps
  across the warmup: bit-identical params, ``mu`` and ``nu`` with
  clipping off; with clipping on within ``CLIP_ULPS`` f32 ulps
  (``global_norm``'s reduction order; measured: 0).
* ``remat`` on and off give bit-identical losses and gradients.
* The train bundles the other files do not step take a step: finite
  loss, params moved, the step counter advanced.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_takes_a_step, check_grads, flat_numpy,
                           jax_cfg, jax_value_and_grad, to_numpy,
                           torch_params)
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import steps
from repro_torch.optim import (OptimizerConfig, adamw_init, adamw_update,
                               global_norm)

CLIP_ULPS = 4


def _onerec_case(remat: bool = False):
    from repro.models import onerec as jax_onerec
    from repro_torch.data.onerec_data import (OneRecStreamConfig,
                                              SemanticIDStream)
    from repro_torch.models import onerec
    cfg = registry.get_arch("onerec-v2").reduced_config()
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, remat=remat))
    jcfg = jax_cfg(cfg)
    raw = jax_onerec.init_onerec(jax.random.PRNGKey(0), jcfg)
    b = SemanticIDStream(OneRecStreamConfig(
        codebook_size=cfg.vocab_size - 64, history_len=cfg.history_len,
        global_batch=4, n_interests=8)).batch_at(0)
    keys = ("tokens", "profile", "labels")
    return (cfg, jcfg, raw, {k: b[k] for k in keys}, onerec.train_loss,
            jax_onerec.train_loss)


def test_onerec_gradients_match_jax():
    cfg, jcfg, raw, batch, loss, jloss = _onerec_case()
    assert (batch["labels"] < 0).any() and (batch["labels"] >= 0).any()
    theirs = jax_value_and_grad(jloss, raw, {k: jnp.asarray(v)
                                             for k, v in batch.items()}, jcfg)
    ours = tree.value_and_grad(loss, torch_params(raw),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg)
    check_grads(ours, theirs)


def test_remat_gives_the_same_loss_and_gradients():
    """``cfg.remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``): bit-identical loss and gradients."""
    runs = []
    for remat in (False, True):
        cfg, _, raw, batch, loss, _ = _onerec_case(remat)
        runs.append(tree.value_and_grad(
            loss, torch_params(raw),
            {k: torch.from_numpy(v) for k, v in batch.items()}, cfg))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    for (path, a), (_, b) in zip(tree.leaves_with_path(g0),
                                 tree.leaves_with_path(g1)):
        assert torch.equal(a, b), path


# -- AdamW --------------------------------------------------------------------

def _opt_tree(rng):
    """Leaves of every kind AdamW treats apart: 2-D and stacked (decayed),
    1-D (not), keys whose sort order is not their insertion order."""
    return {"stacks": {"10": {"w": rng.normal(size=(3, 8, 5))},
                       "2": {"scale": rng.normal(size=(3, 8))}},
            "head": {"kernel": rng.normal(size=(8, 4)),
                     "bias": rng.normal(size=(4,))}}


def _cast(t, fn):
    return {k: _cast(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


def _adamw_both(clip_norm: float):
    from repro.optim import adamw_init as jax_init
    from repro.optim import adamw_update as jax_update
    from repro.optim import OptimizerConfig as JaxOptimizerConfig
    fields = dict(lr=1e-2, warmup_steps=2, total_steps=10,
                  clip_norm=clip_norm)
    rng = np.random.default_rng(0)
    p0 = _cast(_opt_tree(rng), lambda a: a.astype(np.float32))
    jp = _cast(p0, jnp.asarray)
    tp = _cast(p0, torch.from_numpy)
    js, ts = jax_init(jp), adamw_init(tp)
    for _ in range(3):
        g = _cast(_opt_tree(rng), lambda a: (a * 3).astype(np.float32))
        with jax.disable_jit():
            jp, js, _ = jax_update(jp, _cast(g, jnp.asarray), js,
                                   JaxOptimizerConfig(**fields))
        tp, ts, metrics = adamw_update(tp, _cast(g, torch.from_numpy), ts,
                                       OptimizerConfig(**fields))
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    return ({"params": jp, "mu": js["mu"], "nu": js["nu"]},
            {"params": tp, "mu": ts["mu"], "nu": ts["nu"]})


def _ulps(ours, theirs):
    worst = 0
    for path, ref in flat_numpy(to_numpy(theirs)).items():
        got = dict(tree.leaves_with_path(ours))[path].numpy()
        ref = np.asarray(ref, np.float32)
        assert got.dtype == np.float32
        worst = max(worst, int(np.abs(got.view(np.int32).astype(np.int64)
                                      - ref.view(np.int32)).max()))
    return worst


def test_adamw_bit_identical_without_clipping():
    theirs, ours = _adamw_both(clip_norm=0.0)
    for name in ("params", "mu", "nu"):
        assert _ulps(ours[name], theirs[name]) == 0, name


def test_adamw_with_clipping_within_ulps():
    theirs, ours = _adamw_both(clip_norm=1.0)
    for name in ("params", "mu", "nu"):
        assert _ulps(ours[name], theirs[name]) <= CLIP_ULPS, name


def test_global_norm_walks_the_jax_order():
    from repro.optim import global_norm as jax_global_norm
    rng = np.random.default_rng(1)
    g = _cast(_opt_tree(rng), lambda a: a.astype(np.float32))
    ours = float(global_norm(_cast(g, torch.from_numpy)))
    with jax.disable_jit():
        theirs = float(jax_global_norm(_cast(g, jnp.asarray)))
    assert [p for p, _ in tree.leaves_with_path(g)] != [
        "/".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(g)[0]]
    assert np.float32(ours) == np.float32(theirs) or \
        abs(ours - theirs) <= 2 * np.spacing(np.float32(theirs))


# -- the train bundles --------------------------------------------------------

# the train cells no other test steps: OneRec-V2, the MoE LMs (shared
# experts and their gate; a leading dense layer), gemma3's windows and tied
# embeddings (the LM, recsys and GNN cells: tests/test_torch_zoo.py,
# test_torch_recsys.py, test_torch_gnn.py)
TRAIN_CELLS = [("onerec-v2", "onerec"), ("qwen2-moe-a2.7b", "lm"),
               ("deepseek-moe-16b", "lm"), ("gemma3-1b", "lm")]


@pytest.mark.parametrize("arch,family", TRAIN_CELLS)
def test_train_bundle_takes_a_step(arch, family):
    shape = next(n for n, s in registry.get_arch(arch).SHAPES.items()
                 if s.kind == "train")
    b = steps.build_bundle(arch, shape, reduced=True, device="cpu",
                           shape_override=steps.SMOKE_SHAPES[family]["train"])
    assert_takes_a_step(b)
    assert set(b.fn.metrics) == {"grad_norm", "lr"}
