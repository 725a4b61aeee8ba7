"""The sharded train step of the transformer family (ROADMAP.md queue N,
item N9e.3) against one rank and against the JAX package: gloo ranks on the
CPU, spawned once (one world-4 job; the rank bodies are
``tests/_torch_dist.py::train_job``), params and AdamW state laid out by
``steps.params_axes`` under ``TRAIN_RULES`` on (1, 4) and (2, 2) and under
``TRAIN_RULES_FSDP`` on (2, 2): weights stored sharded over ``data`` (and
``model`` under the FSDP rules), gathered where they are used, gradients
summed back onto the storage shards.

* Reduced OneRec-V2 (JAX init, bridged through ``weights.py``; ``remat``
  on, so a layer's weights are gathered again in the backward's
  recompute): one step's loss, every gradient gathered whole, and the
  params, ``mu`` and ``nu`` after AdamW against the port's world 1 and
  against the JAX package's unsharded ``value_and_grad`` + ``adamw_update``
  under ``jax.disable_jit``.  The loss within ``SHARD_LOSS_REL``: a
  row-parallel product's f32 partials are summed over ranks in another
  association and rounded to bf16 once, and a flipped bf16 rounding moves
  the loss on the order of 1e-5, where ``LOSS_REL`` (1e-5, the unsharded
  parity bar) holds world 1 against JAX on this batch of 4 rows, one a
  rank under the FSDP rules (``test_world1_loss_is_the_jax_loss``; on
  larger batches the two packages' CPU products block their sums
  differently).  The params within two steps of the first step's
  learning rate elementwise (and 4 f32 ulps): the first AdamW update is
  ``lr * g / (|g| + eps)``, so a gradient element near zero whose sign
  differs moves its param by two steps, and nothing else may.  The
  gradients and moments within ``GRAD_REL_L2`` / ``NU_REL_L2`` relative
  L2 (>= 2-D leaves one by one, the 1-D leaves as one vector): the bf16
  model's gradients move ~1e-2 with any change of summation order (world
  1 is held to JAX at 1e-2, ``_torch_parity.GRAD_REL_L2``, for that
  reason; a sharded step sums its products over other rows and ranks),
  so they are held at three times that.  The batch drops no MoE
  assignment at the capacity of the whole batch nor of a data shard's
  rows (asserted: the losses with capacity lifted are the same bits), so
  world 1 on the whole batch is every mesh's reference.
* A reduced dense LM (llama3-8b) and a reduced MoE LM with shared experts,
  their gate and the load-balance loss (qwen2-moe, capacity lifted) against
  the port's world 1 at the same bounds.
* No gradient shard zero on a rank where world 1's slice of it is not; no
  functional collective in the forward or the backward; a rerun
  bit-identical; a rank holds a quarter of the weights under the FSDP
  rules.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import _torch_dist as td
from _torch_dist import (GRAD_REL_L2, NU_REL_L2, PARAM_STEPS,  # noqa: F401
                         SHARD_LOSS_REL, world1_step)
from _torch_dist import check_step as _check_step
from _torch_dist import loss_fn as _loss_fn
from _torch_dist import numpy_ref as _numpy_ref
from _torch_parity import (LOSS_REL, flat_numpy, jax_cfg, jax_value_and_grad,
                           to_numpy, torch_params)
from repro_torch import tree as tree_util
from repro_torch.configs import llama3_8b, onerec_v2, qwen2_moe_a27b
from repro_torch.models import transformer as tfm

B_ONEREC, B_LM, T_LM = 4, 4, 16

CFG = onerec_v2.reduced_config()
CFG = dataclasses.replace(CFG, transformer=dataclasses.replace(
    CFG.transformer, remat=True))
LLAMA = llama3_8b.reduced_config()
QWEN = dataclasses.replace(qwen2_moe_a27b.reduced_config(),
                           aux_loss_weight=0.01, capacity_factor=8.0)
MESHES = [(n_data, n_model, rules)
          for (n_data, n_model), rules in td.TRAIN_MESHES]


def _lifted(cfg):
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, capacity_factor=64.0))


def _onerec_case():
    from repro.models import onerec as jax_onerec
    from repro_torch.data.onerec_data import (OneRecStreamConfig,
                                              SemanticIDStream)
    raw = jax_onerec.init_onerec(jax.random.PRNGKey(0), jax_cfg(CFG))
    b = SemanticIDStream(OneRecStreamConfig(
        codebook_size=CFG.vocab_size - 64, history_len=CFG.history_len,
        global_batch=B_ONEREC, n_interests=8)).batch_at(0)
    return raw, {k: b[k] for k in ("tokens", "profile", "labels")}


def _lm_case(cfg, seed):
    params = tfm.init_transformer(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (B_LM, T_LM), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed + 1))
    return params, {"tokens": tok, "labels": tok}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    raw, ob = _onerec_case()
    cases = [("onerec", "onerec", CFG, torch_params(raw),
              {k: torch.from_numpy(v) for k, v in ob.items()}),
             ("llama", "lm", LLAMA, *_lm_case(LLAMA, 10)),
             ("qwen", "lm", QWEN, *_lm_case(QWEN, 20))]
    ranks = td.run(4, td.train_job, (cases,),
                   str(tmp_path_factory.mktemp("fsdp")))
    ref = {name: world1_step(family, cfg, params, batch)
           for name, family, cfg, params, batch in cases}
    return {"cases": {c[0]: c for c in cases}, "ranks": ranks, "ref": ref,
            "raw": raw, "jax_batch": ob}


@pytest.mark.parametrize("name", ["onerec", "llama", "qwen"])
@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_sharded_step_matches_world1(runs, name, n_data, n_model, rules):
    ref = _numpy_ref(runs["ref"][name])
    for rank in runs["ranks"]:
        _check_step(rank[name, n_data, n_model, rules], ref)


@pytest.fixture(scope="module")
def jax_step(runs):
    """The JAX package's unsharded step, op by op, from the same weights
    and batch: numpy leaves by path."""
    from repro.launch.steps import OPT_CFG as JAX_OPT
    from repro.models import onerec as jax_onerec
    from repro.optim import adamw_init as jax_init
    from repro.optim import adamw_update as jax_update
    jb = {k: jnp.asarray(v) for k, v in runs["jax_batch"].items()}
    loss, grads = jax_value_and_grad(jax_onerec.train_loss, runs["raw"], jb,
                                     jax_cfg(CFG))
    with jax.disable_jit():
        params, opt, _ = jax_update(runs["raw"], grads,
                                    jax_init(runs["raw"]), JAX_OPT)
    return {"loss": float(loss), "grads": flat_numpy(to_numpy(grads)),
            "params": flat_numpy(to_numpy(params)),
            "mu": flat_numpy(to_numpy(opt["mu"])),
            "nu": flat_numpy(to_numpy(opt["nu"]))}


def test_world1_loss_is_the_jax_loss(runs, jax_step):
    """At these 4 rows the port's unsharded loss is the JAX package's
    within ``LOSS_REL`` (the unsharded parity bar)."""
    ours, theirs = float(runs["ref"]["onerec"]["loss"]), jax_step["loss"]
    assert abs(ours - theirs) <= LOSS_REL * abs(theirs), (ours, theirs)


def test_onerec_batch_drops_no_assignment(runs):
    """The losses at the config's capacity, for the whole batch and for
    each data shard's rows, are those with capacity lifted (64x), bit for
    bit: no MoE assignment is dropped at either capacity."""
    _, family, cfg, params, batch = runs["cases"]["onerec"]
    fn, lifted = _loss_fn(family, cfg), _loss_fn(family, _lifted(cfg))
    halves = [{k: v[s] for k, v in batch.items()}
              for s in (slice(0, B_ONEREC // 2), slice(B_ONEREC // 2, None))]
    with torch.no_grad():
        for part in [batch] + halves:
            assert torch.equal(fn(params, part), lifted(params, part))


@pytest.mark.parametrize("n_data,n_model,rules", MESHES)
def test_onerec_sharded_step_matches_jax(runs, jax_step, n_data, n_model,
                                         rules):
    for rank in runs["ranks"]:
        _check_step(rank["onerec", n_data, n_model, rules], jax_step)


@pytest.mark.parametrize("name", ["onerec", "llama", "qwen"])
def test_no_gradient_shard_left_zero(runs, name):
    """Each rank's local shard of every gradient is nonzero wherever world
    1's slice of it is (a cut graph would fill zeros)."""
    ref = dict(tree_util.leaves_with_path(runs["ref"][name]["grads"]))
    for rank in runs["ranks"]:
        for key, res in rank.items():
            if isinstance(key, str) or key[0] != name:
                continue
            for path, (local, ranges) in tree_util.leaves_with_path(
                    res["local"]):
                want = ref[path]
                for dim, (off, n) in enumerate(ranges):
                    want = want.narrow(dim, off, n)
                if bool(want.ne(0).any()):
                    assert bool(local.ne(0).any()), (key, path)


def test_no_functional_collective_and_a_rerun_bit_identical(runs):
    for rank in runs["ranks"]:
        for key, res in rank.items():
            if not isinstance(key, str):
                assert res["functional"] == [], (key, res["functional"])
        first = rank["onerec", 1, 4, "train"]
        again = first["rerun"]
        assert torch.equal(first["loss"], again["loss"])
        for what in ("grads", "params", "mu", "nu"):
            for (path, a), (_, b) in zip(
                    tree_util.leaves_with_path(first[what]),
                    tree_util.leaves_with_path(again[what])):
                assert torch.equal(a, b), (what, path)


@pytest.mark.parametrize("case", ["psum", "fan", "gather", "sum_scatter",
                                  "keep"])
def test_collective_backward_is_its_transpose(runs, case):
    """``sharding.psum`` (backward the identity), ``fan`` (a sum),
    ``gather`` (a reduce-scatter), ``sum_scatter`` (an all-gather) and
    ``redistribute``'s ``Replicate -> Shard`` slice (an all-gather), each
    against the gradient worked by hand, on every rank."""
    for rank in runs["ranks"]:
        got, want = rank["transposes"][case]
        assert torch.equal(got, want), (case, got, want)


def test_train_bundle_steps_on_a_mesh(runs):
    """The OneRec-V2 train bundle laid out by ``steps.shard_args`` under
    ``TRAIN_RULES_FSDP`` takes a step through its own ``fn``: the same
    finite loss and clip norm on every rank, the counter at 1, every
    kernel moved."""
    first = runs["ranks"][0]["bundle"]
    for rank in runs["ranks"]:
        got = rank["bundle"]
        assert bool(torch.isfinite(got["loss"])) and got["step"] == 1
        assert got["moved"]
        assert torch.equal(got["loss"], first["loss"])
        assert torch.equal(got["grad_norm"], first["grad_norm"])


def test_fsdp_rank_holds_a_quarter_of_the_weights(runs):
    """Under ``TRAIN_RULES_FSDP`` on (2, 2) every weight whose
    ``embed_fsdp`` axis splits four ways is stored a quarter a rank
    (``sharded_step``'s local gradient shards have the stored layout)."""
    full = dict(tree_util.leaves_with_path(runs["ref"]["onerec"]["grads"]))
    for rank in runs["ranks"]:
        res = rank["onerec", 2, 2, "train_fsdp"]
        for path, (local, _) in tree_util.leaves_with_path(res["local"]):
            if path.endswith(("q_proj/kernel", "o_proj/kernel",
                              "experts/gate", "experts/down",
                              "lm_head/kernel", "embed/table")):
                assert local.numel() * 4 == full[path].numel(), path
