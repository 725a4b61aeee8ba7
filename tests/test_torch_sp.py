"""Sequence parallelism of the sharded train step (ROADMAP.md queue N,
item N9e.6) against one rank: gloo ranks on the CPU, spawned once (one
world-4 job; the rank bodies are ``tests/_torch_dist.py::sp_job``), params
and AdamW state laid out by ``steps.params_axes`` under
``TRAIN_RULES_SP``: the residual stream between layers split by sequence
over ``model`` (``act_seq``), the layers taking its rows gathered whole
where they use them (``sharding.unsplit``, whose backward keeps the rank's
slice) and their outputs sliced back before the residual add
(``sharding.match``, whose backward gathers).

* A reduced dense LM (llama3-8b), a reduced MoE LM with shared experts,
  their gate and the load-balance loss (qwen2-moe, capacity lifted as in
  ``tests/test_torch_fsdp.py``) and a reduced coder-33b (7 query heads, 1
  KV head: no mesh splits them whole, so every rank runs every head, and
  the gathers of q, k and v keep the rank's slice of their cotangent),
  ``remat`` on, ``T_LM`` = 16 positions (coder on (1, 4) alone)
  (split four ways): one step on (1, 4) and (2, 2) against the port's
  world 1 at ``test_torch_fsdp.py``'s bounds (the loss within
  ``SHARD_LOSS_REL``, every gradient leaf and ``mu`` / ``nu`` within
  ``GRAD_REL_L2`` / ``NU_REL_L2``, params within ``PARAM_STEPS``).
* The residual really split: every layer boundary ``Shard(dim=1)`` on
  ``model`` (the first layer's input, the embedding's output, is whole,
  as in the JAX package), and the gathers'
  tags (``sp-gather``, the MoE's ``ep-gather``, ``keep-bwd``) in
  ``sharding.STATS``; no functional collective in either pass; llama's
  (1, 4) step rerun bit-identical.
* Reduced OneRec-V2 with a history of 7 items runs T + 1 = 25 positions
  ([profile], 21 history and 3 target tokens), which do not split four
  ways (as ``train_b512``'s 385 do not): ``constrain`` drops the split, as
  the JAX one does, and the ``train_sp`` step is its ``train`` step bit
  for bit.
* The bytes autograd saves a layer on a (1, 4) rank under remat (the
  checkpoint's input, ``tfm.count_saved``): under ``train_sp`` a quarter
  of the whole residual that ``train`` saves (measured on OneRec-V2's
  step) for every layer after the first, which takes the whole embedding
  output; nothing else is saved a layer (no non-residual leftover).
* ``unsplit``'s and ``match``'s backward against the gradients worked by
  hand, and the moves each refuses.
"""

import dataclasses
import threading

import pytest
import torch

import _torch_dist as td
from repro_torch import tree as tree_util
from repro_torch.configs import (deepseek_coder_33b, llama3_8b, onerec_v2,
                                 qwen2_moe_a27b)
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm

B_LM, T_LM, B_ONEREC = 4, 16, 4

LLAMA = dataclasses.replace(llama3_8b.reduced_config(), remat=True)
QWEN = dataclasses.replace(qwen2_moe_a27b.reduced_config(),
                           aux_loss_weight=0.01, capacity_factor=8.0,
                           remat=True)
# 7 query heads and 1 KV head: no mesh splits them whole, so every rank
# runs every head
CODER = dataclasses.replace(deepseek_coder_33b.reduced_config(), remat=True)
CONFIGS = {"llama": LLAMA, "qwen": QWEN, "coder": CODER}
# 7 history items and the target's 3 tokens: T + 1 = 25 positions
CFG = dataclasses.replace(onerec_v2.reduced_config(), history_len=7)
CFG = dataclasses.replace(CFG, transformer=dataclasses.replace(
    CFG.transformer, remat=True))
NAMES = list(CONFIGS)
# coder on (1, 4) alone: one mesh where no rank holds whole heads guards
# the heads' gathers
MESHES = {"llama": td.SP_MESHES, "qwen": td.SP_MESHES, "coder": ((1, 4),)}
RUNS = [(name, mesh) for name in NAMES for mesh in MESHES[name]]
RUN_IDS = [f"{n}-{m[0]}x{m[1]}" for n, m in RUNS]


def _lm_case(cfg, seed):
    params = tfm.init_transformer(torch.Generator().manual_seed(seed), cfg,
                                  device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (B_LM, T_LM), dtype=torch.int32,
                        generator=torch.Generator().manual_seed(seed + 1))
    return params, {"tokens": tok, "labels": tok}


def _onerec_case():
    from repro_torch.data.onerec_data import (OneRecStreamConfig,
                                              SemanticIDStream)
    b = SemanticIDStream(OneRecStreamConfig(
        codebook_size=CFG.vocab_size - 64, history_len=CFG.history_len,
        global_batch=B_ONEREC, n_interests=8)).batch_at(0)
    return ("onerec", "onerec", CFG, onerec.init_onerec(0, CFG, device="cpu"),
            {k: torch.from_numpy(b[k]) for k in ("tokens", "profile",
                                                  "labels")})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = [(name, "lm", cfg, *_lm_case(cfg, 10 * (i + 1)), MESHES[name])
             for i, (name, cfg) in enumerate(CONFIGS.items())]
    # world 1 in a thread while the ranks run, on copies made before the
    # spawn (which moves the tensors' storage to shared memory)
    copies = [(name, family, cfg,
               tree_util.map_with_path(lambda _, t: t.clone(), params),
               {k: v.clone() for k, v in batch.items()})
              for name, family, cfg, params, batch, _ in cases]
    ref = {}

    def world1():
        for name, family, cfg, params, batch in copies:
            ref[name] = td.numpy_ref(td.world1_step(family, cfg, params,
                                                    batch))
    thread = threading.Thread(target=world1)
    thread.start()
    try:
        ranks = td.run(4, td.sp_job, (cases, _onerec_case()),
                       str(tmp_path_factory.mktemp("sp")))
    finally:
        thread.join()
    return {"ranks": ranks, "ref": ref,
            "layers": {name: cfg.n_layers for name, _, cfg, *_ in cases}}


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_sp_step_matches_world1(runs, name, mesh):
    for rank in runs["ranks"]:
        td.check_step(rank[(name, *mesh)], runs["ref"][name])


@pytest.mark.parametrize("name,mesh", RUNS, ids=RUN_IDS)
def test_residual_split_by_sequence(runs, name, mesh):
    """Every layer boundary split on dim 1 over ``model`` (and the batch
    over ``data`` on (2, 2)); the gathers that take the rows whole, and
    the slices' backward, counted."""
    split = "Shard(dim=1)]"
    for rank in runs["ranks"]:
        res = rank[(name, *mesh)]
        assert len(res["boundary"]) == runs["layers"][name]
        for placed in res["boundary"]:
            assert placed.endswith(split), placed
            if mesh == (2, 2):
                assert placed.startswith("[Shard(dim=0)"), placed
        want = {"sp-gather", "keep-bwd"} | (
            {"ep-gather"} if name == "qwen" else set())
        assert want <= set(res["tags"]), res["tags"]


def test_no_functional_collective_and_a_rerun_bit_identical(runs):
    for rank in runs["ranks"]:
        for key, res in rank.items():
            if isinstance(key, tuple) and "functional" in res:
                assert res["functional"] == [], (key, res["functional"])
        first = rank["llama", 1, 4]
        again = first["rerun"]
        assert torch.equal(first["loss"], again["loss"])
        for what in ("grads", "params", "mu", "nu"):
            for (path, a), (_, b) in zip(
                    tree_util.leaves_with_path(first[what]),
                    tree_util.leaves_with_path(again[what])):
                assert torch.equal(a, b), (what, path)


def test_onerec_positions_not_split_four_ways_keep_the_train_step(runs):
    """25 positions on (1, 4): the split dropped at every boundary, and
    the loss, every gradient and the updated state bit for bit the
    ``TRAIN_RULES`` step's."""
    for rank in runs["ranks"]:
        sp, base = rank["onerec", "train_sp"], rank["onerec", "train"]
        assert sp["boundary"] == base["boundary"]
        assert all(p == "[Shard(dim=0), Replicate()]"
                   for p in sp["boundary"]), sp["boundary"]
        assert "sp-gather" not in sp["tags"]
        assert torch.equal(sp["loss"], base["loss"])
        for what in ("grads", "params", "mu", "nu"):
            for (path, a), (_, b) in zip(
                    tree_util.leaves_with_path(sp[what]),
                    tree_util.leaves_with_path(base[what])):
                assert torch.equal(a, b), (what, path)


@pytest.mark.parametrize("name", NAMES)
def test_saved_bytes_a_layer_a_quarter(runs, name):
    """Under remat a layer saves its input alone: under ``TRAIN_RULES``
    the whole residual, B x T x d_model bf16, every layer (measured on
    OneRec-V2's (1, 4) step, 25 positions); under ``TRAIN_RULES_SP`` a
    quarter of it from the second layer on (every case's (1, 4) step)."""
    cfg = CONFIGS[name]
    whole = B_LM * T_LM * cfg.d_model * 2
    onerec_whole = B_ONEREC * 25 * CFG.transformer.d_model * 2
    for rank in runs["ranks"]:
        assert rank["onerec", "train"]["saved"] == [onerec_whole] * (
            CFG.transformer.n_layers)
        assert rank[name, "saved"] == [whole] + [whole // 4] * (
            cfg.n_layers - 1), rank[name, "saved"]


@pytest.mark.parametrize("case", ["unsplit", "match"])
def test_unsplit_and_match_backward_are_their_transposes(runs, case):
    for rank in runs["ranks"]:
        got, want = rank["transposes"][case]
        assert torch.equal(got, want), (case, got, want)


def test_unsplit_and_match_refuse_other_moves(runs):
    for rank in runs["ranks"]:
        gather, keep = rank["transposes"]["refused"]
        assert gather is not None and "is not a gather" in gather
        assert keep is not None and "is not a slice" in keep
