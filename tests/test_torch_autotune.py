"""The auto-tuner (``repro_torch.core.autotune``, ``launch/autotune.py``)
against the JAX package's ``repro.core.autotune`` on the CPU.

* The synthetic ``_fake_task`` of ``tests/test_autotune.py`` (equal
  weights, a fragile down projection): both packages' searches give the
  same trace, the same policy and the same ``group_stats`` (patterns,
  kinds, bytes and leaf counts equal, ``rel_err`` within 1e-6: the same
  f32 quantization error summed in another order).
* A reduced DIN search (the recsys harness, ``max_steps=2``) on the same
  params and the same numpy-drawn batches takes the same decisions
  (actions, groups, acceptances, bytes), its overlaps within
  ``OVERLAP_TOL`` of the JAX side's (run op by op): the card-against-CPU
  bar of teacher-forced top-8 overlap, 0.85, as an absolute distance.
* ``launch/autotune.py --device cpu`` writes a OneRec-V2 artifact and a
  summary in the JAX formats, and the port's engine deploys the artifact.
"""

import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import torch_params
from repro.core import autotune as jax_autotune
from repro.core.policy import PAPER_POLICY as JAX_PAPER
from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
from repro_torch.configs import registry
from repro_torch.core import autotune
from repro_torch.core.policy import PAPER_POLICY, load_policy_artifact
from repro_torch.core.quant import QuantizedTensor
from repro_torch.launch import autotune as autotune_launch
from repro_torch.models import onerec
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.requests import build_requests
from repro_torch.tree import leaves_with_path

OVERLAP_TOL = 1 - 0.85
TRACE_KEYS = ("step", "action", "group", "bytes_quantized", "accepted")


def _fake_tasks():
    """``tests/test_autotune.py::_fake_task`` in both packages, the port's
    params bridged from the JAX ones."""
    k = jax.random.PRNGKey(0)
    params = {"blk": {
        "attn": {"q_proj": {"kernel": jax.random.normal(k, (16, 16))}},
        "mlp": {"down": {"kernel": jax.random.normal(k, (16, 16))}},
    }}

    def overlap(cls):
        def fn(qp):
            bad = isinstance(qp["blk"]["mlp"]["down"]["kernel"], cls)
            return 0.3 if bad else 0.95
        return fn

    return (jax_autotune.EvalTask(name="fake", family="lm", params=params,
                                  overlap=overlap(JaxQuantizedTensor)),
            autotune.EvalTask(name="fake", family="lm",
                              params=torch_params(params),
                              overlap=overlap(QuantizedTensor)))


def _same_groups(got, ref):
    assert [{k: g[k] for k in ("pattern", "kind", "bytes", "n_leaves")}
            for g in got] == \
        [{k: g[k] for k in ("pattern", "kind", "bytes", "n_leaves")}
         for g in ref]
    for g, r in zip(got, ref):
        assert g["rel_err"] == pytest.approx(r["rel_err"], rel=1e-6)


@pytest.mark.parametrize("phases", ["contract", "all"])
def test_fake_task_search_matches_jax(phases):
    jtask, task = _fake_tasks()
    kw = dict(target=0.6, max_steps=8)
    if phases == "contract":
        kw.update(try_expand=False, try_int8=False, try_static_acts=False)
    ref = jax_autotune.autotune(jtask, **kw)
    got = autotune.autotune(task, **kw)
    assert got.trace == ref.trace
    assert got.policy.to_json_dict() == ref.policy.to_json_dict()
    assert ("*/mlp/down/kernel", "skip") in got.policy.overrides
    assert (got.overlap, got.bytes_quantized, got.uniform) == \
        (ref.overlap, ref.bytes_quantized, ref.uniform)
    _same_groups(got.groups, ref.groups)
    ov, nbytes, report = autotune.measure(task, PAPER_POLICY)
    jov, jbytes, jreport = jax_autotune.measure(jtask, JAX_PAPER)
    assert (ov, nbytes) == (jov, jbytes)
    _same_groups(autotune.group_stats(report),
                 jax_autotune.group_stats(jreport))


def test_reduced_din_search_takes_the_jax_decisions():
    """Two users of 64 candidates each (``make_eval_task`` takes 4): the
    JAX side's op-by-op retrievals are most of this file's time."""
    from repro.configs import registry as jax_registry
    with jax.disable_jit():
        jtask = jax_autotune._recsys_task(
            "din", jax_registry.get_arch("din").reduced_config(), seed=0,
            topk=8, n_users=2)
        ref = jax_autotune.autotune(jtask, target=0.6, max_steps=2)
    task = autotune._recsys_task(
        "din", registry.get_arch("din").reduced_config(), seed=0, topk=8,
        device=torch.device("cpu"), params=torch_params(jtask.params),
        n_users=2)
    assert [b["hist_ids"].tolist() for b in task.calib_batches] == \
        [np.asarray(b["hist_ids"]).tolist() for b in jtask.calib_batches]
    got = autotune.autotune(task, target=0.6, max_steps=2)
    assert [tuple(t[k] for k in TRACE_KEYS) for t in got.trace] == \
        [tuple(t[k] for k in TRACE_KEYS) for t in ref.trace]
    assert [t["action"] for t in got.trace] == ["uniform", "expand"]
    for t, r in zip(got.trace, ref.trace):
        assert abs(t["overlap"] - r["overlap"]) <= OVERLAP_TOL, t
    assert got.policy.to_json_dict() == ref.policy.to_json_dict()
    _same_groups(got.groups, ref.groups)


def test_launcher_writes_an_artifact_the_engine_deploys(tmp_path, capsys):
    out = tmp_path / "tuned"
    summary = autotune_launch.main(["--arch", "onerec-v2", "--device", "cpu",
                                    "--out", str(out)])
    assert "== autotune onerec-v2" in capsys.readouterr().out
    path = out / "quant_policy_onerec-v2.json"
    with open(out / "autotune_summary.json") as f:
        assert json.load(f) == json.loads(json.dumps(summary))
    entry = summary["onerec-v2"]
    assert set(entry) == {"overlap", "target", "bytes_quantized", "uniform",
                          "artifact", "overrides", "static_acts"}
    assert entry["artifact"] == str(path) and entry["overlap"] >= 0.6
    art = load_policy_artifact(str(path))
    assert art["config"] == "onerec-v2" and art["trace"][0]["action"] == \
        "uniform"
    assert [list(o) for o in art["policy"].overrides] == entry["overrides"]
    assert art["policy"].static_acts == entry["static_acts"] == bool(
        art["act_scales"])

    cfg = registry.get_arch("onerec-v2").reduced_config()
    engine = ServingEngine(onerec.init_onerec(0, cfg, device="cpu"), cfg,
                           EngineConfig(batch_size=4,
                                        quant_policy=str(path)),
                           device="cpu")
    assert engine.executor.quant_policy == art["policy"]
    attached = [leaf for _, leaf in leaves_with_path(engine.executor.params)
                if isinstance(leaf, QuantizedTensor)
                and leaf.act_scale is not None]
    assert bool(attached) == art["policy"].static_acts
    outs, stats = engine.serve_requests(build_requests(cfg, 4, 4, 0, False))
    assert len(outs) == 4 and stats["n_requests"] == 4
    assert all(o.shape == (cfg.decode_len,) for o in outs)
    assert all(((o >= 0) & (o < cfg.transformer.vocab_size)).all()
               for o in outs)
