"""End to end on the port alone (the port-side form of
``tests/test_system.py``, the paper's Table-1 analogue, with its
thresholds): train OneRec-mini for 120 steps through the port's train step
(``tree.value_and_grad`` + AdamW), check its weight distribution is
FP8-friendly, serve it BF16 and FP8 through the port's engine (first-codebook
hit rate of the generated item against the held-out clicked one), and PTQ
it with the paper's policy.  The module imports no JAX."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core import stats
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.data.onerec_data import OneRecStreamConfig, SemanticIDStream
from repro_torch.launch.steps import train_step
from repro_torch.models import onerec as onerec_model
from repro_torch.optim import OptimizerConfig, adamw_init
from repro_torch.serving import EngineConfig, ServingEngine

STEPS = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's ops are tiny and eager: with torch's default thread
    pool they wait on each other under a loaded machine (the suite's six
    workers made the module take ~300 s against ~10 s alone)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trained_onerec(one_thread):
    cfg = get_arch("onerec-v2").reduced_config()
    stream = SemanticIDStream(OneRecStreamConfig(
        codebook_size=cfg.transformer.vocab_size - 64,
        history_len=cfg.history_len, global_batch=16, n_interests=8))
    params = onerec_model.init_onerec(0, cfg, device="cpu")
    opt = adamw_init(params)
    step = train_step(lambda p, b: onerec_model.train_loss(p, b, cfg),
                      OptimizerConfig(lr=2e-3, warmup_steps=5,
                                      total_steps=STEPS))
    losses = []
    for i in range(STEPS):
        b = stream.batch_at(i)
        loss, params, opt = step(params, opt, {
            k: torch.from_numpy(v) for k, v in b.items() if k != "target"})
        losses.append(float(loss))
    return cfg, params, stream, losses


def test_training_loss_decreases(trained_onerec):
    _, _, _, losses = trained_onerec
    assert np.mean(losses[-10:]) < 0.7 * np.mean(losses[:10]), losses[::10]


def test_distribution_is_fp8_friendly(trained_onerec):
    _, params, _, _ = trained_onerec
    rep = stats.collect_weight_stats(params, "onerec-mini")
    assert rep.mean_variance < 1.0
    assert rep.mean_absmax < 50.0


def test_fp8_serving_hitrate_parity(trained_onerec):
    """Table-1 analogue: FP8 serving must not degrade recommendation
    quality (first-codebook hit rate of the generated vs the held-out
    clicked item)."""
    cfg, params, stream, _ = trained_onerec

    def hitrate(use_fp8):
        eng = ServingEngine(params, cfg,
                            EngineConfig(batch_size=16, use_fp8=use_fp8),
                            device="cpu")
        hits, total = 0, 0
        for step in range(100, 104):
            r = stream.serve_request_at(step)
            out = eng.generate_batch(r["tokens"], r["profile"])
            hits += int((out[:, 0] == r["target"][:, 0]).sum())
            total += out.shape[0]
        return hits / total

    h_bf16 = hitrate(False)
    h_fp8 = hitrate(True)
    assert h_bf16 > 0.2, f"bf16 hit-rate {h_bf16}"
    assert abs(h_fp8 - h_bf16) <= 0.11, (h_bf16, h_fp8)


def test_ptq_report_coverage(trained_onerec):
    _, params, _, _ = trained_onerec
    _, rep = quantize_params(params, PAPER_POLICY, with_report=True,
                             compute_errors=True)
    assert rep.n_quantized >= 7
    assert rep.mean_rel_err < 0.05
    assert rep.bytes_after < 0.35 * rep.bytes_before


def test_module_imports_no_jax():
    tree = ast.parse(Path(__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "jaxlib", "repro")], names
