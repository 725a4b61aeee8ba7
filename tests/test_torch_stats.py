"""The distribution analysis (``repro_torch.core.stats``, the paper's Fig.-1
statistics) against the JAX package's ``repro.core.stats`` on the CPU.

* Weight reports of the same params (JAX init -> numpy -> port): the same
  names in the same order, ``numel`` and ``absmax`` exactly, variance and
  ``absp99`` within relative 1e-5 (the port sums the variance in float64,
  numpy in pairwise float32; the percentile follows numpy's f32 rule and
  is measured exact).
* Activation taps of one forward of OneRec-V2, an LM and DIN: the same
  names in the same order as the JAX side run op by op (the JAX package's
  own analysis path, ``unroll_layers=True``), each statistic within
  ``ACT_TOL`` relative: the raw-weight forwards' tolerance of the parity
  tests (``_torch_parity.RAW_LOGIT_TOL``), since the bf16 products sum in
  another order than XLA's and a rounding flips now and then.
* ``capture_taps`` nests and restores; a tap outside a capture records
  nothing; ``feasibility_verdict``, ``summary`` and ``csv_rows`` give the
  JAX package's strings.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (RAW_LOGIT_TOL, jax_lm_cfg, onerec_batch,
                           onerec_params, recsys_batch, recsys_cfg,
                           recsys_params, zoo_params)
from repro.configs import registry as jax_registry
from repro.configs.base import RecsysConfig as JaxRecsysConfig
from repro.core import stats as jax_stats
from repro.models import onerec as jax_onerec
from repro.models import recsys as jax_recsys
from repro.models import transformer as jax_tfm
from repro_torch.configs import registry
from repro_torch.core import stats
from repro_torch.models import onerec, recsys
from repro_torch.models import transformer as tfm

WEIGHT_TOL = 1e-5
ACT_TOL = RAW_LOGIT_TOL


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _weight_trees(which: str):
    """(JAX tree, port tree) of the same params: raw OneRec-V2 and
    llama3-8b (reduced), and DIN's PTQ'd tree (dequantized leaves)."""
    if which == "onerec-v2":
        return onerec_params()
    if which == "llama3-8b":
        jraw, _, traw, _ = zoo_params(which)
        return jraw, traw
    _, jq, _, tq = recsys_params(which, "reduced")
    return jq, tq


@pytest.mark.parametrize("which", ["onerec-v2", "llama3-8b", "din"])
def test_weight_report_matches_jax(which):
    jtree, ttree = _weight_trees(which)
    ref = jax_stats.collect_weight_stats(jtree, which)
    got = stats.collect_weight_stats(ttree, which)
    assert [t.name for t in got.per_tensor] == \
        [t.name for t in ref.per_tensor]
    for g, r in zip(got.per_tensor, ref.per_tensor):
        assert g.numel == r.numel and g.absmax == r.absmax, g.name
        assert _rel(g.variance, r.variance) <= WEIGHT_TOL, g.name
        assert _rel(g.absp99, r.absp99) <= WEIGHT_TOL, g.name
    assert _rel(got.mean_variance, ref.mean_variance) <= WEIGHT_TOL
    assert stats.feasibility_verdict(got) == \
        jax_stats.feasibility_verdict(ref)
    small = stats.collect_weight_stats(ttree, which, min_numel=1000)
    assert [t.name for t in small.per_tensor] == [
        t.name for t in jax_stats.collect_weight_stats(
            jtree, which, min_numel=1000).per_tensor]


@pytest.mark.parametrize("n", [1, 2, 3, 100, 101, 4097, 30001])
def test_tensor_stats_match_numpy(n):
    x = (np.random.default_rng(n).standard_normal(n) * 3).astype(np.float32)
    x[: n // 3] = np.round(x[: n // 3])                    # ties
    ref = jax_stats.tensor_stats("x", jnp.asarray(x))
    got = stats.tensor_stats("x", torch.from_numpy(x))
    assert (got.numel, got.absmax, got.absp99) == \
        (ref.numel, ref.absmax, ref.absp99)
    assert _rel(got.variance, ref.variance) <= 1e-6
    assert stats.tensor_stats("e", torch.zeros(0)) == \
        stats.TensorStats("e", 0.0, 0.0, 0.0, 0)


def _taps(which: str):
    """({name: JAX array}, {name: port tensor}) of one forward each."""
    if which == "onerec-v2":
        jraw, traw = onerec_params()
        cfg = registry.get_arch(which).reduced_config()
        b = onerec_batch(cfg, b=2)
        jcfg = jax_registry.get_arch(which).reduced_config()
        with jax.disable_jit(), jax_stats.capture_taps() as jt:
            jax_onerec.forward(jraw, {k: jnp.asarray(v) for k, v in
                                      b.items()}, jcfg, unroll_layers=True)
        with stats.capture_taps() as tt:
            onerec.forward(traw, {k: torch.from_numpy(v) for k, v in
                                  b.items()}, cfg)
    elif which == "llama3-8b":
        jraw, _, traw, _ = zoo_params(which)
        cfg = registry.get_arch(which).reduced_config()
        toks = np.random.default_rng(1).integers(
            0, cfg.vocab_size, size=(2, 8)).astype(np.int32)
        with jax.disable_jit(), jax_stats.capture_taps() as jt:
            jax_tfm.forward(jraw, jnp.asarray(toks), jax_lm_cfg(cfg),
                            unroll_layers=True)
        with stats.capture_taps() as tt:
            tfm.forward(traw, torch.from_numpy(toks), cfg)
    else:
        jraw, _, traw, _ = recsys_params(which, "reduced")
        cfg = recsys_cfg(which, "reduced")
        batch, _ = recsys_batch(cfg)
        with jax.disable_jit(), jax_stats.capture_taps() as jt:
            jax_recsys.score(jraw, {k: jnp.asarray(v) for k, v in
                                    batch.items()},
                             JaxRecsysConfig(**dataclasses.asdict(cfg)))
        with stats.capture_taps() as tt:
            recsys.score(traw, {k: torch.from_numpy(v) for k, v in
                                batch.items()}, cfg)
    return jt, tt


@pytest.mark.parametrize("which", ["onerec-v2", "llama3-8b", "din"])
def test_activation_taps_match_jax(which):
    jt, tt = _taps(which)
    assert list(tt) == list(jt)
    assert len(tt) >= 3
    ref = jax_stats.collect_activation_stats(jt, which)
    got = stats.collect_activation_stats(tt, which)
    for g, r in zip(got.per_tensor, ref.per_tensor):
        assert g.name == r.name and g.numel == r.numel
        for field in ("variance", "absmax", "absp99"):
            assert _rel(getattr(g, field), getattr(r, field)) <= ACT_TOL, \
                (g.name, field)


def test_capture_taps_nests_and_restores():
    x, y = torch.ones(2), torch.zeros(3)
    with stats.capture_taps() as outer:
        stats.tap("a", x)
        with stats.capture_taps() as inner:
            stats.tap("a", y)
            stats.tap("a", y)
        stats.tap("a", y)
    assert list(inner) == ["a", "a.1"]
    assert list(outer) == ["a", "a.1"]
    assert outer["a"] is x and outer["a.1"] is y
    assert stats._TAPS is None
    with pytest.raises(RuntimeError):
        with stats.capture_taps():
            raise RuntimeError("inner")
    assert stats._TAPS is None


def test_tap_outside_a_capture_records_nothing():
    stats.tap("loose", torch.ones(4))
    with stats.capture_taps() as taps:
        pass
    assert taps == {} and stats._TAPS is None


@pytest.mark.parametrize("var,absmax", [(0.02, 0.5), (9.9, 99.0),
                                        (10.0, 1.0), (1.0, 100.0),
                                        (1e7, 3e3)])
def test_feasibility_verdict_and_report_text_match_jax(var, absmax):
    rows = [(f"t{i}", var * (i + 1) / 2, absmax * (i + 1) / 2,
             absmax * (i + 1) / 4, 10 * (i + 1)) for i in range(3)]
    got = stats.DistributionReport(
        "fam", "weights", [stats.TensorStats(*r) for r in rows])
    ref = jax_stats.DistributionReport(
        "fam", "weights", [jax_stats.TensorStats(*r) for r in rows])
    assert stats.feasibility_verdict(got) == \
        jax_stats.feasibility_verdict(ref)
    assert stats.feasibility_verdict(got, 1e8, 1e4) == \
        jax_stats.feasibility_verdict(ref, 1e8, 1e4)
    assert got.summary() == ref.summary()
    assert got.csv_rows() == ref.csv_rows()
    assert [t.row() for t in got.per_tensor] == \
        [t.row() for t in ref.per_tensor]
    empty = stats.DistributionReport("fam", "activations", [])
    assert empty.summary() == jax_stats.DistributionReport(
        "fam", "activations", []).summary()
