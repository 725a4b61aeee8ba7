"""The steady-state guard (``repro_torch.analysis.guards``) on the CPU: the
build counter trips it, it restores the sync debug mode (also when the
block raises), ``sanctioned()`` nests, a warmed engine replays under it,
and the RoPE frequencies that ``apply_rope`` now caches (a per-call copy
to the card would sync) are bit-equal to the per-call ones.  The CPU
torch build has no sync debug mode: the tests that need one stand a
recording fake in for ``torch.cuda``'s get / set pair and ask the guard
for the card; ``tests/test_torch_cuda.py`` holds the real mode to it on
the card."""

import os
import stat

import numpy as np
import pytest
import torch

from repro_torch.analysis import guards
from repro_torch.analysis.guards import (SteadyStateViolation, sanctioned,
                                         steady_state, warmup_then_guard)
from repro_torch.configs.base import OneRecConfig, TransformerConfig
from repro_torch.kernels import build
from repro_torch.layers import rotary
from repro_torch.models import onerec
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.serving.requests import make_request


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """``build_all`` with an ``nvcc`` that writes an empty library, into a
    build directory of its own: every call compiles every kernel anew."""
    script = tmp_path / "nvcc"
    script.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                      ': > "$2"\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(build, "_nvcc", lambda: str(script))

    def fresh_build():
        fresh = tmp_path / f"build{len(os.listdir(tmp_path))}"
        monkeypatch.setattr(build, "BUILD", fresh)
        return build.build_all()
    return fresh_build


class FakeSyncMode:
    """A recording stand-in for ``torch.cuda.{get,set}_sync_debug_mode``
    (modes as the ints torch stores: 0 default, 1 warn, 2 error)."""

    NAMES = {"default": 0, "warn": 1, "error": 2}

    def __init__(self, mode=1):
        self.mode = mode
        self.sets = []

    def get(self):
        return self.mode

    def set(self, mode):
        self.mode = self.NAMES.get(mode, mode)
        self.sets.append(self.mode)


@pytest.fixture
def sync_mode(monkeypatch):
    fake = FakeSyncMode()
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", fake.get)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", fake.set)
    return fake


def test_build_counter_trips_the_guard(fake_nvcc):
    before = build.BUILDS
    fake_nvcc()                                    # warmup: builds allowed
    assert build.BUILDS == before + len(build.SOURCES)
    with steady_state("cpu") as mon:
        pass
    assert mon.builds == 0
    with pytest.raises(SteadyStateViolation, match="kernel build"):
        with steady_state("cpu") as mon:
            fake_nvcc()
    assert mon.builds == len(build.SOURCES)
    with steady_state("cpu") as mon:               # nothing to build
        build.build_all()
    assert mon.builds == 0


def test_an_exception_in_the_block_wins_over_the_build_check(fake_nvcc):
    with pytest.raises(ValueError, match="inner"):
        with steady_state("cpu"):
            fake_nvcc()
            raise ValueError("inner")


def test_warmup_then_guard(fake_nvcc):
    with warmup_then_guard(fake_nvcc, "cpu") as mon:
        build.build_all()
    assert mon.builds == 0


def test_guard_restores_the_sync_mode_when_the_block_raises(sync_mode):
    with pytest.raises(ValueError):
        with steady_state("cuda"):
            assert sync_mode.mode == 2
            raise ValueError("inner")
    assert sync_mode.mode == 1
    with steady_state("cuda"):
        assert sync_mode.mode == 2
    assert sync_mode.mode == 1
    assert guards._active == []


def test_sanctioned_nests(sync_mode):
    with sanctioned():                    # no guard: nothing to allow
        pass
    assert sync_mode.sets == []
    with steady_state("cuda") as mon:
        with sanctioned():
            assert sync_mode.mode == 0
            with sanctioned():
                assert sync_mode.mode == 0
            assert sync_mode.mode == 0
        assert sync_mode.mode == 2
        with pytest.raises(KeyError):
            with sanctioned():
                raise KeyError("inner")
        assert sync_mode.mode == 2
    assert mon.sanctioned == 3
    assert sync_mode.mode == 1


def test_guard_on_the_cpu_checks_builds_only(sync_mode):
    with steady_state("cpu") as mon:
        with sanctioned():
            pass
    assert mon.sanctioned == 0 and sync_mode.sets == []


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
@pytest.mark.parametrize("head_dim", [16, 128, 256])
def test_cached_rope_frequencies_are_bit_equal(head_dim, theta):
    made = rotary.rope_frequencies(head_dim, theta, "cpu")
    cached = rotary._cached_frequencies(head_dim, theta, torch.device("cpu"))
    assert torch.equal(made, cached)
    assert rotary._cached_frequencies(head_dim, theta,
                                      torch.device("cpu")) is cached
    g = torch.Generator().manual_seed(head_dim)
    x = torch.randn(2, 5, 3, head_dim, generator=g).to(torch.bfloat16)
    pos = torch.arange(7, 12, dtype=torch.int32)
    angles = pos.to(torch.float32)[..., None, None] * made
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    sin, cos = torch.sin(angles), torch.cos(angles)
    ref = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    assert torch.equal(rotary.apply_rope(x, pos, theta=theta), ref)


def _steady_cfg() -> OneRecConfig:
    """``tests/test_steady_state.py::_cfg``."""
    return OneRecConfig(
        name="onerec-steady-test", history_len=8,
        transformer=TransformerConfig(
            name="onerec-steady-test-backbone",
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=64, capacity_factor=64.0, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)


def test_warmed_engine_replays_under_the_guard():
    """The port-side form of ``tests/test_steady_state.py``'s replay: the
    paged fp8-KV engine with fused decode, warmed on the request list it
    replays, steps >= 8 times under the guard, builds nothing and gives
    the warmup's items again (on the CPU the guard checks builds only)."""
    cfg = _steady_cfg()
    rng = np.random.default_rng(31)
    reqs = [make_request(rng.integers(0, 192, size=int(rng.integers(
        2, cfg.history_len + 1)) * cfg.n_codebooks),
        rng.normal(size=onerec.PROFILE_DIM)) for _ in range(12)]
    engine = ServingEngine(onerec.init_onerec(0, cfg, device="cpu"), cfg,
                           EngineConfig(batch_size=4, n_slots=3,
                                        use_fp8=False,
                                        kv_dtype="float8_e4m3fn",
                                        page_size=8),
                           device="cpu")
    warm, _ = engine.serve_requests(reqs)
    with engine.steady_state() as mon:
        out, stats = engine.serve_requests(reqs)
    assert stats["decode_steps"] >= 8
    assert stats["fused_decode_steps"] == stats["decode_steps"]
    assert mon.builds == 0
    for a, b in zip(out, warm):
        np.testing.assert_array_equal(a, b)
