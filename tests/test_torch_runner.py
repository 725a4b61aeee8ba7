"""The port's training runner (ROADMAP.md queue N, item N9c): the port-side
forms of ``tests/test_fault_tolerance.py``, FP8 gradient compression
against the JAX package op by op, the prefetcher, and ``launch.train``
across the two packages through their checkpoints.

* Restarts replay bitwise, count exactly the injected faults (a slow
  checkpoint writer too) and restore the state in place.
* ``ef_compress``: bit for bit against JAX's (``jax.disable_jit``) over
  ``test_ef_compression_unbiased_accumulation``'s 40 steps, and on a zero
  leaf.
* ``launch.train``: the JAX runner writes reduced OneRec-V2 (compressed
  gradients) at step 2; the port's runner resumes it to step 4, the JAX
  runner its own copy.  The first resumed step's loss is equal (both from
  the same bytes); later steps part as ``_torch_parity``'s gradient
  tolerance and the e4m3 roundings of the compressed gradients let them
  (``TRAJECTORY``).  The port's step-4 checkpoint resumes in JAX's runner,
  which takes no step.
"""

import os
import re
import shutil
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import LOSS_REL, flat_numpy, to_numpy
from repro_torch import tree
from repro_torch.checkpoint import store
from repro_torch.checkpoint.store import (gc_checkpoints, latest_checkpoint,
                                          save_checkpoint, verify_checkpoint)
from repro_torch.data import ThreadedPrefetcher
from repro_torch.distributed import (FaultTolerantRunner, RunnerConfig,
                                     ef_compress, ef_init)
from repro_torch.launch import train
from repro_torch.optim import OptimizerConfig
from repro_torch.weights import train_state_from_numpy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny eager ops: torch's thread pool only adds contention under the
    six test workers' load."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runner(ckdir, fail=None, total=30, sleep_at=None):
    shutil.rmtree(ckdir, ignore_errors=True)

    def init_state():
        return {"x": torch.zeros(8), "rng": torch.ones((), dtype=torch.uint32)}

    def step_fn(state, batch):
        x = state["x"] * 0.9 + batch
        rng = (state["rng"].to(torch.int64) + 1).to(torch.uint32)
        return {"sum": torch.sum(x)}, {"x": x, "rng": rng}

    def batch_fn(i):
        if sleep_at and i == sleep_at:
            time.sleep(0.3)
        return torch.full((8,), float(i % 7) - 3.0)

    cfg = RunnerConfig(total_steps=total, ckpt_every=7, ckpt_dir=ckdir,
                       straggler_factor=5.0, min_timing_samples=4)
    return FaultTolerantRunner(step_fn, batch_fn, init_state, cfg,
                               fail_at=fail)


def test_restart_bitwise_identical(tmp_path):
    s1, r1 = _runner(str(tmp_path / "a"), fail={11: 1, 23: 2}).run()
    s2, r2 = _runner(str(tmp_path / "b")).run()
    assert r1["restarts"] == 3 and r2["restarts"] == 0
    assert torch.equal(s1["x"], s2["x"])
    assert int(s1["rng"].to(torch.int64)) == int(s2["rng"].to(torch.int64))
    assert set(r1) == {"metrics", "restarts", "events", "median_step_time",
                       "stragglers", "final_step"}


def test_restarts_count_only_the_injected_faults(tmp_path, monkeypatch):
    """A writer slower than the steps: each restore waits for the queued
    checkpoints, so it never reads one that the writer is replacing (a
    replay saves the same steps again) -- exactly 3 restarts, and the same
    final state."""
    save = store.save_checkpoint

    def slow(*args, **kwargs):
        time.sleep(0.05)
        return save(*args, **kwargs)

    monkeypatch.setattr(store, "save_checkpoint", slow)
    s1, r1 = _runner(str(tmp_path / "a"), fail={11: 1, 23: 2}).run()
    monkeypatch.setattr(store, "save_checkpoint", save)
    s2, _ = _runner(str(tmp_path / "b")).run()
    assert r1["restarts"] == 3
    assert [e["step"] for e in r1["events"] if e["kind"] == "restore"] == \
        [7, 21, 21]
    assert torch.equal(s1["x"], s2["x"])


def test_too_many_restarts_raises(tmp_path):
    with pytest.raises(RuntimeError):
        _runner(str(tmp_path / "c"), fail={3: 99}).run()


def test_keyboard_interrupt_passes_through(tmp_path):
    runner = _runner(str(tmp_path / "k"))
    batch_fn = runner.batch_fn

    def interrupted(i):
        if i == 9:
            raise KeyboardInterrupt
        return batch_fn(i)

    runner.batch_fn = interrupted
    with pytest.raises(KeyboardInterrupt):
        runner.run()
    assert runner.restarts == 0


def test_straggler_watchdog(tmp_path):
    _, summary = _runner(str(tmp_path / "d"), sleep_at=20).run()
    assert any(e["step"] == 20 for e in summary["stragglers"])


def test_corrupt_checkpoint_skipped(tmp_path):
    d = str(tmp_path / "ck")
    t = {"w": torch.arange(10.0)}
    save_checkpoint(d, 1, t)
    p2 = save_checkpoint(d, 2, t)
    with open(os.path.join(p2, "arrays.npz"), "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    assert not verify_checkpoint(p2)
    latest = latest_checkpoint(d)
    assert latest is not None and latest.endswith("step_0000000001")


def test_checkpoint_gc(tmp_path):
    d = str(tmp_path / "gc")
    for s in range(6):
        save_checkpoint(d, s, {"x": torch.ones(3) * s})
    gc_checkpoints(d, keep=2)
    remaining = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(remaining) == 2 and remaining[-1].endswith("5")


def test_restore_in_place(tmp_path):
    """A step that updates its state in place (as AdamW does): after two
    injected faults the runner holds the tensors ``init_state_fn`` made,
    once, restored in place, with the clean run's values."""
    made = []

    def run(fail):
        def init_state():
            made.append({"w": torch.zeros(4, 3), "n": torch.zeros(())})
            return made[-1]

        def step_fn(state, batch):
            state["w"].mul_(0.5).add_(batch)
            state["n"].add_(1)
            return {"n": state["n"]}, state

        cfg = RunnerConfig(total_steps=9, ckpt_every=2,
                           ckpt_dir=str(tmp_path / str(len(made))))
        return FaultTolerantRunner(
            step_fn, lambda i: torch.full((4, 3), float(i)), init_state,
            cfg, fail_at=fail).run()

    s1, r1 = run({3: 1, 6: 1})
    assert r1["restarts"] == 2 and len(made) == 1
    assert s1["w"] is made[0]["w"] and s1["n"] is made[0]["n"]
    s2, _ = run(None)
    assert torch.equal(s1["w"], s2["w"]) and float(s1["n"]) == 9.0


# -- FP8 gradient compression -------------------------------------------------

def _bits(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def test_ef_compress_matches_jax():
    """``test_ef_compression_unbiased_accumulation``'s 40 steps, a zero leaf
    beside: ghat and the residuals bit for bit against JAX's op by op, and
    the drift bound of that test."""
    from repro.distributed.compression import ef_compress as jax_compress
    from repro.distributed.compression import ef_init as jax_init
    g0 = {"w": torch.zeros(128), "z": torch.zeros(3, 4)}
    res, jres = ef_init(g0), jax_init({k: jnp.asarray(v.numpy())
                                       for k, v in g0.items()})
    acc_t, acc_c = np.zeros(128), np.zeros(128)
    for i in range(40):
        w = np.asarray(jax.random.normal(jax.random.PRNGKey(i), (128,)))
        g = {"w": torch.from_numpy(w.copy()), "z": torch.zeros(3, 4)}
        c, res = ef_compress(g, res)
        with jax.disable_jit():
            jc, jres = jax_compress({k: jnp.asarray(v.numpy())
                                     for k, v in g.items()}, jres)
        for k in g:
            assert np.array_equal(_bits(c[k].numpy()), _bits(jc[k])), (i, k)
            assert np.array_equal(_bits(res[k].numpy()), _bits(jres[k])), \
                (i, k)
        acc_t += w
        acc_c += c["w"].numpy()
    assert not res["z"].any() and not c["z"].any()
    drift = np.abs(acc_t - acc_c).max()
    assert drift <= np.abs(res["w"].numpy()).max() + 1e-5


# -- the prefetcher ------------------------------------------------------------

def test_prefetcher_order_close_and_error():
    pf = ThreadedPrefetcher(lambda i: {"i": i}, start_step=3, depth=2)
    got = [next(pf) for _ in range(5)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6, 7]
    assert [b["i"] for _, b in got] == [3, 4, 5, 6, 7]
    assert len(pf.fetch_times) >= 5

    def broken(i):
        if i == 2:
            raise ValueError("bad batch 2")
        return i

    pf = ThreadedPrefetcher(broken)
    assert [next(pf)[1] for _ in range(2)] == [0, 1]
    with pytest.raises(ValueError, match="bad batch 2"):
        next(pf)
    pf.close()


# -- launch.train across the packages -----------------------------------------

OPT = dict(lr=1e-2, warmup_steps=2, total_steps=4)
# after the first resumed step the runs part: the port's gradients are
# within GRAD_REL_L2 of JAX's, and a compressed gradient element whose
# compensated value straddles an e4m3 rounding boundary moves by a whole
# e4m3 step (12.5%).  Measured (reduced OneRec-V2, batch 2, step 4): the
# step-3 loss 2.0e-4 apart; params 8.7e-4 relative L2 (worst >= 2-D leaf),
# mu 2.7e-2, nu 4.4e-2; the residuals, pure e4m3 rounding error, differ
# as much as they weigh, so only their size is held: each leaf's norm
# 0.78-1.06 of JAX's.
TRAJECTORY = {"loss": 1e-3, "params": 1e-2, "opt/mu": 0.1, "opt/nu": 0.1}
EF_NORM = (0.5, 2.0)


def _rel(got, ref):
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def test_training_crosses_packages(tmp_path):
    from repro.distributed.fault_tolerance import (
        FaultTolerantRunner as JaxRunner, RunnerConfig as JaxRunnerConfig)
    from repro.launch import train as jax_train
    from repro.optim import OptimizerConfig as JaxOptimizerConfig
    kw = dict(reduced=True, batch=2, seq=16, compress_grads=True)
    jinit, jstep, jbatch, _ = jax_train.build_training(
        "onerec-v2", opt_cfg=JaxOptimizerConfig(**OPT), **kw)

    def jax_run(d, total):
        with jax.disable_jit():
            return JaxRunner(jstep, jbatch, jinit, JaxRunnerConfig(
                total_steps=total, ckpt_every=2, ckpt_dir=d)).run()

    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jstate2, _ = jax_run(jdir, 2)
    shutil.copytree(jdir, pdir)
    # the two bridges agree: the JAX state through numpy, and its file
    bridged = train_state_from_numpy(to_numpy(jstate2))
    assert bridged["opt"]["step"].dtype == torch.int32
    loaded, _ = store.load_checkpoint(latest_checkpoint(jdir), bridged)
    for (path, a), (_, b) in zip(tree.leaves_with_path(bridged),
                                 tree.leaves_with_path(loaded)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    pinit, pstep, pbatch, _ = train.build_training(
        "onerec-v2", opt_cfg=OptimizerConfig(**OPT), device="cpu", **kw)
    state, summary = FaultTolerantRunner(pstep, pbatch, pinit, RunnerConfig(
        total_steps=4, ckpt_every=2, ckpt_dir=pdir)).run()
    assert summary["events"][0]["kind"] == "restore"
    assert summary["events"][0]["step"] == 2
    jstate, jsummary = jax_run(jdir, 4)

    losses = [float(m["loss"]) for m in summary["metrics"]]
    jlosses = [float(m["loss"]) for m in jsummary["metrics"]]
    assert len(losses) == len(jlosses) == 2
    assert abs(losses[0] - jlosses[0]) <= LOSS_REL * abs(jlosses[0])
    assert abs(losses[1] - jlosses[1]) <= TRAJECTORY["loss"] * abs(
        jlosses[1])
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 4
    ref = flat_numpy(to_numpy(jstate))
    got = {p: t.double().numpy() for p, t in tree.leaves_with_path(state)}
    assert set(got) == set(ref)
    for path, r in ref.items():
        assert got[path].shape == r.shape, path
        group = next((g for g in TRAJECTORY if path.startswith(g + "/")),
                     None)
        if path.startswith("ef/"):
            ratio = np.linalg.norm(got[path]) / max(np.linalg.norm(r), 1e-30)
            assert EF_NORM[0] <= ratio <= EF_NORM[1], (path, ratio)
        elif group and r.ndim >= 2:
            assert _rel(got[path], r) <= TRAJECTORY[group], path

    # the port's step-4 checkpoint resumes in the JAX runner: no step left
    _, after = jax_run(pdir, 4)
    assert after["metrics"] == [] and after["restarts"] == 0
    assert after["events"][0]["kind"] == "restore"
    assert after["events"][0]["step"] == 4


SUMMARY = re.compile(
    r"\[train\] arch=din steps=12 wall=\d+\.\ds loss \d+\.\d{4} -> "
    r"\d+\.\d{4} \(first10 \d+\.\d{4} last10 \d+\.\d{4}\) restarts=0 "
    r"stragglers=\d+$")


def test_main_prints_the_jax_summary_line(tmp_path, capsys):
    argv = ["--arch", "din", "--reduced", "--steps", "12", "--ckpt-every",
            "5", "--batch", "4", "--ckpt-dir", str(tmp_path),
            "--device", "cpu"]
    state, summary = train.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert SUMMARY.match(line), line
    assert len(summary["metrics"]) == 12
    assert sorted(os.listdir(tmp_path)) == [
        "step_0000000005", "step_0000000010", "step_0000000012"]
    _, again = train.main(argv)
    assert again["metrics"] == []
    assert "restored step 12" in capsys.readouterr().out
