"""Fault-tolerant training runner: checkpoint/restart, failure injection,
straggler watchdog (the JAX package's ``repro/distributed/
fault_tolerance.py``).

The runner owns the train loop around ``step_fn(state, batch) -> (metrics,
state)``:
  * async checkpoints every ``ckpt_every`` steps and at the last step
    (hash-verified, atomic),
  * on ANY exception (device loss, injected fault, preemption signal) the
    loop restores the newest valid checkpoint and replays from there --
    the data pipeline is seeded per step, so the restart is bitwise
    deterministic (``tests/test_torch_runner.py``); ``KeyboardInterrupt``
    passes through, and the error is raised again after ``max_restarts``,
  * a step-time watchdog records straggler events (steps slower than
    ``straggler_factor`` x the running median) in ``runner.events``.

What torch changes:
  * the state is restored IN PLACE: the checkpoint is copied into the
    tensors the runner already holds (the train step updates them in place
    too), so there are never two states in device memory; ``init_state_fn``
    runs only when the runner holds no state, or to start over when no
    valid checkpoint exists (the held state dropped first);
  * a step is timed after ``device.synchronize`` (the JAX
    ``block_until_ready(metrics)``), so the watchdog times the device's
    work, not the host's queueing of it;
  * before a restore the runner waits for the checkpoints still queued:
    it restores the newest one saved, and no write replaces a checkpoint
    while it is read (each restart is one injected or real fault).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.store import (AsyncCheckpointer, _flatten,
                                          latest_checkpoint, load_checkpoint)
from repro_torch.device import synchronize


@dataclasses.dataclass
class RunnerConfig:
    total_steps: int = 100
    ckpt_every: int = 10
    ckpt_dir: str = "/tmp/repro_ckpt"
    keep: int = 3
    max_restarts: int = 5
    straggler_factor: float = 3.0
    min_timing_samples: int = 8


def _block_until_ready(metrics: Dict[str, Any]) -> None:
    for dev in {v.device for v in metrics.values() if torch.is_tensor(v)}:
        synchronize(dev)


class FaultTolerantRunner:
    """Drives ``step_fn(state, batch) -> (metrics, state)`` to completion."""

    def __init__(self, step_fn: Callable, batch_fn: Callable[[int], Any],
                 init_state_fn: Callable[[], Any], cfg: RunnerConfig,
                 fail_at: Optional[Dict[int, int]] = None):
        """``fail_at`` maps step -> how many times to fail there (test hook)."""
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.init_state_fn = init_state_fn
        self.cfg = cfg
        self.fail_at = dict(fail_at or {})
        self.events: List[Dict[str, Any]] = []
        self.step_times: List[float] = []
        self.restarts = 0
        self.state: Any = None

    # -- state management ----------------------------------------------------

    def _restore_or_init(self) -> Tuple[Any, int]:
        path = latest_checkpoint(self.cfg.ckpt_dir)
        if path is None:
            self.state = None          # never two states: drop, then make
            self.state = self.init_state_fn()
            return self.state, 0
        if self.state is None:
            self.state = self.init_state_fn()
        t0 = time.perf_counter()
        _, manifest = load_checkpoint(path, self.state, in_place=True)
        for dev in {t.device for t in _flatten(self.state)[1]}:
            synchronize(dev)
        self.events.append({"kind": "restore", "step": manifest["step"],
                            "path": path,
                            "seconds": time.perf_counter() - t0})
        return self.state, int(manifest["step"])

    # -- main loop -----------------------------------------------------------

    def run(self) -> Tuple[Any, Dict[str, Any]]:
        ckpt = AsyncCheckpointer(self.cfg.ckpt_dir, keep=self.cfg.keep)
        self.checkpointer = ckpt
        metrics_hist: List[Any] = []
        try:
            while True:
                try:
                    state, start = self._restore_or_init()
                    for step in range(start, self.cfg.total_steps):
                        if self.fail_at.get(step, 0) > 0:
                            self.fail_at[step] -= 1
                            raise RuntimeError(
                                f"injected fault at step {step}")
                        t0 = time.perf_counter()
                        batch = self.batch_fn(step)
                        metrics, state = self.step_fn(state, batch)
                        self.state = state
                        _block_until_ready(metrics)
                        dt = time.perf_counter() - t0
                        self._watch(step, dt)
                        metrics_hist.append(metrics)
                        next_step = step + 1
                        if next_step % self.cfg.ckpt_every == 0 or \
                                next_step == self.cfg.total_steps:
                            ckpt.save(next_step, state)
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 — restart path
                    self.restarts += 1
                    self.events.append({"kind": "failure", "error": str(e),
                                        "restart": self.restarts})
                    if self.restarts > self.cfg.max_restarts:
                        raise
                    ckpt.wait()
        finally:
            ckpt.close()
        summary = {
            "restarts": self.restarts,
            "events": self.events,
            "median_step_time": float(np.median(self.step_times))
            if self.step_times else 0.0,
            "stragglers": [e for e in self.events
                           if e["kind"] == "straggler"],
            "final_step": self.cfg.total_steps,
        }
        return self.state, {"metrics": metrics_hist, **summary}

    def _watch(self, step: int, dt: float) -> None:
        if len(self.step_times) >= self.cfg.min_timing_samples:
            med = float(np.median(self.step_times))
            if dt > self.cfg.straggler_factor * med:
                self.events.append({"kind": "straggler", "step": step,
                                    "dt": dt, "median": med})
        self.step_times.append(dt)
