"""Steady-state guard of the serving hot path: no host sync, no kernel
build (the torch form of ``repro/analysis/guards.py``).

The JAX guard holds a warmed-up engine to zero new XLA compilations and
zero implicit host <-> device transfers.  Here, inside a ``steady_state()``
block on the card:

* **host syncs** raise at once: the block runs under
  ``torch.cuda.set_sync_debug_mode("error")`` (``.item()``, ``.cpu()``, a
  copy from pageable host memory, an index array from numpy, ...), restored
  on exit, also when the block raises.  A sync inside a ``sanctioned()``
  block is allowed and counted: the engine's explicit staging of host
  arrays and its readbacks (the select's tokens), as the JAX guard allows
  explicit ``jnp.asarray`` staging.  ``torch.cuda.synchronize()`` itself is
  not flagged by the sync debug mode: the executor's phase-ending
  synchronize runs unsanctioned inside ``chip_smoke.py``'s guarded decode
  steps.
* **builds**: the port has no ``torch.compile``; its one compiler is
  ``nvcc`` (``kernels.build``, which counts its runs in ``build.BUILDS``),
  so "no recompiles" becomes "no kernel builds".  A build inside the block
  raises ``SteadyStateViolation`` on exit.

On the CPU the sync mode has no meaning: the guard checks builds only, and
``sanctioned()`` does nothing.  An exception already leaving the block takes
precedence: the guard never masks it.

Usage::

    engine.serve_requests(reqs)              # warmup: kernels build here
    with engine.steady_state() as mon:       # or steady_state(device)
        engine.serve_requests(reqs)
    mon.sanctioned                           # marked syncs in the block
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Optional

import torch

from repro_torch.kernels import build


class SteadyStateViolation(AssertionError):
    """The steady-state contract broke: a kernel build after warmup."""


class SteadyStateMonitor:
    """What one guarded block did: ``builds`` (nvcc runs) and
    ``sanctioned`` (syncs inside ``sanctioned()`` blocks, on the card)."""

    def __init__(self, on_card: bool) -> None:
        self.on_card = on_card
        self.sanctioned = 0
        self._start = build.BUILDS
        self._end: Optional[int] = None

    @property
    def builds(self) -> int:
        end = build.BUILDS if self._end is None else self._end
        return end - self._start


_active: List[SteadyStateMonitor] = []


@contextlib.contextmanager
def sanctioned() -> Iterator[None]:
    """Allow (and count) the host syncs of the block under an enclosing
    ``steady_state()`` on the card; a no-op otherwise.  Nests."""
    monitors = [m for m in _active if m.on_card]
    if not monitors:
        yield
        return
    for m in monitors:
        m.sanctioned += 1
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


@contextlib.contextmanager
def steady_state(device=None) -> Iterator[SteadyStateMonitor]:
    """Hold the block to the steady-state contract on ``device`` (``None``
    means the card): an unsanctioned host sync raises ``RuntimeError`` at
    once, a kernel build ``SteadyStateViolation`` on exit."""
    on_card = torch.device("cuda" if device is None else device).type \
        == "cuda"
    mon = SteadyStateMonitor(on_card)
    prev = None
    if on_card:
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
    _active.append(mon)
    try:
        yield mon
    finally:
        _active.remove(mon)
        mon._end = build.BUILDS
        if on_card:
            torch.cuda.set_sync_debug_mode(prev)
    if mon.builds:
        raise SteadyStateViolation(
            f"steady-state contract violated: {mon.builds} kernel build(s) "
            f"after warmup (nvcc, kernels.build); warm every kernel the "
            f"block launches first")


def warmup_then_guard(warmup_fn, device=None):
    """Run ``warmup_fn()`` unguarded, then return ``steady_state(device)``
    to enter: for callers that separate the two phases."""
    warmup_fn()
    return steady_state(device)
