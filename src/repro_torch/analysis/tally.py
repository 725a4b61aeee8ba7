"""The work of kernel calls made on ``meta`` tensors.

A kernel wrapper given ``meta`` tensors (the dry run's, which hold shapes
and no data) returns its output's shape and dtype and nothing else; it
also adds the call's operations and bytes (each input read once, each
output written once) to the innermost active :func:`counting` block, so
that ``launch/dryrun.py`` can count a rank's work without running it.
Outside such a block the record is dropped.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Dict, Iterator


class _Stack(threading.local):
    def __init__(self):
        self.tallies = []


_STACK = _Stack()


@contextlib.contextmanager
def counting() -> Iterator[Dict]:
    """Collect the meta calls made in the block (this thread only):
    ``{"flops": ..., "bytes": ..., "calls": Counter(name -> calls)}``."""
    tally = {"flops": 0, "bytes": 0, "calls": collections.Counter()}
    _STACK.tallies.append(tally)
    try:
        yield tally
    finally:
        _STACK.tallies.pop()


def add(name: str, flops: int, nbytes: int) -> None:
    """Record one meta call of kernel ``name``."""
    if _STACK.tallies:
        tally = _STACK.tallies[-1]
        tally["flops"] += int(flops)
        tally["bytes"] += int(nbytes)
        tally["calls"][name] += 1


def nbytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
