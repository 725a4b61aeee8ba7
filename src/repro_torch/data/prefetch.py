"""Bounded background prefetch with timing stats (straggler signal source).

The training loop pulls from the prefetcher; production behavior
(overlapping host data work with device compute) plus a per-fetch timing
trace that the fault-tolerance watchdog consumes.  The JAX package's
``repro/data/prefetch.py`` (pure Python), kept here as the port's own copy.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Iterator, List, Optional


class ThreadedPrefetcher:
    def __init__(self, make_batch: Callable[[int], Any], *,
                 start_step: int = 0, depth: int = 2):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self.fetch_times: List[float] = []
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                batch = self._make(step)
            except BaseException as e:
                self._err = e
                self._q.put(None)
                return
            self.fetch_times.append(time.perf_counter() - t0)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise self._err  # type: ignore[misc]
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5)
