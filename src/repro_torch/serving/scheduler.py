"""Continuous-batching scheduler over the executor's paged pool: the
single-candidate path of ``repro/serving/scheduler.py``
(``ContinuousScheduler``) without the prefix store, chunked prefill,
preemption or hold windows, which are later slices.

Every ``step()`` (1) joins arrived queued requests into free slots, grouped
by history-length bucket, each group one ragged prefill whose logits seed
the first generated token, then (2) runs ONE fused decode over the decoding
slots, advancing every active request at its own depth; a slot retires
when its item (``decode_len`` tokens) is complete.  The admission order,
bucket grouping, page grants and slot assignment are the JAX scheduler's,
so both engines build the same batches from the same requests.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.executor import PhaseExecutor, bucket_length
from repro_torch.serving.kv_cache import SlotPool, SlotState

_NO_DEADLINE = float("inf")


@dataclasses.dataclass(eq=False)     # identity equality
class Request:
    rid: int
    tokens: np.ndarray          # (L,) semantic-ID history
    profile: np.ndarray         # (PROFILE_DIM,)
    arrival_s: float = 0.0      # absolute perf_counter timestamp
    priority: int = 0           # SLA class: lower = more important
    deadline_s: Optional[float] = None  # absolute deadline; None = no SLA


@dataclasses.dataclass
class Completion:
    rid: int
    item: np.ndarray            # (decode_len,) generated item
    latency_s: float
    priority: int = 0
    deadline_s: Optional[float] = None
    deadline_missed: bool = False
    scores: List[float] = dataclasses.field(default_factory=list)


def _sort_key(r: Request) -> Tuple[int, float, float]:
    """Admission order: priority class, then earliest deadline, then
    arrival (plain FIFO when neither priority nor deadline is set)."""
    return (r.priority,
            r.deadline_s if r.deadline_s is not None else _NO_DEADLINE,
            r.arrival_s)


class ContinuousScheduler:
    """Slot-based continuous batching over the executor's page pool.

    ``max_prefill_groups`` caps how many length-bucket prefill programs one
    join round may launch; admission takes the most urgent request's
    bucket first, then the most-populous others, within a ``lookahead``
    window of the queue.  A request joins only when the page pool can
    cover its footprint (profile + history + its decode span)."""

    def __init__(self, executor: PhaseExecutor, pool: SlotPool,
                 max_prefill_groups: int = 2, lookahead: int = 0):
        self.executor = executor
        self.pool = pool
        self.max_prefill_groups = max(1, max_prefill_groups)
        self.lookahead = lookahead or 4 * pool.n_slots
        self.decode_len = executor.cfg.decode_len
        self.queue: Deque[Request] = deque()   # arrival-sorted
        self.reset_window()

    def enqueue(self, r: Request) -> None:
        """Admit ``r`` into the arrival-sorted queue (ties keep submission
        order)."""
        q = self.queue
        if not q or r.arrival_s >= q[-1].arrival_s:
            q.append(r)
            return
        i = next((i for i, other in enumerate(q)
                  if other.arrival_s > r.arrival_s), len(q))
        q.insert(i, r)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.pool.n_used)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def idle_wait_s(self) -> float:
        """Seconds a drive loop may sleep before ``step()`` can progress:
        0 while anything is in flight, else the gap to the next arrival."""
        if self.pool.n_used or not self.queue:
            return 0.0
        return max(0.0, self.queue[0].arrival_s - time.perf_counter())

    def reset_window(self) -> None:
        self.occupancy: List[float] = []
        self.join_step_s: List[float] = []   # wall time of each join round
        self.decode_stall_s = 0.0   # join time spent while decoders waited

    # -- slots ----------------------------------------------------------------

    def _seed_slot(self, slot: int, ids_row: np.ndarray,
                   vals_row: np.ndarray, lse: float, done: List[Completion],
                   freed: List[int]) -> None:
        """Start a freshly prefilled slot's item with the top prefill token,
        scored by its log-prob."""
        state = self.pool[slot]
        state.branch_base = state.length
        state.branches = [[int(ids_row[0])]]
        state.scores = [float(vals_row[0] - lse)]
        self._maybe_retire(slot, done, freed)     # decode_len == 1 corner

    def _maybe_retire(self, slot: int, done: List[Completion],
                      freed: List[int]) -> None:
        state = self.pool[slot]
        if len(state.branches[0]) < self.decode_len:
            return
        final = self.pool.free(slot)
        freed.append(slot)
        finish = time.perf_counter()
        item = np.asarray(final.branches[0], np.int32)
        done.append(Completion(
            rid=final.request_id, item=item,
            scores=list(final.scores), latency_s=finish - final.arrival_s,
            priority=final.priority, deadline_s=final.deadline_s,
            deadline_missed=final.deadline_s is not None
            and finish > final.deadline_s))

    def _footprint(self, r: Request) -> int:
        """Logical cache positions ``r`` can occupy: profile + history +
        its decode span."""
        return len(r.tokens) + 1 + self.executor.branch_stride

    # -- admission ------------------------------------------------------------

    def _join(self, done: List[Completion]) -> None:
        queue = self.queue
        if not queue or not self.pool.n_free:
            return
        now = time.perf_counter()
        window = sorted((r for r in list(queue)[:self.lookahead]
                         if r.arrival_s <= now), key=_sort_key)
        if not window:
            return
        free = self.pool.n_free
        page_pool = self.executor.page_pool
        bucket_of = {id(r): bucket_length(len(r.tokens),
                                          self.executor.prefill_bucket_min)
                     for r in window}
        by_bucket: Dict[int, List[Request]] = {}
        for r in window:
            by_bucket.setdefault(bucket_of[id(r)], []).append(r)
        # most urgent request's bucket first, then the fullest others
        head_b = bucket_of[id(window[0])]
        order = [head_b] + sorted((b for b in by_bucket if b != head_b),
                                  key=lambda b: -len(by_bucket[b]))
        chosen = set(order[:self.max_prefill_groups])
        joiners: List[Request] = []
        groups: Dict[int, List[Request]] = {}
        committed = 0   # pages claimed by already-selected joiners
        for r in window:
            if len(joiners) >= free:
                break
            b = bucket_of[id(r)]
            if b not in chosen:
                continue
            need = page_pool.pages_for(self._footprint(r))
            if page_pool.n_free - committed < need:
                break
            committed += need
            groups.setdefault(b, []).append(r)
            joiners.append(r)
        taken = {id(r) for r in joiners}
        if taken:  # one O(len(queue)) rotation, preserving order
            for _ in range(len(queue)):
                r = queue.popleft()
                if id(r) not in taken:
                    queue.append(r)
        for group in groups.values():
            slots = []
            for r in group:
                slot = self.pool.alloc(SlotState(
                    request_id=r.rid, length=len(r.tokens) + 1,  # + profile
                    arrival_s=r.arrival_s, priority=r.priority,
                    deadline_s=r.deadline_s))
                ok = self.executor.grant_slot(slot, self._footprint(r))
                assert ok, "page grant raced the admission gate"
                slots.append(slot)
            logits = self.executor.prefill_insert(
                [r.tokens for r in group], [r.profile for r in group], slots)
            vals, ids, lse = self.executor.select_scored(logits)
            freed: List[int] = []
            for i, slot in enumerate(slots):
                self._seed_slot(slot, ids[i], vals[i], float(lse[i]), done,
                                freed)
            self.executor.free_slots(freed)

    def _decode_step(self, done: List[Completion]) -> None:
        """One fused decode over every decoding slot of the pool; free rows
        ride along at index 0 with their writes not made."""
        pool = self.pool
        active = pool.used_slots()
        self.occupancy.append(pool.occupancy)
        tokens = np.zeros((pool.n_slots, 1), np.int32)
        lengths = np.zeros((pool.n_slots,), np.int32)
        for s in active:
            tokens[s, 0] = pool[s].branches[0][-1]
            lengths[s] = pool[s].length
        logits = self.executor.decode(tokens, lengths)
        self.executor.counters["branch_tokens"] += len(active)
        vals, ids, lse = self.executor.select_scored(logits)
        freed: List[int] = []
        for s in active:
            st = pool[s]
            st.length += 1           # the input token we just wrote
            st.branches[0].append(int(ids[s, 0]))
            st.scores[0] += float(vals[s, 0] - lse[s])
            self._maybe_retire(s, done, freed)
        self.executor.free_slots(freed)

    def step(self) -> List[Completion]:
        """One round: join arrived requests, then decode.  Join time is
        recorded when a prefill ran, and charged to decode stall when
        decoders sat waiting on it."""
        done: List[Completion] = []
        had_decoders = bool(self.pool.n_used)
        t0 = time.perf_counter()
        n0 = self.executor.counters["prefill_calls"]
        self._join(done)
        if self.executor.counters["prefill_calls"] > n0:
            dt = time.perf_counter() - t0
            self.join_step_s.append(dt)
            if had_decoders:
                self.decode_stall_s += dt
        if self.pool.n_used:
            self._decode_step(done)
        return done
