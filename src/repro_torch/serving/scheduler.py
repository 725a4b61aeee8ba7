"""Request schedulers over the executor's KV pool (paged or contiguous),
as in ``repro/serving/scheduler.py``: the continuous scheduler with its
``SchedulingPolicy`` seam, and the fixed-batch reference mode, both
incremental ``step()`` state machines whose queue and in-flight state
persist across calls.

``ContinuousScheduler.step()`` (1) advances any in-flight CHUNKED prefill
by one segment, (2) joins arrived queued requests into free slots in
policy order (priority class, deadline, arrival), grouped by (prefix hit,
first-segment length bucket), each group one ragged prefill (or, on a
prefix hit, a resume prefill of the suffix) whose logits seed the first
generated token, then (3) runs ONE decode over the decoding slots,
advancing every active request at its own depth; a slot retires when its
item (``decode_len`` tokens) is complete.

``SchedulingPolicy`` is the policy seam: hold windows (``hold_k`` /
``hold_ms``) defer a join until K arrivals or T ms, released at the drain
tail; chunked prefill (``prefill_chunk``) spreads a long history over
steps through ``resume_prefill``; preemption frees the worst decoding slot
for a strictly higher-priority arrival, parking its history in the prefix
store so the requeued request resumes from it.

**Multi-candidate decode** (``Request.n_candidates = K``): a prefilled
slot forks into K branches seeded by the top-K next-token ids; while any
decoding slot has more than one branch, each round advances every branch
of every slot in one tree-decode step (``executor.decode_multi``, the
width bucketed to a power of two, narrower slots padded with dummy
branches whose writes are dropped).  At retirement the branches are
ranked by cumulative log-prob (ties keep seed rank) into
``Completion.items`` / ``scores``.  ``Request.first_token`` forces the
seed of a K = 1 decode.

``FixedBatchScheduler`` is the seed engine's mode: fixed batches of
``batch_size`` formed in submission order (the tail only under
``draining``), one prefill, lock-step decode until the batch retires.

The admission order, bucket grouping, page grants, store plans, slot
assignment and branch handling are the JAX schedulers', so both engines
build the same batches from the same requests.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.executor import PhaseExecutor, bucket_length
from repro_torch.serving.kv_cache import (PrefixEntry, PrefixStore, SlotPool,
                                          SlotState, prefix_hash_chain)

_NO_DEADLINE = float("inf")


def _run_to_empty(sched) -> List["Completion"]:
    """Closed-batch drive loop of both schedulers' ``run()``: step (and
    idle-sleep) under the ``draining`` promise until the scheduler is
    empty."""
    done: List[Completion] = []
    prev, sched.draining = sched.draining, True
    try:
        while sched.has_work:
            done.extend(sched.step())
            wait = sched.idle_wait_s()
            if wait > 0:
                time.sleep(wait)
    finally:
        sched.draining = prev
    return done


@dataclasses.dataclass(eq=False)     # identity equality: queue.remove()
class Request:
    rid: int
    tokens: np.ndarray          # (L,) semantic-ID history
    profile: np.ndarray         # (PROFILE_DIM,)
    arrival_s: float = 0.0      # absolute perf_counter timestamp
    priority: int = 0           # SLA class: lower = more important
    deadline_s: Optional[float] = None  # absolute deadline; None = no SLA
    n_candidates: int = 1       # candidate items decoded (tree branches)
    first_token: Optional[int] = None   # forced seed token (n_candidates 1)
    # memoized prefix-digest chain (content is immutable, the scheduler
    # re-plans every round — hash once, not once per round)
    chain: Optional[List[Tuple[int, str]]] = None


@dataclasses.dataclass
class Completion:
    rid: int
    item: np.ndarray            # (decode_len,) top-ranked generated item
    latency_s: float
    priority: int = 0
    deadline_s: Optional[float] = None
    deadline_missed: bool = False
    # every decoded branch ranked by cumulative log-prob (items[0] is
    # `item`), `scores` aligned with `items`; fixed mode reports the one
    # item unscored
    items: List[np.ndarray] = dataclasses.field(default_factory=list)
    scores: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulingPolicy:
    """The admission/preemption policy seam of ``ContinuousScheduler``.

    ``prefill_chunk`` — max history tokens one prefill program may run for
    a single request (0 = monolithic).  Powers of two avoid bucket-padding
    waste (``executor.bucket_length`` rounds segment shapes up).
    ``preemption`` — allow freeing the worst decoding slot when a
    strictly-higher-priority request is waiting and the pool is full.
    ``hold_k`` / ``hold_ms`` — admission hold window: defer the join round
    until ``hold_k`` arrived requests have accumulated OR the oldest has
    waited ``hold_ms`` milliseconds (either bound alone also works; both
    zero disables holding).  With only ``hold_k`` set, an open system that
    stops short of K requests relies on the drive loop's ``draining`` flag
    to release the tail — set ``hold_ms`` too unless a drain is guaranteed.
    """

    prefill_chunk: int = 0
    preemption: bool = False
    hold_k: int = 0
    hold_ms: float = 0.0

    @property
    def holds_admission(self) -> bool:
        return self.hold_k > 1 or self.hold_ms > 0

    def hold_release(self, n_arrived: int, waited_ms: float,
                     draining_tail: bool) -> bool:
        """True when an arrived admission window may join now.
        ``draining_tail`` = the driver promised no more enqueues AND every
        queued request has arrived — holding longer cannot grow the batch.
        """
        if not self.holds_admission:
            return True
        if self.hold_k > 1 and n_arrived >= self.hold_k:
            return True
        if self.hold_ms > 0 and waited_ms >= self.hold_ms:
            return True
        return draining_tail

    def sort_key(self, r: Request) -> Tuple[int, float, float]:
        """Admission order: priority class, then earliest deadline, then
        arrival (plain FIFO when neither priority nor deadline is set)."""
        return (r.priority,
                r.deadline_s if r.deadline_s is not None else _NO_DEADLINE,
                r.arrival_s)

    def first_segment(self, n_tokens: int) -> int:
        """History tokens the admission-time prefill program covers."""
        return min(n_tokens, self.prefill_chunk) if self.prefill_chunk \
            else n_tokens


@dataclasses.dataclass
class _PendingPrefill:
    """A slot mid-way through a chunked prefill: the request it serves, the
    not-yet-prefilled history suffix, and the absolute cache position the
    next segment writes at.  ``plan`` is the admission-time prefix-store
    plan, kept so the store offer can be made once the row is complete."""

    request: Request
    left: np.ndarray            # history tokens not yet prefilled
    next_start: int             # absolute cache position of the next token
    plan: Optional[Tuple[PrefixEntry, int]]


class ContinuousScheduler:
    """Slot-based continuous batching over the executor's pool.

    ``max_prefill_groups`` caps how many length-bucket prefill programs one
    join round may launch; admission takes the most urgent request's
    bucket first, then the most-populous others, within a ``lookahead``
    window of the queue.  A request joins when a slot is free and, in the
    paged layout, when the page pool can cover its footprint (profile +
    history + its decode span) less the full pages a prefix hit maps in.

    With a ``prefix_store`` admission splits each request into ``cached
    prefix + suffix``: the longest stored item-aligned prefix of ``profile
    + history`` is copied (contiguous arena) or mapped (paged) into the
    slot and only the suffix is prefilled (``resume_prefill``).  The entry
    stays pinned until the request retires; each complete row's full
    item-aligned history is offered back to the store.  At least one
    history token is always left to resume, so the next-token logits come
    from a live forward.

    With ``policy.prefill_chunk`` the admission program covers only the
    first segment; the rest advances one segment per step
    (``_advance_prefills``).  A pending slot holds its row but does not
    decode (index 0: its writes are dropped) until its last segment lands.
    """

    def __init__(self, executor: PhaseExecutor, pool: SlotPool,
                 max_prefill_groups: int = 2, lookahead: int = 0,
                 prefix_store: Optional[PrefixStore] = None,
                 policy: Optional[SchedulingPolicy] = None):
        self.executor = executor
        self.pool = pool
        self.max_prefill_groups = max(1, max_prefill_groups)
        self.lookahead = lookahead or 4 * pool.n_slots
        self.decode_len = executor.cfg.decode_len
        self.paged = executor.paged
        self.store = prefix_store
        self.policy = policy or SchedulingPolicy()
        self._slot_entry: Dict[int, PrefixEntry] = {}
        self._slot_request: Dict[int, Request] = {}
        self._pending: Dict[int, _PendingPrefill] = {}
        self.queue: Deque[Request] = deque()   # arrival-sorted
        self.draining = False     # driver's promise: no further enqueues
        self.reset_window()

    # -- request lifecycle ----------------------------------------------------

    def enqueue(self, r: Request) -> None:
        """Admit ``r`` into the arrival queue (non-blocking).  The queue is
        kept arrival-sorted — submissions usually arrive in time order, so
        the common case is an O(1) append; ties keep submission order."""
        q = self.queue
        if not q or r.arrival_s >= q[-1].arrival_s:
            q.append(r)
            return
        i = next((i for i, other in enumerate(q)
                  if other.arrival_s > r.arrival_s), len(q))
        q.insert(i, r)

    def cancel(self, r: Request) -> bool:
        """Drop ``r`` wherever it is in the lifecycle: still queued (remove
        from the queue), mid-chunked-prefill, or mid-decode (free the slot,
        release its prefix-store pin, clear the device row).  Returns False
        when ``r`` is not held by this scheduler (already retired)."""
        try:
            self.queue.remove(r)             # identity match (eq=False)
            return True
        except ValueError:
            pass
        slot = next((s for s, held in self._slot_request.items()
                     if held is r), None)
        if slot is None:
            return False
        self.pool.free(slot)
        self._slot_request.pop(slot)
        self._pending.pop(slot, None)        # forfeit unfinished segments
        entry = self._slot_entry.pop(slot, None)
        if entry is not None:
            self.store.release(entry)
        self.executor.free_slots([slot])
        return True

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.pool.n_used)

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def idle_wait_s(self) -> float:
        """Seconds a drive loop may sleep before ``step()`` can make
        progress: 0 while anything is in flight (every step advances it);
        otherwise the gap to the next arrival or hold-window release."""
        if self.pool.n_used or not self.queue:
            return 0.0
        now = time.perf_counter()
        head = self.queue[0].arrival_s
        if head > now:                       # nothing has arrived yet
            return head - now
        # arrived but held: wake at the hold deadline or the next arrival,
        # whichever can release the window first
        candidates = []
        if self.policy.hold_ms > 0:
            candidates.append(head + self.policy.hold_ms / 1e3)
        nxt = next((r.arrival_s for r in self.queue if r.arrival_s > now),
                   None)
        if nxt is not None:
            candidates.append(nxt)
        return max(0.0, min(candidates) - now) if candidates else 0.0

    def reset_window(self) -> None:
        """Zero the per-window accounting (the engine windows per stats
        call); queue and in-flight state are NOT touched."""
        self.occupancy = []
        self.join_step_s = []
        self.decode_stall_s = 0.0
        self.preemptions = 0
        self.holds = 0

    # -- step pieces ----------------------------------------------------------

    def _decoding_slots(self) -> List[int]:
        """Slots whose prefill is complete (mid-chunk slots don't decode)."""
        return [s for s in self.pool.used_slots() if s not in self._pending]

    def _seed_slot(self, slot: int, r: Request, ids_row: np.ndarray,
                   vals_row: np.ndarray, lse: float, done: List[Completion],
                   freed: List[int]) -> None:
        """Fork a freshly prefilled slot into its candidate branches: the
        top-``n_candidates`` prefill ids seed one branch each, scored by
        their log-probs.  A forced ``first_token`` seeds the single branch
        instead (scored by its log-prob when it is among the top-k, else
        0)."""
        state = self.pool[slot]
        if r.first_token is not None:
            seeds = [int(r.first_token)]
            match = np.nonzero(ids_row == r.first_token)[0]
            lps = [float(vals_row[match[0]] - lse) if match.size else 0.0]
        else:
            seeds = [int(t) for t in ids_row[:r.n_candidates]]
            lps = [float(v - lse) for v in vals_row[:r.n_candidates]]
        state.n_candidates = len(seeds)
        state.branch_base = state.length
        state.branches = [[s] for s in seeds]
        state.scores = lps
        self._maybe_retire(slot, done, freed)     # decode_len == 1 corner

    def _maybe_retire(self, slot: int, done: List[Completion],
                      freed: List[int]) -> None:
        """Retire ``slot`` once every branch holds a full item: the
        branches ranked by cumulative log-prob (ties keep seed rank) into
        one Completion."""
        state = self.pool[slot]
        if len(state.branches[0]) < self.decode_len:
            return
        final = self.pool.free(slot)
        freed.append(slot)
        self._slot_request.pop(slot, None)
        entry = self._slot_entry.pop(slot, None)
        if entry is not None:           # unpin the prefix backing this slot
            self.store.release(entry)
        finish = time.perf_counter()
        order = sorted(range(final.n_candidates),
                       key=lambda b: (-final.scores[b], b))
        items = [np.asarray(final.branches[b], np.int32) for b in order]
        done.append(Completion(
            rid=final.request_id, item=items[0], items=items,
            scores=[final.scores[b] for b in order],
            latency_s=finish - final.arrival_s,
            priority=final.priority, deadline_s=final.deadline_s,
            deadline_missed=final.deadline_s is not None
            and finish > final.deadline_s))

    def _plan(self, r: Request) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest usable cached prefix for ``r`` as ``(entry, n_tokens)``
        (always leaves >= 1 history token to resume, so next-token logits
        come from a live program).  Re-planned every round: entries may be
        evicted between rounds, and only pinned (admitted) entries are
        stable."""
        if self.store is None:
            return None
        if r.chain is None:
            r.chain = list(prefix_hash_chain(r.profile, r.tokens,
                                             self.store.n_codebooks))
        return self.store.lookup_longest(r.profile, r.tokens,
                                         max_tokens=len(r.tokens) - 1,
                                         chain=r.chain)

    def _footprint(self, r: Request) -> int:
        """Logical cache positions ``r`` can occupy: profile + history +
        one branch span per candidate it decodes (K = 1 traffic reserves
        no multi-candidate spans)."""
        return (len(r.tokens) + 1
                + r.n_candidates * self.executor.branch_stride)

    def _pages_needed(self, r: Request,
                      plan: Optional[Tuple[PrefixEntry, int]]) -> int:
        """Fresh pages ``r``'s admission allocates: its footprint minus the
        FULL pages a prefix hit maps read-only (a partially-matched
        boundary page is copy-on-write — allocated fresh, so not
        subtracted)."""
        pp = self.executor.page_pool
        # matched boundary (plan[1] tokens + profile), NOT the entry's full
        # length — only pages wholly below the boundary are mapped shared
        shared = ((plan[1] + 1) // pp.page_size) if plan is not None else 0
        return pp.pages_for(self._footprint(r)) - shared

    def _bucket(self, r: Request,
                plan: Optional[Tuple[PrefixEntry, int]]) -> Tuple[bool, int]:
        eff = len(r.tokens) - (plan[1] if plan is not None else 0)
        return (plan is not None,
                bucket_length(self.policy.first_segment(eff),
                              self.executor.prefill_bucket_min))

    def _offer_to_store(self, group: List[Request], slots: List[int],
                        plans: List[Optional[Tuple[PrefixEntry, int]]]
                        ) -> None:
        """Admit each request's full item-aligned history to the store
        (one batched pool->arena row copy); dedup and pinned-full stores
        are handled by ``insert`` returning None.  Callers only offer slots
        whose rows hold the COMPLETE history (chunked prefills offer at
        final-segment completion, not at admission)."""
        pending: List[Tuple[int, PrefixEntry]] = []
        for r, slot, plan in zip(group, slots, plans):
            n_full = (len(r.tokens) // self.store.n_codebooks) \
                * self.store.n_codebooks
            # skip only when the matched boundary already covers every full
            # item of r — a hit entry may DIVERGE from r past the boundary,
            # so entry.n_tokens alone proves nothing about r's content
            if n_full <= 0 or (plan is not None and n_full <= plan[1]):
                continue
            entry = self.store.insert(r.profile, r.tokens, n_full,
                                      chain=r.chain)
            if entry is not None:
                pending.append((slot, entry))
        # a later insert in this batch may have evicted an earlier one
        # (store full, everything older pinned): drop dead entries so the
        # batched scatter never writes one arena row from two slots
        live = [(slot, e) for slot, e in pending if self.store.is_live(e)]
        if not live:
            return
        if self.paged:
            # ZERO-COPY store admit: the entry becomes extra references on
            # the donor slot's pages below the entry boundary — no arena,
            # no device copy.  The donor only appends past the boundary,
            # and restore COW-masks the boundary page's tail, so the
            # shared content is immutable.
            for slot, e in live:
                e.pages = self.executor.share_prefix(slot, e.length)
        else:
            self.executor.prefix_save([s for s, _ in live],
                                      [e.row for _, e in live])

    # -- preemption -----------------------------------------------------------

    def _victim_order(self, slot: int) -> Tuple[int, float, float]:
        """Worst-first sort key (used reversed): highest class number, then
        slackest deadline, then most recent arrival gets preempted first."""
        st = self.pool[slot]
        return (st.priority,
                st.deadline_s if st.deadline_s is not None else _NO_DEADLINE,
                st.arrival_s)

    def _preempt(self, slot: int, queue: Deque[Request]) -> None:
        """Free ``slot`` mid-decode and requeue its request.

        The row's item-aligned history K/V is offered to the prefix store
        FIRST (generated-token positions past the boundary are masked out
        on restore), so the re-admission resumes via a row copy + suffix
        prefill.  Generated tokens are discarded; greedy decode regenerates
        them identically.  The requeued request keeps its original arrival,
        so its latency accounting spans the preemption.
        """
        r = self._slot_request.pop(slot)
        self.pool.free(slot)
        if self.store is not None:
            n_full = (len(r.tokens) // self.store.n_codebooks) \
                * self.store.n_codebooks
            if n_full > 0:
                # force past second-sight admission: this K/V WILL be
                # re-requested (the preempted request resumes through it)
                entry = self.store.insert(r.profile, r.tokens, n_full,
                                          chain=r.chain, force=True)
                if entry is not None and self.store.is_live(entry):
                    if self.paged:
                        # reference the slot's pages BEFORE free_slots
                        # drops them — the store's refs keep the prefix
                        # alive after the slot's own refs go
                        entry.pages = self.executor.share_prefix(
                            slot, entry.length)
                    else:
                        # copy BEFORE free_slots clears the row's occupancy
                        self.executor.prefix_save([slot], [entry.row])
        old = self._slot_entry.pop(slot, None)
        if old is not None:
            self.store.release(old)
        self.executor.free_slots([slot])
        # requeue at the request's arrival-order position (priority
        # admission means it need not be the oldest in flight), keeping
        # the queue's arrival-sorted invariant for the lookahead window
        # and run()'s idle-sleep
        i = next((i for i, q in enumerate(queue)
                  if q.arrival_s > r.arrival_s), len(queue))
        queue.insert(i, r)
        self.preemptions += 1

    def _maybe_preempt(self, window: List[Request],
                       queue: Deque[Request]) -> None:
        """Free decoding slots for strictly-higher-priority arrivals when
        the pool is full.  One victim per displaced request; mid-chunk
        prefill slots are never victims (their rows are incomplete, so a
        preempt would forfeit the prefill work without a store offer)."""
        if not self.policy.preemption or not window:
            return
        victims = sorted(self._decoding_slots(), key=self._victim_order,
                         reverse=True)
        avail = self.pool.n_free
        for r in window:              # most urgent first (policy-sorted)
            if avail:                 # a free slot serves r without violence
                avail -= 1
                continue
            if not victims:
                return
            if self.pool[victims[0]].priority <= r.priority:
                return  # window is sorted: nobody later outranks this slot
            self._preempt(victims.pop(0), queue)
            avail = 0                 # the freed slot is consumed by r

    # -- chunked prefill ------------------------------------------------------

    def _register_segments(self, group: List[Request], slots: List[int],
                           plans: List[Optional[Tuple[PrefixEntry, int]]],
                           first_lens: List[int], starts: List[int]) -> None:
        """After a join group's first prefill program: track every row whose
        history extends past its first segment for per-step continuation."""
        for r, slot, plan, n_first, start in zip(group, slots, plans,
                                                 first_lens, starts):
            n_cached = plan[1] if plan is not None else 0
            if n_cached + n_first < len(r.tokens):
                self._pending[slot] = _PendingPrefill(
                    request=r, left=r.tokens[n_cached + n_first:],
                    next_start=start + n_first, plan=plan)

    def _advance_prefills(self, done: List[Completion]) -> None:
        """Run ONE chunk segment for pending slots, grouped by segment
        bucket (at most ``max_prefill_groups`` programs; leftover groups
        continue next step).  A slot whose last segment lands here gets its
        first generated token from the segment's logits and is offered to
        the prefix store — exactly the monolithic admission path, spread
        over steps."""
        if not self._pending:
            return
        chunk = self.policy.prefill_chunk
        by_bucket: Dict[int, List[int]] = {}
        for slot, p in self._pending.items():
            b = bucket_length(min(len(p.left), chunk),
                              self.executor.prefill_bucket_min)
            by_bucket.setdefault(b, []).append(slot)
        order = sorted(by_bucket, key=lambda b: -len(by_bucket[b]))
        for b in order[:self.max_prefill_groups]:
            slots = by_bucket[b]
            segments = [self._pending[s].left[:chunk] for s in slots]
            starts = [self._pending[s].next_start for s in slots]
            logits = self.executor.resume_prefill(segments, slots, starts)
            finished: List[Tuple[int, int, Request]] = []  # (row, slot, r)
            for i, slot in enumerate(slots):
                p = self._pending[slot]
                p.left = p.left[chunk:]
                p.next_start += len(segments[i])
                if len(p.left) == 0:
                    del self._pending[slot]
                    if self.store is not None:
                        self._offer_to_store([p.request], [slot], [p.plan])
                    finished.append((i, slot, p.request))
            if finished:
                vals, ids, lse = self.executor.select_scored(logits)
                freed: List[int] = []
                for i, slot, r in finished:
                    self._seed_slot(slot, r, ids[i], vals[i], float(lse[i]),
                                    done, freed)
                self.executor.free_slots(freed)

    # -- admission ------------------------------------------------------------

    def _join(self, queue: Deque[Request], done: List[Completion]) -> None:
        """Admit ARRIVED queued requests into free slots in policy order
        (priority class, deadline, arrival), grouped by (prefix-hit,
        first-segment length bucket)."""
        if not queue or (not self.pool.n_free
                         and not self.policy.preemption):
            return      # full pool + no violence allowed: skip the window
        now = time.perf_counter()
        window = sorted((r for r in list(queue)[:self.lookahead]
                         if r.arrival_s <= now), key=self.policy.sort_key)
        if not window:
            return
        if self.policy.holds_admission:
            oldest = min(r.arrival_s for r in window)
            tail = self.draining and all(r.arrival_s <= now for r in queue)
            if not self.policy.hold_release(len(window),
                                            (now - oldest) * 1e3, tail):
                self.holds += 1
                return
        self._maybe_preempt(window, queue)
        free = self.pool.n_free
        if not free:
            return
        plans = {id(r): self._plan(r) for r in window}
        bucket_of = {id(r): self._bucket(r, plans[id(r)]) for r in window}
        by_bucket: Dict[Tuple[bool, int], List[Request]] = {}
        for r in window:
            by_bucket.setdefault(bucket_of[id(r)], []).append(r)
        # most urgent request's bucket first (no starvation within the
        # policy order), then the fullest others; requests are then taken
        # in POLICY order across the chosen buckets, so a slot freed by
        # preemption can never go to a lower-priority bucket-mate while
        # the displacing request waits
        head_b = bucket_of[id(window[0])]
        order = [head_b] + sorted((b for b in by_bucket if b != head_b),
                                  key=lambda b: -len(by_bucket[b]))
        chosen = set(order[:self.max_prefill_groups])
        joiners: List[Request] = []
        groups: Dict[Tuple[bool, int], List[Request]] = {}
        committed = 0   # pages claimed by already-selected joiners (paged)
        for r in window:
            if len(joiners) >= free:
                break
            b = bucket_of[id(r)]
            if b not in chosen:
                continue
            plan = plans[id(r)]
            if self.paged:
                # paged admission gate: this request needs its footprint's
                # pages minus whatever a prefix hit maps in read-only.  Pin
                # the hit FIRST so reclaim can't evict it, then evict LRU
                # store entries until the grant fits; if the pool still
                # can't cover it, stop admitting this round.
                if plan is not None and not self.store.is_live(plan[0]):
                    continue    # reclaimed moments ago: re-plan next round
                if plan is not None:
                    self.store.acquire(plan[0])
                need = self._pages_needed(r, plan)
                while self.executor.page_pool.n_free - committed < need:
                    if self.store is None or not self.store.evict_for_pages():
                        break
                if self.executor.page_pool.n_free - committed < need:
                    if plan is not None:
                        self.store.release(plan[0])
                    break
                committed += need
            elif plan is not None:
                # pin every admitted hit NOW: this round's store inserts may
                # evict any unpinned entry; a plan must not go stale mid-round
                self.store.acquire(plan[0])
            if self.store is not None:
                self.store.note_admission(plan[1] if plan else None)
            groups.setdefault(b, []).append(r)
            joiners.append(r)
        taken = {id(r) for r in joiners}
        if taken:  # one O(len(queue)) rotation, preserving order
            for _ in range(len(queue)):
                r = queue.popleft()
                if id(r) not in taken:
                    queue.append(r)
        for (is_hit, _), group in groups.items():
            group_plans = [plans[id(r)] for r in group]
            slots = []
            for r in group:
                slot = self.pool.alloc(SlotState(
                    request_id=r.rid, length=len(r.tokens) + 1,  # + profile
                    n_candidates=r.n_candidates,
                    arrival_s=r.arrival_s, priority=r.priority,
                    deadline_s=r.deadline_s))
                slots.append(slot)
                self._slot_request[slot] = r
            if is_hit:
                for slot, plan in zip(slots, group_plans):
                    self._slot_entry[slot] = plan[0]  # release at retire
                # matched boundary + profile token = resume offset; the
                # restore masks the row down to it, so an entry longer
                # than the match never leaks positions past the boundary
                starts = [n_tok + 1 for _, n_tok in group_plans]
                if self.paged:
                    # ZERO-COPY hit: map the entry's pages read-only into
                    # the new slot's table (+ at most one boundary COW) —
                    # the join gate above reserved the fresh pages
                    for slot, r, (entry, n_tok) in zip(slots, group,
                                                       group_plans):
                        ok = self.executor.attach_prefix(
                            slot, entry.pages, n_tok + 1,
                            self._footprint(r))
                        assert ok, "page grant raced the admission gate"
                else:
                    self.executor.prefix_copy_insert(
                        [p.row for p, _ in group_plans], slots, starts)
                suffixes = [r.tokens[n_tok:]
                            for r, (_, n_tok) in zip(group, group_plans)]
                first_lens = [self.policy.first_segment(len(s))
                              for s in suffixes]
                logits = self.executor.resume_prefill(
                    [s[:n] for s, n in zip(suffixes, first_lens)],
                    slots, starts)
            else:
                if self.paged:
                    for slot, r in zip(slots, group):
                        ok = self.executor.grant_slot(slot,
                                                      self._footprint(r))
                        assert ok, "page grant raced the admission gate"
                starts = [1] * len(group)          # after the profile token
                first_lens = [self.policy.first_segment(len(r.tokens))
                              for r in group]
                logits = self.executor.prefill_insert(
                    [r.tokens[:n] for r, n in zip(group, first_lens)],
                    [r.profile for r in group], slots)
            self._register_segments(group, slots, group_plans, first_lens,
                                    starts)
            # offer COMPLETE rows to the store before any retire can clear
            # them; chunked rows are offered at final-segment completion
            complete = [(r, s, p) for r, s, p in zip(group, slots,
                                                     group_plans)
                        if s not in self._pending]
            if self.store is not None and complete:
                self._offer_to_store([c[0] for c in complete],
                                     [c[1] for c in complete],
                                     [c[2] for c in complete])
            vals, ids, lse = self.executor.select_scored(logits)
            freed: List[int] = []
            for i, slot in enumerate(slots):
                if slot in self._pending:
                    continue        # mid-chunk: logits are not next-token
                self._seed_slot(slot, group[i], ids[i], vals[i],
                                float(lse[i]), done, freed)
            # clear before the NEXT group can reallocate a freed slot
            # (reachable only when decode_len == 1: prefill completes)
            self.executor.free_slots(freed)

    def _decode_step(self, done: List[Completion]) -> None:
        """One decode over the decoding slots of the pool; free rows and
        rows mid-chunk ride along at index 0 with their writes not made.
        While any slot has more than one branch the round is one TREE
        decode: the width bucketed to a power of two (capped at the
        executor's capacity), narrower slots padded with dummy branches
        that repeat their last token, whose writes are dropped and whose
        outputs are discarded."""
        pool = self.pool
        active = self._decoding_slots()
        width = max((pool[s].n_candidates for s in active), default=1)
        n_branches = sum(pool[s].n_candidates for s in active)
        self.occupancy.append(pool.occupancy)
        freed: List[int] = []
        if width == 1:
            tokens = np.zeros((pool.n_slots, 1), np.int32)
            lengths = np.zeros((pool.n_slots,), np.int32)
            for s in active:
                tokens[s, 0] = pool[s].branches[0][-1]
                lengths[s] = pool[s].length
            logits = self.executor.decode(tokens, lengths)
            self.executor.counters["branch_tokens"] += n_branches
            vals, ids, lse = self.executor.select_scored(logits)
            for s in active:
                st = pool[s]
                st.length += 1           # the input token we just wrote
                st.branches[0].append(int(ids[s, 0]))
                st.scores[0] += float(vals[s, 0] - lse[s])
                self._maybe_retire(s, done, freed)
        else:
            c = min(bucket_length(width, 1), self.executor.n_candidates)
            tokens = np.zeros((pool.n_slots, c), np.int32)
            lengths = np.zeros((pool.n_slots,), np.int32)
            starts = np.zeros((pool.n_slots,), np.int32)
            counts = np.zeros((pool.n_slots,), np.int32)
            for s in active:
                st = pool[s]
                last = st.last_tokens
                for b in range(c):       # dummy branches repeat the last
                    tokens[s, b] = last[min(b, st.n_candidates - 1)]
                lengths[s] = st.length
                starts[s] = st.branch_base
                counts[s] = st.n_candidates
            logits = self.executor.decode_multi(tokens, lengths, starts,
                                                counts)
            vals, ids, lse = self.executor.select_scored(logits)
            for s in active:
                st = pool[s]
                st.length += 1
                for b in range(st.n_candidates):
                    st.branches[b].append(int(ids[s, b, 0]))
                    st.scores[b] += float(vals[s, b, 0] - lse[s, b])
                self._maybe_retire(s, done, freed)
        self.executor.free_slots(freed)  # one clear per step

    # -- the step state machine ----------------------------------------------

    def step(self) -> List[Completion]:
        """One scheduler round over the persistent state: advance chunked
        prefills, join arrived requests, decode.  Non-blocking — an empty
        round (nothing arrived, nothing in flight) is a cheap no-op; drive
        loops sleep on ``idle_wait_s()`` instead of spinning."""
        done: List[Completion] = []
        # join-step accounting: everything before decode is prefill work;
        # time it only when a prefill program actually ran, and charge it
        # to decode stall when decoders sat waiting on it
        had_decoders = bool(self._decoding_slots())
        t0 = time.perf_counter()
        n0 = self.executor.counters["prefill_calls"]
        self._advance_prefills(done)
        self._join(self.queue, done)
        if self.executor.counters["prefill_calls"] > n0:
            dt = time.perf_counter() - t0
            self.join_step_s.append(dt)
            if had_decoders:
                self.decode_stall_s += dt
        if self._decoding_slots():
            self._decode_step(done)
        return done

    def run(self, requests: List[Request]) -> List[Completion]:
        """Closed-batch wrapper over enqueue + step."""
        for r in requests:
            self.enqueue(r)
        return _run_to_empty(self)


@dataclasses.dataclass
class _FixedBatch:
    """One in-flight lock-step batch of the fixed scheduler."""

    requests: List[Request]     # real members (tail padding excluded)
    slots: List[int]            # one pool slot per PADDED row
    gen: List[List[int]]        # generated tokens per padded row
    last: np.ndarray            # (B, 1) next decode inputs
    lengths: np.ndarray         # (B,) per-row cache occupancy
    steps_left: int             # decode steps until retire


class FixedBatchScheduler:
    """The seed engine's mode: fixed batches, a padded tail, lock-step
    decode.  Batches of ``batch_size`` form in submission order once their
    last member has arrived (a partial tail only under ``draining``), take
    slots 0.. of the pool (the tail padded by repeating its last request),
    run one monolithic prefill and decode together until the item is
    complete.  One join-step sample per batch; ``cancel`` reaches only
    queued requests."""

    def __init__(self, executor: PhaseExecutor, pool: SlotPool,
                 batch_size: int):
        if batch_size > pool.n_slots:
            raise ValueError(f"batch_size {batch_size} exceeds pool size "
                             f"{pool.n_slots}")
        self.executor = executor
        self.pool = pool
        self.batch_size = batch_size
        self.decode_len = executor.cfg.decode_len
        self.queue: Deque[Request] = deque()   # submission order
        self.draining = False
        self._active: Optional[_FixedBatch] = None
        self.reset_window()

    # -- request lifecycle ----------------------------------------------------

    def enqueue(self, r: Request) -> None:
        """Queue ``r`` in submission order (batches chunk the submission
        sequence positionally)."""
        self.queue.append(r)

    def cancel(self, r: Request) -> bool:
        """Remove a still-queued request; an in-flight lock-step row
        retires with its batch, so cancelling it returns False."""
        try:
            self.queue.remove(r)
            return True
        except ValueError:
            return False

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or self._active is not None

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    def idle_wait_s(self) -> float:
        """Gap until the next formable batch can launch (its last member's
        arrival); 0 while a batch decodes or while formation waits on more
        submissions."""
        if self._active is not None or not self.queue:
            return 0.0
        need = self._formable()
        if not need:
            return 0.0
        latest = max(self.queue[i].arrival_s for i in range(need))
        return max(0.0, latest - time.perf_counter())

    def reset_window(self) -> None:
        self.occupancy: List[float] = []
        self.join_step_s: List[float] = []
        self.decode_stall_s = 0.0    # lock-step: decode never overlaps join
        self.preemptions = 0
        self.holds = 0               # fixed mode has no admission holds

    # -- the step state machine ----------------------------------------------

    def _formable(self) -> int:
        """Members of the next launchable batch: a full ``batch_size``, or
        the partial tail once the drive loop promised no more submissions."""
        if len(self.queue) >= self.batch_size:
            return self.batch_size
        return len(self.queue) if self.draining else 0

    def _form_batch(self) -> bool:
        need = self._formable()
        if not need:
            return False
        chunk = [self.queue[i] for i in range(need)]
        # a fixed batch launches only once its LAST member has arrived
        if max(r.arrival_s for r in chunk) > time.perf_counter():
            return False
        for _ in range(need):
            self.queue.popleft()
        padded = chunk + [chunk[-1]] * (self.batch_size - need)
        slots = [self.pool.alloc(SlotState(
            request_id=r.rid, length=len(r.tokens) + 1,
            arrival_s=r.arrival_s, priority=r.priority,
            deadline_s=r.deadline_s)) for r in padded]
        t0 = time.perf_counter()
        logits = self.executor.prefill_insert(
            [r.tokens for r in padded], [r.profile for r in padded], slots)
        _, ids = self.executor.select(logits)
        self.join_step_s.append(time.perf_counter() - t0)
        ids = ids[:len(slots)]                  # drop bucket-pad rows
        self._active = _FixedBatch(
            requests=chunk, slots=slots,
            gen=[[int(t)] for t in ids[:, 0]],
            last=np.asarray(ids[:, :1], np.int32),
            lengths=np.asarray([self.pool[s].length for s in slots],
                               np.int32),
            steps_left=self.decode_len - 1)
        return True

    def _decode_once(self) -> None:
        b = self._active
        tokens = np.zeros((self.pool.n_slots, 1), np.int32)
        lens = np.zeros((self.pool.n_slots,), np.int32)
        tokens[b.slots, 0] = b.last[:, 0]
        lens[b.slots] = b.lengths
        logits = self.executor.decode(tokens, lens)
        _, ids = self.executor.select(logits)
        self.occupancy.append(len(b.requests) / self.pool.n_slots)
        b.lengths = b.lengths + 1
        b.last = np.asarray(ids[b.slots, :1], np.int32)
        for row, toks in enumerate(b.gen):
            toks.append(int(b.last[row, 0]))
        b.steps_left -= 1

    def _retire(self) -> List[Completion]:
        b, self._active = self._active, None
        finish = time.perf_counter()
        done = []
        for row, r in enumerate(b.requests):  # drop padded duplicates
            item = np.asarray(b.gen[row], np.int32)
            done.append(Completion(
                rid=r.rid, item=item, items=[item],
                latency_s=finish - r.arrival_s,
                priority=r.priority, deadline_s=r.deadline_s,
                deadline_missed=r.deadline_s is not None
                and finish > r.deadline_s))
        retired = sorted(set(b.slots))
        for s in retired:
            self.pool.free(s)
        self.executor.free_slots(retired)   # one clear per batch
        return done

    def step(self) -> List[Completion]:
        """One lock-step round: form and prefill the next batch, or decode
        the active one; the batch retires when its last decode lands."""
        if self._active is None and not self._form_batch():
            return []
        if self._active.steps_left > 0:
            self._decode_once()
        if self._active.steps_left == 0:
            return self._retire()
        return []

    def run(self, requests: List[Request]) -> List[Completion]:
        """Closed-batch wrapper over enqueue + step."""
        for r in requests:
            self.enqueue(r)
        return _run_to_empty(self)
