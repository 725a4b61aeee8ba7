"""Host-side KV bookkeeping for the paged serving pool: the slot pool
(free list + per-slot decode progress) and the refcounted page allocator,
copied from ``repro/serving/kv_cache.py`` (pure numpy/stdlib).  The
content-addressed prefix store waits for a later slice."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

# The one page-table index dtype. int32 is safe for every flat index the
# pool can produce — (n_pages + 1) * page_size stays far below 2**31 —
# and matches the device-side gather operand dtype, so host index math
# never widens to int64 and back (the `index-dtype-drift` lint rule).
INDEX_DTYPE = np.int32


def as_index(x) -> np.ndarray:
    """Coerce slot ids / page tables / offsets to ``INDEX_DTYPE``."""
    return np.asarray(x, dtype=INDEX_DTYPE)


@dataclasses.dataclass
class SlotState:
    """One occupied slot: the request it serves and its decode progress.

    Decode progress is per CANDIDATE BRANCH (multi-candidate tree decode;
    single-candidate requests are the ``n_candidates = 1`` special case):
    ``branches[b]`` holds branch b's generated tokens (the seed token
    first), ``scores[b]`` its cumulative log-prob, and ``branch_base`` the
    logical position the branches fork at (= the prefix occupancy when the
    seeds were drawn; -1 until the prefill completes and seeds the slot).
    ``length`` stays the SHARED logical depth — all branches of a slot
    decode in lock-step, one position per engine round.

    ``priority`` / ``deadline_s`` mirror the request's SLA class so the
    scheduler's preemption victim selection and deadline accounting read
    pool state only (no back-pointer into the queue).  ``deadline_s`` is an
    absolute ``perf_counter`` timestamp like ``arrival_s``; None = no SLA.
    """

    request_id: int
    length: int                 # positions in the cache (profile + history + generated)
    n_candidates: int = 1
    branches: List[List[int]] = dataclasses.field(default_factory=list)
    scores: List[float] = dataclasses.field(default_factory=list)
    branch_base: int = -1       # logical fork position; -1 = not seeded yet
    arrival_s: float = 0.0
    priority: int = 0           # SLA class: lower = more important
    deadline_s: Optional[float] = None

    @property
    def generated(self) -> List[int]:
        """Branch-0 view (single-candidate compatibility)."""
        return self.branches[0] if self.branches else []

    @property
    def last_tokens(self) -> List[int]:
        """Next decode-step input per branch."""
        return [b[-1] for b in self.branches]


class SlotPool:
    """Fixed pool of KV-cache slots with alloc/free and per-slot lengths."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots - 1, -1, -1))  # pop() -> 0 first
        self._slots: Dict[int, SlotState] = {}

    # -- allocation -----------------------------------------------------------

    def alloc(self, state: SlotState) -> Optional[int]:
        """Claim a free slot for ``state``; None when the pool is exhausted."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._slots[slot] = state
        return slot

    def free(self, slot: int) -> SlotState:
        """Release ``slot``; returns its final state.  A fully drained pool
        re-normalizes its free list to the virgin order, so slot assignment
        — and therefore program batch composition — is a function of the
        workload, not of how previous windows happened to retire (the pool
        persists across the engine's serve calls)."""
        state = self._slots.pop(slot)  # KeyError on double-free / bad id
        self._free.append(slot)
        if not self._slots:
            self._free = list(range(self.n_slots - 1, -1, -1))
        return state

    # -- views ----------------------------------------------------------------

    def __contains__(self, slot: int) -> bool:
        return slot in self._slots

    def __getitem__(self, slot: int) -> SlotState:
        return self._slots[slot]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return len(self._slots)

    @property
    def occupancy(self) -> float:
        return self.n_used / self.n_slots

    def used_slots(self) -> List[int]:
        return sorted(self._slots)

    def lengths(self, fill: int = 0) -> List[int]:
        """Per-slot lengths, dense over the pool (``fill`` for free slots)."""
        return [self._slots[i].length if i in self._slots else fill
                for i in range(self.n_slots)]


# ---------------------------------------------------------------------------
# Paged layout: refcounted page allocator over the unified device pool
# ---------------------------------------------------------------------------


class PagePool:
    """Host-side allocator for the unified device KV page pool.

    Under the paged layout both cache tiers share ONE device pool of
    ``n_pages`` fixed-size pages (``page_size`` logical positions each);
    a request's cache row becomes a per-slot PAGE TABLE (list of page
    indices) and a stored prefix becomes extra references on the pages it
    covers.  This class is the pure-host bookkeeping: a free list plus a
    per-page refcount.  ``alloc`` claims virgin pages at refcount 1;
    ``share`` adds a reference (zero-copy prefix save/hit — the device
    bytes are never touched); ``release`` drops one and reports which
    pages actually hit zero so the caller can clear their device ``pos``
    lane (the executor's ``free_pages`` program).  A page with
    refcount > 0 is PINNED: it is never on the free list, so it can never
    be handed to another request — eviction of a store entry whose pages
    a live slot still maps releases only the store's reference.

    Like ``SlotPool``, a fully drained free list re-normalizes to the
    virgin order so page assignment is a function of the workload, not of
    how previous windows retired.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages <= 0:
            raise ValueError(f"n_pages must be positive, got {n_pages}")
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._refs: List[int] = [0] * n_pages

    def pages_for(self, n_positions: int) -> int:
        """Pages covering ``n_positions`` logical cache positions."""
        return -(-max(n_positions, 0) // self.page_size)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Claim ``n`` virgin pages at refcount 1; None (and NO partial
        grant) when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError(f"alloc of {n} pages")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refs[p] = 1
        return pages

    def share(self, pages: List[int]) -> List[int]:
        """Add one reference to each page (zero-copy mapping of live
        content into another owner); returns the same list for chaining."""
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"share of free page {p}")
        for p in pages:
            self._refs[p] += 1
        return list(pages)

    def release(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; returns the pages whose refcount
        hit zero (now back on the free list — the caller must clear their
        device ``pos`` lane before they can be re-granted)."""
        freed: List[int] = []
        for p in pages:
            if self._refs[p] <= 0:
                raise ValueError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                freed.append(p)
                self._free.append(p)
        if len(self._free) == self.n_pages:
            self._free = list(range(self.n_pages - 1, -1, -1))
        return freed

    def refcount(self, page: int) -> int:
        return self._refs[page]

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        return self.n_pages - len(self._free)
