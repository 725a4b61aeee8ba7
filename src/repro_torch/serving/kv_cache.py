"""Host-side KV bookkeeping of the serving pool, copied from
``repro/serving/kv_cache.py`` (pure numpy/stdlib): the slot pool (free list
+ per-slot decode progress), the refcounted page allocator of the paged
layout, and tier 2, the content-addressed prefix store (``PrefixStore``
over the executor's arena rows, or over refcounted pool pages in the paged
layout).  The digests are the JAX package's byte for byte: the same blake2b
input bytes at the same item granularity."""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Tier 2: content-addressed prefix store
# ---------------------------------------------------------------------------


def prefix_hash_chain(profile: np.ndarray, tokens: np.ndarray,
                      n_codebooks: int) -> Iterator[Tuple[int, str]]:
    """Yield ``(n_tokens, digest)`` for every item-boundary prefix of
    ``profile ⊕ tokens``, shortest first.

    The digest chains block-by-block (one block = one item =
    ``n_codebooks`` tokens), so computing every prefix hash of an
    L-token history is one O(L) pass, and equal content always yields
    equal digests — across requests, engines, and processes (blake2b,
    not Python's salted ``hash``).  Only FULL items participate: a
    trailing partial item is never a cacheable boundary.
    """
    profile = np.ascontiguousarray(profile, np.float32)
    tokens = np.ascontiguousarray(tokens, np.int32)
    h = hashlib.blake2b(digest_size=16)
    h.update(b"profile:")
    h.update(profile.tobytes())
    for i in range(len(tokens) // n_codebooks):
        h.update(b"item:")
        h.update(tokens[i * n_codebooks:(i + 1) * n_codebooks].tobytes())
        yield (i + 1) * n_codebooks, h.hexdigest()


@dataclasses.dataclass
class PrefixEntry:
    """One cached prefix: content digest -> arena row holding its K/V.

    Because K/V rows are causal, the row is valid for EVERY item boundary
    of its content, not just the full ``n_tokens`` — ``digests`` keeps the
    whole boundary chain so shorter prefixes of the same content can hit
    this row too (the restore masks positions past the matched boundary).
    """

    key: str                    # chained content digest (full boundary)
    row: int                    # arena row index backing this prefix
    n_tokens: int               # history tokens covered (item-aligned)
    refcount: int = 0           # in-flight requests pinned on this row
    digests: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    # paged layout: the refcounted pool pages holding this prefix's K/V
    # (``row`` stays -1 — there is no arena; eviction releases these refs)
    pages: List[int] = dataclasses.field(default_factory=list)

    @property
    def length(self) -> int:
        """Cache positions occupied: profile token + history tokens."""
        return self.n_tokens + 1


class PrefixStore:
    """Refcounted, content-addressed, LRU-evicted index over arena rows.

    Invariants (held against the JAX store in ``tests/test_torch_prefix.py``):
      * every live entry owns a distinct arena row in ``[0, n_rows)``;
      * ``bytes_used <= max_bytes`` always;
      * a pinned entry (``refcount > 0``) is never evicted — ``insert``
        fails (returns None) rather than touch a pinned row;
      * lookup/insert refresh recency; eviction takes the least-recently
        used unpinned entry.

    Admission policy: with ``store_on_first_sight=False`` the store runs
    TinyLFU-style *second-sight* admission — the first offer of a content
    family only records its item-boundary digests in a bounded doorkeeper;
    an arena row is granted when an offer SHARES a boundary with an
    earlier one (an exact repeat, or a revisiting user's extended
    history).  One-off traffic (most requests, in a low-repeat regime)
    then never churns the arena, while anything sighted twice — the
    traffic that can actually produce hits — is stored exactly as before.
    ``insert(force=True)`` bypasses the doorkeeper (preemption parks K/V
    it KNOWS will be re-requested).

    Hit/miss/saved-token stats are windowed: ``reset_window()`` zeroes them
    while the entries (and their device rows) persist — the engine windows
    per ``serve_requests`` call, matching its other counters.
    """

    def __init__(self, n_rows: int, row_bytes: int,
                 max_bytes: int = 0, n_codebooks: int = 3,
                 store_on_first_sight: bool = True,
                 seen_capacity: int = 0,
                 release_pages: Optional[Callable[[List[int]], None]] = None):
        if n_rows <= 0:
            raise ValueError(f"n_rows must be positive, got {n_rows}")
        self.n_rows = n_rows
        self.row_bytes = row_bytes
        self.max_bytes = max_bytes or n_rows * row_bytes
        self.n_codebooks = n_codebooks
        self.store_on_first_sight = store_on_first_sight
        # paged layout: entries hold refcounted POOL PAGES instead of arena
        # rows — ``n_rows`` caps entry count, ``row_bytes`` is the price of
        # one PAGE, and eviction releases the entry's page references
        # through this callback (the executor drops them back to the
        # PagePool and clears freed pages' device ``pos`` lane)
        self.page_mode = release_pages is not None
        self._release_pages = release_pages
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        # every item-boundary digest of every entry -> (entry key, boundary
        # tokens); one arena row serves all prefixes of its content
        self._index: Dict[str, Tuple[str, int]] = {}
        self._free_rows: List[int] = list(range(n_rows - 1, -1, -1))
        # second-sight doorkeeper: item-boundary digests seen in offers,
        # LRU-bounded (sized for whole boundary CHAINS, ~history-length
        # digests per offer, across a few arena turnovers)
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._seen_cap = seen_capacity or 64 * n_rows
        self.reset_window()

    # -- windowed stats -------------------------------------------------------

    def reset_window(self) -> None:
        self.admissions = 0       # requests admitted to slots (denominator)
        self.hits = 0             # ... of which reused a stored prefix
        self.tokens_saved = 0     # history tokens served from the store
        self.evictions = 0
        self.insertions = 0
        self.first_sights = 0     # offers the doorkeeper recorded-not-stored
        self.peak_bytes_pinned = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / self.admissions if self.admissions else 0.0

    def note_admission(self, hit_tokens: Optional[int]) -> None:
        """Count one admitted request against the hit-rate window
        (``hit_tokens`` is the reused-prefix length, or None on a miss).
        Kept separate from ``lookup_longest`` because the scheduler
        re-plans un-admitted queue entries every round — only admissions
        count."""
        self.admissions += 1
        if hit_tokens is not None:
            self.hits += 1
            self.tokens_saved += hit_tokens

    # -- capacity views -------------------------------------------------------

    @property
    def n_entries(self) -> int:
        return len(self._entries)

    @property
    def bytes_used(self) -> int:
        if self.page_mode:
            return sum(len(e.pages) for e in self._entries.values()) \
                * self.row_bytes
        return len(self._entries) * self.row_bytes

    @property
    def bytes_pinned(self) -> int:
        if self.page_mode:
            return sum(len(e.pages) for e in self._entries.values()
                       if e.refcount > 0) * self.row_bytes
        return sum(1 for e in self._entries.values()
                   if e.refcount > 0) * self.row_bytes

    # -- lookup / pinning -----------------------------------------------------

    def lookup_longest(self, profile: np.ndarray, tokens: np.ndarray,
                       max_tokens: Optional[int] = None,
                       chain: Optional[List[Tuple[int, str]]] = None
                       ) -> Optional[Tuple[PrefixEntry, int]]:
        """Longest stored prefix of ``profile ⊕ tokens`` (item-aligned,
        ``<= max_tokens`` history tokens); None on miss, else
        ``(entry, n_tokens)`` where ``n_tokens <= entry.n_tokens`` is the
        matched boundary (the restore masks the row down to it).  A hit
        refreshes the entry's recency; stats are counted at admission
        (``note_admission``), not here.  ``chain`` short-circuits the
        digest computation — content is immutable per request, so callers
        that re-plan every round memoize it."""
        limit = len(tokens) if max_tokens is None else max_tokens
        if chain is None:
            chain = prefix_hash_chain(profile, tokens, self.n_codebooks)
        best: Optional[Tuple[str, int]] = None
        for n_tok, digest in chain:
            if n_tok > limit:
                break
            hit = self._index.get(digest)
            if hit is not None:
                best = hit               # chain is shortest-first: keep last
        if best is None:
            return None
        entry = self._entries[best[0]]
        self._entries.move_to_end(entry.key)
        return entry, best[1]

    def is_live(self, entry: PrefixEntry) -> bool:
        """True while ``entry`` still owns its arena row (not evicted)."""
        return self._entries.get(entry.key) is entry

    def acquire(self, entry: PrefixEntry) -> None:
        """Pin ``entry``'s row for an in-flight request."""
        entry.refcount += 1
        self.peak_bytes_pinned = max(self.peak_bytes_pinned,
                                     self.bytes_pinned)

    def release(self, entry: PrefixEntry) -> None:
        if entry.refcount <= 0:
            raise ValueError(f"release of unpinned prefix {entry.key}")
        entry.refcount -= 1

    # -- insertion / eviction -------------------------------------------------

    def insert(self, profile: np.ndarray, tokens: np.ndarray,
               n_tokens: int,
               chain: Optional[List[Tuple[int, str]]] = None,
               force: bool = False) -> Optional[PrefixEntry]:
        """Admit the ``n_tokens``-token prefix of ``profile ⊕ tokens``.

        Returns the new entry whose (caller-filled) arena row should
        receive the K/V copy; None when the content is already stored
        (recency refreshed), when every row is pinned / over budget, or —
        under second-sight admission — on the content's FIRST offer (the
        doorkeeper records it; ``force=True`` skips the doorkeeper).
        ``n_tokens`` must be item-aligned.
        """
        if n_tokens <= 0 or n_tokens % self.n_codebooks:
            raise ValueError(f"n_tokens must be a positive multiple of "
                             f"{self.n_codebooks}, got {n_tokens}")
        if chain is None:
            chain = prefix_hash_chain(profile, tokens, self.n_codebooks)
        digests = [(n, d) for n, d in chain if n <= n_tokens]
        if not digests or digests[-1][0] != n_tokens:
            raise ValueError(f"n_tokens {n_tokens} exceeds the history "
                             f"({len(tokens)} tokens)")
        key = digests[-1][1]
        covered = self._index.get(key)
        if covered is not None:
            # content already stored — either as its own entry or as a
            # boundary of a longer entry's row; refresh the owner, don't
            # burn a second arena row on duplicate K/V
            self._entries.move_to_end(covered[0])
            return None
        if not self.store_on_first_sight and not force:
            # second-sight admission: a "sight" matches on ANY shared item
            # boundary, not the full digest — a revisiting user's history
            # EXTENDS between requests, so the full-history digest is
            # fresh every visit while the visit-1 boundaries recur.  Every
            # offer records its whole boundary chain (recency-refreshed);
            # content sharing none of them (one-off traffic) never earns
            # an arena row.
            seen = any(d in self._seen for _, d in digests)
            for _, d in digests:
                self._seen[d] = None
                self._seen.move_to_end(d)
            while len(self._seen) > self._seen_cap:
                self._seen.popitem(last=False)
            if not seen:
                self.first_sights += 1
                return None
        if self.page_mode:
            if not self._admit_paged():
                return None
            row = -1   # no arena: the caller fills ``entry.pages`` instead
        else:
            row = self._take_row()
            if row is None:
                return None
        entry = PrefixEntry(key=key, row=row, n_tokens=n_tokens,
                            digests=digests)
        self._entries[key] = entry
        for n_tok, d in digests:   # the row serves ALL its item boundaries
            # setdefault: a digest shared with an older live entry keeps its
            # owner; eviction re-claims any shared digests for survivors, so
            # _index always points at live entries covering the boundary
            self._index.setdefault(d, (key, n_tok))
        self.insertions += 1
        return entry

    def _evict_entry(self, key: str, entry: PrefixEntry) -> None:
        """Drop ``entry`` from the index (it must be unpinned), returning
        its page references (page mode) to the pool via the callback."""
        del self._entries[key]
        orphaned = [d for _, d in entry.digests
                    if self._index.get(d, (None,))[0] == key]
        for d in orphaned:
            del self._index[d]
        if orphaned:
            # a surviving entry sharing a content prefix may still
            # cover the dropped boundaries — re-claim them so its
            # shorter prefixes keep hitting (bounded by
            # n_rows x boundaries, and evictions are host-rare)
            for k2, e2 in self._entries.items():
                for n_tok, d in e2.digests:
                    self._index.setdefault(d, (k2, n_tok))
        self.evictions += 1
        if self.page_mode and entry.pages:
            self._release_pages(entry.pages)
            entry.pages = []

    def _lru_unpinned(self) -> Optional[Tuple[str, PrefixEntry]]:
        for key, entry in self._entries.items():     # front = LRU
            if entry.refcount == 0:
                return key, entry
        return None                                  # everything pinned

    def _take_row(self) -> Optional[int]:
        budget_rows = min(self.n_rows, self.max_bytes // self.row_bytes)
        if len(self._entries) < budget_rows and self._free_rows:
            return self._free_rows.pop()
        victim = self._lru_unpinned()
        if victim is None:
            return None
        key, entry = victim
        row = entry.row
        self._evict_entry(key, entry)
        return row

    def _admit_paged(self) -> bool:
        """Page-mode admission: make room under the entry-count cap and
        the byte budget (evicting LRU unpinned entries); the PAGE budget
        itself is the PagePool's — admission there is zero-cost (the new
        entry only shares pages a live slot already holds)."""
        while (len(self._entries) >= self.n_rows
               or self.bytes_used > self.max_bytes):
            victim = self._lru_unpinned()
            if victim is None:
                return False
            self._evict_entry(*victim)
        return True

    def evict_for_pages(self) -> bool:
        """Reclaim: evict ONE least-recently-used unpinned entry,
        releasing its page references (page mode).  The scheduler calls
        this in a loop when an admission needs more free pages than the
        PagePool has — store capacity yields to in-flight requests.
        Returns False when nothing is evictable (all pinned or empty)."""
        victim = self._lru_unpinned()
        if victim is None:
            return False
        self._evict_entry(*victim)
        return True
