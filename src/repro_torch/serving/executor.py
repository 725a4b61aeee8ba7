"""Phase executor: the device programs behind the serving engine, for two
KV layouts, as in ``repro/serving/executor.py``.

The PAGED layout (FP8 KV pool, one refcounted page heap for slots and the
prefix store alike):

  * ``prefill_insert`` — ragged prefill of a join group: the profile +
    history forward for ``Bp`` new requests (right-padded to a length
    bucket) fills a throwaway per-slot cache, whose positions are then
    scattered onto the requests' granted pages.
  * ``resume_prefill`` — the suffix of each row (a chunk past its earlier
    segments, or past a prefix hit) at per-row offsets ``starts``, written
    onto the slot's pages and attending over the row's gathered view.
  * ``decode`` — one token for every slot at its own absolute index: the
    K/V write lands in the slot's page; attention reads the pool through
    kernel ``paged_decode`` and the select (top-k + log-partition) runs on
    the same logits, which ``select_scored`` then answers from the stash
    (``fused_decode``), or, unfused, through the gathered view, the select
    then a call of its own.
  * ``decode_multi`` — one TREE-decode step: C candidate branches for every
    slot, branch b's token written in the slot's reserved span at
    ``starts + b * branch_stride`` and attending over the shared prefix and
    its own span (kernel ``paged_decode`` in tree mode with the select
    folded in, the gathered view, or each contiguous row).
  * ``attach_prefix`` / ``share_prefix`` / ``release_pages`` — a prefix
    hit maps the stored pages read-only into the slot's table and copies
    at most one boundary page (copy-on-write); a store admit adds
    references to the donor slot's pages; an eviction drops them.
  * ``free_slots`` — drop retired slots' page references and clear the pos
    lane of pages whose refcount hit zero.

The host owns every page table (``_table_mat``) and resolves every write
to a flat pool position, exactly as the JAX executor does; a write the JAX
program drops (out-of-range index) is simply not passed.

The CONTIGUOUS layout (``paged=False``): one per-slot row of
``context_len + 1`` positions per slot (plus ``(n_candidates - 1) *
branch_stride`` for the branch spans of tree decode), plus an ARENA of
``prefix_rows`` rows of the same layout behind the prefix store.  ``prefill_insert``
copies the group's whole filled rows into ``pool[:, slots]``;
``resume_prefill`` runs on copies of the group's rows and copies the real
ones back; ``prefix_copy_insert`` / ``prefix_save`` copy rows between the
arena and the pool; ``decode`` writes each active row's token at its own
index (inactive rows, index 0, are not written) and attends over the rows
through kernel ``batch_attention`` (``use_attention_kernel``) or the plain
masked softmax, with no select stash; ``free_slots`` clears the freed
rows' pos lane in one batched write.  Every copy moves fp8 payloads as
bytes, so a stored prefix round-trips bit-identically.

Every select (``select_scored``, and ``select``, fixed mode's top-k with no
log-partition) runs kernel ``radix_topk`` under ``use_radix_topk``, the
fused stash of the paged layout included; else a stable sort (ties to the
lowest id, as ``lax.top_k``).  Each phase ends in
``torch.cuda.synchronize()`` on the card (the JAX ``block_until_ready``),
so the scheduler's phase timings stay honest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.analysis.guards import sanctioned
from repro_torch.configs.base import OneRecConfig
from repro_torch.core.policy import (BASELINE_POLICY, PAPER_POLICY,
                                     QuantPolicy)
from repro_torch.core.ptq import apply_static_act_scales, quantize_params
from repro_torch.device import synchronize
from repro_torch.kernels.radix_topk.ops import radix_topk
from repro_torch.layers.attention import KVWrite
from repro_torch.models import onerec as onerec_model
from repro_torch.models import transformer as tfm_model
from repro_torch.serving.kv_cache import INDEX_DTYPE, PagePool, as_index


def bucket_length(n: int, minimum: int = 16) -> int:
    """Smallest power-of-two >= n (floored at ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _layer_leaves(cache: dict):
    """Each stack entry's leaves dict (k, v, pos, fp8 scales) of a cache."""
    for stack in cache["stacks"].values():
        yield from stack.values()


def _nbytes(cache: dict) -> int:
    return sum(t.numel() * t.element_size()
               for leaf in _layer_leaves(cache) for t in leaf.values())


# -- the host's resolution of reads and writes (numpy in, numpy out) --------
# The executor stages what these return (``_index``); ``serving.
# cached_modes`` resolves its steps with them too.


def page_gather(tables: np.ndarray, page_size: int) -> np.ndarray:
    """(N, P * page_size) flat pool position of each row's logically dense
    view, for rows whose page tables are ``tables`` (N, P)."""
    flat = (tables[:, :, None].astype(INDEX_DTYPE) * page_size
            + np.arange(page_size, dtype=INDEX_DTYPE)[None, None, :])
    return flat.reshape(len(tables), -1)


def page_scatter(tables: np.ndarray, logical, valid, page_size: int,
                 sentinel: int) -> np.ndarray:
    """Flat pool position of per-row ``logical`` positions (N, ...) for
    rows whose page tables are ``tables`` (N, P); entries with ``valid``
    False, on the ``sentinel`` page (unmapped) or past the table resolve
    to the drop index ``(sentinel + 1) * page_size``."""
    n, p_max = tables.shape
    lg = as_index(logical)
    pg = np.clip(lg // page_size, 0, p_max - 1)
    entry = np.take_along_axis(
        tables, pg.reshape(n, -1), axis=1).reshape(lg.shape)
    phys = entry.astype(INDEX_DTYPE) * page_size + lg % page_size
    ok = (np.asarray(valid, bool) & (entry != sentinel)
          & (lg >= 0) & (lg < p_max * page_size))
    return np.where(ok, phys, (sentinel + 1) * page_size).astype(INDEX_DTYPE)


def landing(psc: np.ndarray, drop: int) -> Tuple[np.ndarray, np.ndarray]:
    """The writes of ``page_scatter``'s ``psc`` that land: (pool position,
    source row of the flattened new K/V)."""
    flat = psc.reshape(-1)
    keep = np.nonzero(flat != drop)[0]
    return flat[keep], keep


def slot_landing(lengths: np.ndarray, s_row: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The contiguous decode writes: slot i's token lands at position
    ``lengths[i] % s_row`` of its own row (flat index ``i * s_row +
    position``); slots passed index 0 are inactive and not written (the
    JAX layer drops their write)."""
    rows = np.nonzero(lengths > 0)[0]
    return rows * s_row + lengths[rows] % s_row, rows


def suffix_landing(suffix: np.ndarray, starts: np.ndarray, s_row: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The contiguous resume writes: row i's suffix token j (``suffix``
    (B, T) True where it is real) lands at position ``starts[i] + j`` of
    its row; its source is row ``i * T + j`` of the new K/V."""
    rows_i, cols = np.nonzero(suffix)
    return (rows_i * s_row + starts[rows_i] + cols,
            rows_i * suffix.shape[1] + cols)


def scatter_rows(pool: dict, filled: dict, write: KVWrite) -> None:
    """Every leaf of a per-row cache ``filled`` ((L, B, T, ...) under each
    stack) at flat positions ``write.src`` of its (B * T) rows written onto
    the flat positions ``write.dst`` of the page heap ``pool``: a fresh
    prefill scattered onto its granted pages, in bytes."""
    for si, stack in filled["stacks"].items():
        for key, leaves in stack.items():
            heap = pool["stacks"][si][key]
            for name, f in leaves.items():
                rows = _u8(f).reshape(f.shape[0], -1, *f.shape[3:])
                _u8(heap[name])[:, write.dst] = rows[:, write.src]


def _rows(cache: dict, idx: torch.Tensor) -> dict:
    """Copies of rows ``idx`` (axis 1, under the layer axis) of a per-slot
    cache."""
    return tree.map_with_path(
        lambda _, t: _u8(t)[:, idx].view(t.dtype), cache)


class PhaseExecutor:
    """Owns the quantized params, the device KV pool (paged or contiguous),
    and the prefill / decode / select phases."""

    def __init__(self, params, cfg: OneRecConfig, *, n_slots: int,
                 device: torch.device, use_fp8: bool = True, topk: int = 8,
                 use_radix_topk: bool = False,
                 prefill_bucket_min: int = 16,
                 kv_dtype: Optional[str] = None, paged: bool = True,
                 page_size: int = 32, n_pages: int = 0,
                 fused_decode: bool = True, prefix_rows: int = 0,
                 n_candidates: int = 1,
                 quant_policy: Optional[QuantPolicy] = None,
                 act_scales: Optional[Dict[str, float]] = None):
        if n_candidates < 1:
            raise ValueError(f"n_candidates must be >= 1, got {n_candidates}")
        if n_candidates > topk:
            raise ValueError(
                f"n_candidates ({n_candidates}) exceeds topk ({topk}): "
                f"branch seeds come from the top-k select")
        self.cfg = cfg
        self.n_slots = n_slots
        self.device = device
        self.topk = topk
        self.use_radix_topk = use_radix_topk
        self.prefill_bucket_min = prefill_bucket_min
        self.kv_dtype = getattr(torch,
                                kv_dtype or cfg.transformer.kv_cache_dtype)
        # tree decode: branch b's own tokens occupy a reserved span of
        # branch_stride = decode_len - 1 positions past the shared prefix,
        # so C branches need (C - 1) * stride positions beyond a
        # single-candidate row
        self.n_candidates = n_candidates
        self.branch_stride = max(cfg.decode_len - 1, 0)
        extra = (n_candidates - 1) * self.branch_stride
        self._extra = extra
        params = tree.map_with_path(lambda _, t: t.to(device), params)
        # a tuned QuantPolicy (e.g. from a policy artifact) overrides the
        # all-or-nothing use_fp8 switch; calibrated static activation
        # scales ride the quantized leaves (fp8_linear skips the per-token
        # amax reduction where they are attached)
        self.quant_policy = quant_policy if quant_policy is not None else \
            (PAPER_POLICY if use_fp8 else BASELINE_POLICY)
        self.params = quantize_params(params, self.quant_policy)
        if act_scales:
            self.params = apply_static_act_scales(self.params, act_scales)
        # positions per request: profile + history + the first decode
        # token, plus every reserved branch span
        self.s_row = cfg.context_len + 1 + extra
        self.paged = bool(paged)
        # paged decode through kernel paged_decode with the select folded
        # in, else through the gathered view
        self.fused_decode = self.paged and bool(fused_decode)
        self.prefix_rows = prefix_rows
        self.arena = None
        if self.paged:
            self._init_pages(page_size, n_pages)
        else:
            self.page_pool = None
            self.cache = onerec_model.init_slot_cache(
                cfg, n_slots, dtype=self.kv_dtype, extra_len=extra,
                device=device)
            if prefix_rows > 0:   # tier 2: the prefix store's rows
                self.arena = onerec_model.init_slot_cache(
                    cfg, prefix_rows, dtype=self.kv_dtype, extra_len=extra,
                    device=device)
        self._fused_select: Optional[tuple] = None
        self.counters: Dict[str, int] = {"prefill_calls": 0,
                                         "resume_calls": 0,
                                         "decode_steps": 0,
                                         "decode_multi_steps": 0,
                                         "branch_tokens": 0,
                                         "fused_decode_steps": 0,
                                         "fused_select_hits": 0,
                                         "select_calls": 0,
                                         "prefill_padded_rows": 0,
                                         "prefill_tokens_batched": 0,
                                         "prefill_tokens_real": 0,
                                         "prefix_row_copies": 0,
                                         "cow_copies": 0,
                                         "pages_granted": 0}

    def _init_pages(self, page_size: int, n_pages: int) -> None:
        self._p_max = -(-self.s_row // page_size)  # table entries per slot
        if n_pages < self._p_max:
            raise ValueError(
                f"n_pages ({n_pages}) below one request's footprint "
                f"({self._p_max} pages of {page_size} positions)")
        self.page_size = page_size
        self.n_pages = n_pages
        self._sentinel = n_pages                   # virgin page, pos = -1
        self._drop = (n_pages + 1) * page_size     # the JAX drop index
        self.page_pool = PagePool(n_pages, page_size)
        # slot -> page per logical page index; unmapped entries point at
        # the sentinel page, so an empty slot reads an all-masked row
        self._table_mat = np.full((self.n_slots, self._p_max),
                                  self._sentinel, np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        self.cache = onerec_model.init_page_pool(
            self.cfg, n_pages, page_size, dtype=self.kv_dtype,
            device=self.device)

    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        """Stage a host array on the device: an explicit copy, which the
        steady-state guard allows (``analysis.guards.sanctioned``)."""
        with sanctioned():
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=self.device, dtype=dtype)

    def _index(self, a: np.ndarray) -> torch.Tensor:
        """Stage host index math (``INDEX_DTYPE``, ``kv_cache.as_index``)
        as a device gather / scatter operand: int64, the index dtype of
        PyTorch's indexing ops.  The one place the host's int32 index
        math widens."""
        return self._tensor(a, torch.int64)

    def _topk(self, flat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Top-k of the last axis of (N, V) logits: kernel ``radix_topk``
        under ``use_radix_topk``, else a stable sort (ties to the lowest
        id, as ``lax.top_k``)."""
        if self.use_radix_topk:
            return radix_topk(flat, self.topk)
        return onerec_model.stable_top_k(flat, self.topk)

    def _select(self, logits: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k and the log-partition of the last axis of the logits,
        flattened to rows, copied to the host."""
        flat = logits.reshape(-1, logits.shape[-1])
        vals, ids = self._topk(flat)
        lse = torch.logsumexp(flat.to(torch.float32), dim=-1)
        with sanctioned():                  # the select's readback
            return (vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy(),
                    lse.cpu().numpy())

    # -- host-side padding and page tables ----------------------------------

    def _pad_group(self, tokens_list: List[np.ndarray]
                   ) -> Tuple[np.ndarray, np.ndarray, List[int]]:
        """Right-pad the group to a length bucket and the batch to a power
        of two by DUPLICATING the last request.  Returns (tokens (b, t),
        lengths (b,), source row per padded row)."""
        n = len(tokens_list)
        lens = [len(t) for t in tokens_list]
        t_bucket = bucket_length(max(lens), self.prefill_bucket_min)
        t_bucket = min(t_bucket, self.cfg.history_len * self.cfg.n_codebooks)
        b_bucket = bucket_length(n, 1)
        tok = np.zeros((b_bucket, t_bucket), np.int32)
        lengths = np.zeros((b_bucket,), np.int32)
        src = [min(i, n - 1) for i in range(b_bucket)]
        for i, j in enumerate(src):
            tok[i, :lens[j]] = tokens_list[j]
            lengths[i] = lens[j]
        self.counters["prefill_calls"] += 1
        self.counters["prefill_padded_rows"] += b_bucket - n
        self.counters["prefill_tokens_batched"] += b_bucket * t_bucket
        self.counters["prefill_tokens_real"] += sum(lens)
        return tok, lengths, src

    def _gather_indices(self, slot_ids) -> np.ndarray:
        """(N, Sp) flat pool position of each row's logically dense view
        (Sp = table entries x page size).  Unmapped entries point inside
        the sentinel page (pos -1), so an empty slot gathers an all-masked
        view."""
        return page_gather(self._table_mat[as_index(slot_ids)],
                           self.page_size)

    def _scatter_indices(self, slot_ids, logical, valid) -> np.ndarray:
        """Flat physical index of per-row ``logical`` positions; entries
        with ``valid`` False, or on an unmapped page, resolve to the drop
        index (``(n_pages + 1) * page_size``)."""
        return page_scatter(self._table_mat[as_index(slot_ids)], logical,
                            valid, self.page_size, self._sentinel)

    def _page_write(self, psc: np.ndarray) -> KVWrite:
        """The writes of ``psc`` that land (``landing``), staged."""
        return KVWrite(*map(self._index, landing(psc, self._drop)))

    def _slot_write(self, lengths: np.ndarray) -> KVWrite:
        """The contiguous decode writes (``slot_landing``), staged."""
        return KVWrite(*map(self._index, slot_landing(lengths, self.s_row)))

    def grant_slot(self, slot: int, n_positions: int) -> bool:
        """Allocate the pages covering ``n_positions`` logical positions for
        ``slot``; all-or-nothing (False leaves the pool untouched)."""
        need = self.page_pool.pages_for(n_positions)
        pages = self.page_pool.alloc(need)
        if pages is None:
            return False
        self._table_mat[slot] = self._sentinel
        self._table_mat[slot, :need] = pages
        self._slot_pages[slot] = list(pages)
        self.counters["pages_granted"] += need
        return True

    def attach_prefix(self, slot: int, entry_pages: List[int],
                      boundary: int, n_positions: int) -> bool:
        """Prefix-hit admission: map a stored prefix's full pages into
        ``slot`` read-only (refcount bump, no device copy), copy the one
        partially-matched boundary page when ``boundary`` (matched
        positions, profile included) is not page-aligned, and allocate
        fresh pages for the rest of the ``n_positions`` footprint."""
        ps = self.page_size
        full = boundary // ps
        need = self.page_pool.pages_for(n_positions) - full
        if need > self.page_pool.n_free:
            return False
        fresh = self.page_pool.alloc(need) or []
        table = self.page_pool.share(entry_pages[:full]) + fresh
        self._table_mat[slot] = self._sentinel
        self._table_mat[slot, :len(table)] = table
        self._slot_pages[slot] = table
        self.counters["pages_granted"] += need
        keep = boundary % ps
        if keep:
            # positions [full * ps, boundary) of the donor's boundary page;
            # the rest of the fresh page stays virgin (pos -1), the paged
            # form of prefix_copy_insert's length mask
            off = np.arange(keep, dtype=np.int64)
            src = self._index(entry_pages[full] * ps + off)
            dst = self._index(fresh[0] * ps + off)
            for leaf in self._pool_leaves():
                for t in leaf.values():
                    _u8(t)[:, dst] = _u8(t)[:, src]
            self.counters["cow_copies"] += 1
        return True

    def share_prefix(self, slot: int, n_positions: int) -> List[int]:
        """Store admit in the paged layout: one more reference on the
        slot's pages covering ``n_positions``, returned as the entry's
        pages.  The donor only appends past them, so they stay as
        stored."""
        need = self.page_pool.pages_for(n_positions)
        owned = self._slot_pages.get(slot, [])
        assert need <= len(owned), \
            f"slot {slot} holds {len(owned)} pages, prefix needs {need}"
        return self.page_pool.share(owned[:need])

    def release_pages(self, pages: List[int]) -> None:
        """Drop one reference per page (store eviction); pages whose
        refcount hits zero get their pos lane cleared."""
        self._free_pages_device(self.page_pool.release(pages))

    def _pool_leaves(self):
        return _layer_leaves(self.cache)

    def _free_pages_device(self, pages: List[int]) -> None:
        """Clear the pos lane of freed pages so re-granted pages read
        virgin."""
        if not pages:
            return
        flat = (np.asarray(pages, np.int64)[:, None] * self.page_size
                + np.arange(self.page_size)[None, :]).reshape(-1)
        idx = self._index(flat)
        for leaf in self._pool_leaves():
            leaf["pos"].index_fill_(1, idx, -1)

    # -- phases ---------------------------------------------------------------

    def prefill_insert(self, tokens_list: List[np.ndarray],
                       profiles: List[np.ndarray], slots: List[int]
                       ) -> torch.Tensor:
        """Prefill one join group into its slots: onto their granted pages,
        or into their rows of the contiguous pool.  Returns FULL-BUCKET
        next-token logits (b_bucket, V); callers use the first
        ``len(slots)`` rows."""
        tok, lengths, src = self._pad_group(tokens_list)
        prof = np.stack([profiles[j] for j in src]).astype(np.float32)
        batch = {"tokens": self._tensor(tok),
                 "profile": self._tensor(prof, torch.float32)}
        if not self.paged:
            # whole filled rows into pool[:, slots]; the batch-padding
            # duplicates of the last request are not copied: under MoE
            # capacity drops their K/V differ from the real row's
            fresh = onerec_model.init_slot_cache(
                self.cfg, tok.shape[0], dtype=self.kv_dtype,
                extra_len=self._extra, device=self.device)
            logits, filled = onerec_model.prefill_into_slots(
                self.params, batch, self.cfg, fresh, self._tensor(lengths))
            n = len(slots)
            idx = self._index(np.asarray(slots))
            for pool, rows in zip(self._pool_leaves(), _layer_leaves(filled)):
                for name, f in rows.items():
                    _u8(pool[name])[:, idx] = _u8(f)[:, :n]
            synchronize(self.device)
            return logits
        slot_ids = np.asarray([slots[j] for j in src], np.int32)
        b, t_eff = tok.shape[0], tok.shape[1] + 1
        logical = np.broadcast_to(np.arange(t_eff, dtype=INDEX_DTYPE)[None],
                                  (b, t_eff))
        # only the real rows are written: the batch-padding duplicates of
        # the last request (rows >= len(slots)) would land on its pages too,
        # with K/V that differ from the real row's under MoE capacity drops
        # (the JAX executor writes them as well; a duplicate scatter has no
        # defined winner on the card)
        real = np.arange(b)[:, None] < len(slots)
        valid = (logical < (as_index(lengths)[:, None] + 1)) & real
        write = self._page_write(
            self._scatter_indices(slot_ids, logical, valid))
        fresh = tfm_model.init_kv_cache(self.cfg.transformer, b, t_eff,
                                        dtype=self.kv_dtype,
                                        device=self.device)
        logits, filled = onerec_model.prefill_into_slots(
            self.params, batch, self.cfg, fresh, self._tensor(lengths))
        # scatter every leaf's valid positions onto the granted pages
        scatter_rows(self.cache, filled, write)
        synchronize(self.device)
        return logits

    def resume_prefill(self, tokens_list: List[np.ndarray],
                       slots: List[int], starts: List[int]) -> torch.Tensor:
        """Prefill only each row's uncached SUFFIX: ``tokens_list[i]`` at
        absolute positions from ``starts[i]`` (the positions the slot
        already holds, profile included).  Same bucketing and padding as
        ``prefill_insert``; returns full-bucket next-token logits."""
        tok, lengths, src = self._pad_group(tokens_list)
        start_arr = np.asarray([starts[j] for j in src], np.int32)
        slot_ids = np.asarray([slots[j] for j in src], np.int32)
        b, t = tok.shape
        n = len(slots)
        j = np.arange(t, dtype=INDEX_DTYPE)[None, :]
        suffix = j < as_index(lengths)[:, None]
        batch = {"tokens": self._tensor(tok)}
        starts_t = self._tensor(start_arr)
        if self.paged:
            # only the real rows are written, as in prefill_insert
            real = np.arange(b)[:, None] < n
            psc = self._scatter_indices(
                slot_ids, as_index(start_arr)[:, None] + j, suffix & real)
            logits, self.cache = onerec_model.prefill_into_slots(
                self.params, batch, self.cfg, self.cache,
                self._tensor(lengths), starts=starts_t,
                kv_write=self._page_write(psc),
                page_gather=self._index(self._gather_indices(slot_ids)))
        else:
            # the group's rows run on copies, the batch-padding duplicates
            # on rows of their own, and only the real rows are copied back
            idx = self._index(slot_ids)
            write = KVWrite(*map(self._index, suffix_landing(
                suffix, start_arr, self.s_row)))
            logits, filled = onerec_model.prefill_into_slots(
                self.params, batch, self.cfg, _rows(self.cache, idx),
                self._tensor(lengths), starts=starts_t, kv_write=write)
            for pool, rows in zip(self._pool_leaves(), _layer_leaves(filled)):
                for name, f in rows.items():
                    _u8(pool[name])[:, idx[:n]] = _u8(f)[:, :n]
        self.counters["resume_calls"] += 1
        synchronize(self.device)
        return logits

    def decode(self, tokens: np.ndarray, lengths: np.ndarray
               ) -> torch.Tensor:
        """One decode step over the whole pool: tokens (N, 1) at per-slot
        indices ``lengths`` (N,).  Inactive slots (free, or mid-way through
        a chunked prefill) pass index 0; their writes are not made.  The
        fused paged decode runs the select on the same logits and stashes
        it for ``select_scored``."""
        li = as_index(lengths)
        if not self.paged:
            logits, self.cache = onerec_model.decode_step_slots(
                self.params, self._tensor(tokens), self.cfg, self.cache,
                self._tensor(li), kv_write=self._slot_write(li))
            self.counters["decode_steps"] += 1
            synchronize(self.device)
            return logits
        rows = np.arange(self.n_slots)
        write = self._page_write(self._scatter_indices(rows, li, li > 0))
        if self.fused_decode:
            read = dict(page_tables=self._tensor(self._table_mat),
                        page_size=self.page_size)
        else:
            read = dict(page_gather=self._index(self._gather_indices(rows)))
        logits, self.cache = onerec_model.decode_step_slots(
            self.params, self._tensor(tokens), self.cfg, self.cache,
            self._tensor(li), kv_write=write, **read)
        if self.fused_decode:
            self._fused_select = (logits, *self._select(logits))
            self.counters["fused_decode_steps"] += 1
        self.counters["decode_steps"] += 1
        synchronize(self.device)
        return logits

    def decode_multi(self, tokens: np.ndarray, lengths: np.ndarray,
                     starts: np.ndarray, counts: np.ndarray
                     ) -> torch.Tensor:
        """One TREE-decode step over the whole pool: tokens (N, C) carry C
        candidate branches per slot, all at that slot's depth ``lengths``;
        ``starts`` is each slot's branch base (its prefix occupancy) and
        ``counts`` its REAL branch width.  Branch b of slot i writes
        logical position ``starts[i] + b * branch_stride + (lengths[i] -
        starts[i])``; inactive slots (index 0) and dummy branches (b >=
        counts[i]) are not written, so unused spans stay empty.  Returns
        per-branch logits (N, C, V); the fused paged decode stashes the
        select of all N * C rows for ``select_scored``."""
        c = tokens.shape[1]
        if c > self.n_candidates:
            raise ValueError(f"{c} branches exceed the executor's "
                             f"n_candidates capacity ({self.n_candidates})")
        li = as_index(lengths)[:, None]
        st = as_index(starts)[:, None]
        b = np.arange(c, dtype=INDEX_DTYPE)[None, :]
        logical = st + b * self.branch_stride + (li - st)
        valid = (li > 0) & (b < as_index(counts)[:, None])
        rows = np.arange(self.n_slots)
        read = {}
        if self.paged:
            write = self._page_write(
                self._scatter_indices(rows, logical, valid))
            if self.fused_decode:
                read = dict(page_tables=self._tensor(self._table_mat),
                            page_size=self.page_size)
            else:
                read = dict(page_gather=self._index(
                    self._gather_indices(rows)))
        else:
            # slot i's branch b lands at flat i * s_row + logical; past the
            # row the JAX scatter drops it
            r_i, b_i = np.nonzero(valid & (logical < self.s_row))
            write = KVWrite(
                self._index(r_i * self.s_row + logical[r_i, b_i]),
                self._index(r_i * c + b_i))
        logits, self.cache = onerec_model.decode_step_slots(
            self.params, self._tensor(tokens), self.cfg, self.cache,
            self._tensor(as_index(lengths)), kv_write=write,
            starts=self._tensor(as_index(starts)),
            branch_stride=self.branch_stride, **read)
        if self.fused_decode:
            self._fused_select = (logits, *self._select(logits))
            self.counters["fused_decode_steps"] += 1
        self.counters["decode_steps"] += 1
        self.counters["decode_multi_steps"] += 1
        self.counters["branch_tokens"] += int(np.sum(counts))
        synchronize(self.device)
        return logits

    def select(self, logits: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Host (top-k vals, ids) of (N, V) logits (fixed mode's select)."""
        self.counters["select_calls"] += 1
        vals, ids = self._topk(logits.reshape(-1, logits.shape[-1]))
        with sanctioned():                  # the select's readback
            return vals.cpu().numpy(), ids.to(torch.int32).cpu().numpy()

    def select_scored(self, logits: torch.Tensor
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (top-k vals, ids, logsumexp) of (N, V) or (N, C, V)
        logits, the leading axes kept; answered from the stash when
        ``logits`` came out of a fused ``decode`` or ``decode_multi``."""
        lead = tuple(logits.shape[:-1])
        if self._fused_select is not None \
                and logits is self._fused_select[0]:
            _, vals, ids, lse = self._fused_select
            self._fused_select = None
            self.counters["fused_select_hits"] += 1
        else:
            self.counters["select_calls"] += 1
            vals, ids, lse = self._select(logits)
        return (vals.reshape(lead + (self.topk,)),
                ids.reshape(lead + (self.topk,)), lse.reshape(lead))

    @staticmethod
    def _pad_ids(ids: List[int]) -> np.ndarray:
        """Bucket an id list to a power-of-two length by duplicating the
        last id (the JAX executor's shape bucketing)."""
        b = bucket_length(len(ids), 1)
        return np.asarray(ids + [ids[-1]] * (b - len(ids)), np.int64)

    def prefix_copy_insert(self, arena_rows: List[int], slots: List[int],
                           lengths: List[int]) -> None:
        """Copy stored arena rows into pool slots; stored positions at or
        past each prefix's occupancy ``lengths[i]`` (profile + history) are
        masked empty."""
        rows = self._index(np.asarray(arena_rows))
        idx = self._index(np.asarray(slots))
        ln = self._tensor(np.asarray(lengths))
        for pool, arena in zip(self._pool_leaves(),
                               _layer_leaves(self.arena)):
            for name, t in arena.items():
                if name != "pos":
                    _u8(pool[name])[:, idx] = _u8(t)[:, rows]
            picked = arena["pos"][:, rows]
            keep = (picked >= 0) & (picked < ln[None, :, None])
            pool["pos"][:, idx] = torch.where(keep, picked, -1)
        self.counters["prefix_row_copies"] += len(slots)

    def prefix_save(self, slots: List[int], arena_rows: List[int]) -> None:
        """Copy prefilled pool rows into arena rows (store admit) whole:
        the restore masks each row down to its entry's length."""
        idx = self._index(np.asarray(slots))
        rows = self._index(np.asarray(arena_rows))
        for arena, pool in zip(_layer_leaves(self.arena),
                               self._pool_leaves()):
            for name, t in pool.items():
                _u8(arena[name])[:, rows] = _u8(t)[:, idx]

    def free_slots(self, slots: List[int]) -> None:
        """Retire slots so they read virgin: in the paged layout drop their
        page references and clear the pos lane of pages whose refcount hits
        zero; in the contiguous layout clear their rows' pos lane."""
        if not self.paged:
            if not slots:
                return
            idx = self._index(self._pad_ids([int(s) for s in slots]))
            for leaf in self._pool_leaves():
                leaf["pos"].index_fill_(1, idx, -1)
            return
        freed: List[int] = []
        for s in dict.fromkeys(int(s) for s in slots):
            pages = self._slot_pages.pop(s, None)
            self._table_mat[s] = self._sentinel
            if pages:
                freed += self.page_pool.release(pages)
        self._free_pages_device(freed)

    # -- accounting ------------------------------------------------------------

    @property
    def kv_bytes(self) -> int:
        """Device bytes of both KV tiers (payload, pos lane, fp8 scales):
        the pool and, in the contiguous layout, the prefix arena."""
        return _nbytes(self.cache) + (
            _nbytes(self.arena) if self.arena is not None else 0)

    @property
    def page_bytes(self) -> int:
        """Device bytes one page occupies across every layer leaf."""
        assert self.paged, "page_bytes requires the paged layout"
        return _nbytes(self.cache) // (self.n_pages + 1)

    @property
    def arena_row_bytes(self) -> int:
        """Device bytes one stored prefix row occupies (the store's price
        per row); in the paged layout a stored prefix is page references,
        priced per page."""
        if self.paged:
            return self.page_bytes
        if self.arena is None:
            return 0
        return _nbytes(self.arena) // self.prefix_rows

    @property
    def pool_row_bytes(self) -> int:
        """Bytes of one slot: its row of the contiguous pool, or the
        worst case of a paged slot (a full page table)."""
        if not self.paged:
            return _nbytes(self.cache) // self.n_slots
        return self._p_max * self.page_bytes
