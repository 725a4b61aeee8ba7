"""Phase executor: the device programs behind the serving engine, for the
paged FP8 KV layout with fused decode.

  * ``prefill_insert`` — ragged prefill of a join group: the profile +
    history forward for ``Bp`` new requests (right-padded to a length
    bucket) fills a throwaway per-slot cache, whose positions are then
    scattered onto the requests' granted pages.
  * ``decode`` — one token for every slot at its own absolute index: the
    K/V write lands in the slot's page, attention reads the pool through
    kernel ``paged_decode``, and the select (stable top-k + log-partition)
    runs on the same logits; ``select_scored`` then answers from the stash.
  * ``free_slots`` — drop retired slots' page references and clear the pos
    lane of pages whose refcount hit zero.

The host owns every page table (``_table_mat``) and resolves every write
to a flat pool position, exactly as ``repro/serving/executor.py`` does; a
write the JAX program drops (out-of-range index) is simply not passed.
Each phase ends in ``torch.cuda.synchronize()`` on the card (the JAX
``block_until_ready``), so the scheduler's phase timings stay honest.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs.base import OneRecConfig
from repro_torch.core.policy import BASELINE_POLICY, PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.device import synchronize
from repro_torch.layers.attention import PageWrite
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


class PhaseExecutor:
    """Owns the quantized params, the device page pool, and the prefill /
    decode / select phases."""

    def __init__(self, params, cfg: OneRecConfig, *, n_slots: int,
                 device: torch.device, use_fp8: bool = True, topk: int = 8,
                 prefill_bucket_min: int = 16,
                 kv_dtype: Optional[str] = None, page_size: int = 32,
                 n_pages: int = 0):
        self.cfg = cfg
        self.n_slots = n_slots
        self.device = device
        self.topk = topk
        self.prefill_bucket_min = prefill_bucket_min
        self.kv_dtype = getattr(torch,
                                kv_dtype or cfg.transformer.kv_cache_dtype)
        # a K=1 request reserves one branch span of decode_len - 1
        # positions past its history (the scheduler's footprint)
        self.branch_stride = max(cfg.decode_len - 1, 0)
        params = tree.map_with_path(lambda _, t: t.to(device), params)
        self.params = quantize_params(
            params, PAPER_POLICY if use_fp8 else BASELINE_POLICY)
        s_row = cfg.context_len + 1
        self._p_max = -(-s_row // page_size)       # table entries per slot
        if n_pages < self._p_max:
            raise ValueError(
                f"n_pages ({n_pages}) below one request's footprint "
                f"({self._p_max} pages of {page_size} positions)")
        self.page_size = page_size
        self.n_pages = n_pages
        self._sentinel = n_pages                   # virgin page, pos = -1
        self._drop = (n_pages + 1) * page_size     # the JAX drop index
        self._sp = self._p_max * page_size
        self.page_pool = PagePool(n_pages, page_size)
        # slot -> page per logical page index; unmapped entries point at
        # the sentinel page, so an empty slot reads an all-masked row
        self._table_mat = np.full((n_slots, self._p_max), self._sentinel,
                                  np.int32)
        self._slot_pages: Dict[int, List[int]] = {}
        self.cache = onerec_model.init_page_pool(
            cfg, n_pages, page_size, dtype=self.kv_dtype, device=device)
        self._fused_select: Optional[tuple] = None
        self.counters: Dict[str, int] = {"prefill_calls": 0,
                                         "decode_steps": 0,
                                         "branch_tokens": 0,
                                         "fused_decode_steps": 0,
                                         "fused_select_hits": 0,
                                         "select_calls": 0,
                                         "prefill_padded_rows": 0,
                                         "prefill_tokens_batched": 0,
                                         "prefill_tokens_real": 0,
                                         "pages_granted": 0}

    def _tensor(self, a: np.ndarray, dtype=torch.int32) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=self.device, dtype=dtype)

    def _select(self, logits: torch.Tensor
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Top-k (stable: ties to the lowest id, as ``lax.top_k``) and the
        log-partition of the last axis, copied to the host."""
        flat = logits.reshape(-1, logits.shape[-1])
        vals, ids = torch.sort(flat, dim=-1, descending=True, stable=True)
        lse = torch.logsumexp(flat.to(torch.float32), dim=-1)
        return (vals[:, :self.topk].cpu().numpy(),
                ids[:, :self.topk].to(torch.int32).cpu().numpy(),
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

    def _scatter_indices(self, slot_ids, logical, valid) -> np.ndarray:
        """Flat physical index of per-row ``logical`` positions; entries
        with ``valid`` False, or on an unmapped page, resolve to the drop
        index (``(n_pages + 1) * page_size``)."""
        n = len(slot_ids)
        tabs = self._table_mat[as_index(slot_ids)]
        lg = as_index(logical)
        pg = np.clip(lg // self.page_size, 0, self._p_max - 1)
        entry = np.take_along_axis(
            tabs, pg.reshape(n, -1), axis=1).reshape(lg.shape)
        phys = entry.astype(INDEX_DTYPE) * self.page_size \
            + lg % self.page_size
        ok = (np.asarray(valid, bool) & (entry != self._sentinel)
              & (lg >= 0) & (lg < self._sp))
        return np.where(ok, phys, self._drop).astype(INDEX_DTYPE)

    def _page_write(self, psc: np.ndarray) -> PageWrite:
        """The writes of ``psc`` that land: (pool position, source row of
        the flattened new K/V)."""
        flat = psc.reshape(-1)
        keep = np.nonzero(flat != self._drop)[0]
        return PageWrite(self._tensor(flat[keep], torch.int64),
                         self._tensor(keep, torch.int64))

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

    def _pool_leaves(self):
        for stack in self.cache["stacks"].values():
            yield from stack.values()

    def _free_pages_device(self, pages: List[int]) -> None:
        """Clear the pos lane of freed pages so re-granted pages read
        virgin."""
        if not pages:
            return
        flat = (np.asarray(pages, np.int64)[:, None] * self.page_size
                + np.arange(self.page_size)[None, :]).reshape(-1)
        idx = self._tensor(flat, torch.int64)
        for leaf in self._pool_leaves():
            leaf["pos"][:, idx] = -1

    # -- phases ---------------------------------------------------------------

    def prefill_insert(self, tokens_list: List[np.ndarray],
                       profiles: List[np.ndarray], slots: List[int]
                       ) -> torch.Tensor:
        """Prefill one join group onto its slots' granted pages.  Returns
        FULL-BUCKET next-token logits (b_bucket, V); callers use the first
        ``len(slots)`` rows."""
        tok, lengths, src = self._pad_group(tokens_list)
        prof = np.stack([profiles[j] for j in src]).astype(np.float32)
        slot_ids = np.asarray([slots[j] for j in src], np.int32)
        b, t_eff = tok.shape[0], tok.shape[1] + 1
        logical = np.broadcast_to(np.arange(t_eff, dtype=INDEX_DTYPE)[None],
                                  (b, t_eff))
        valid = logical < (as_index(lengths)[:, None] + 1)
        write = self._page_write(
            self._scatter_indices(slot_ids, logical, valid))
        fresh = tfm_model.init_kv_cache(self.cfg.transformer, b, t_eff,
                                        dtype=self.kv_dtype,
                                        device=self.device)
        logits, filled = onerec_model.prefill_into_slots(
            self.params, {"tokens": self._tensor(tok),
                          "profile": self._tensor(prof, torch.float32)},
            self.cfg, fresh, self._tensor(lengths))
        # scatter every leaf's valid positions onto the granted pages
        for si, stack in filled["stacks"].items():
            for key, leaves in stack.items():
                pool = self.cache["stacks"][si][key]
                for name, f in leaves.items():
                    rows = _u8(f).reshape(f.shape[0], b * t_eff,
                                          *f.shape[3:])
                    _u8(pool[name])[:, write.dst] = rows[:, write.src]
        synchronize(self.device)
        return logits

    def decode(self, tokens: np.ndarray, lengths: np.ndarray
               ) -> torch.Tensor:
        """One fused decode step over the whole pool: tokens (N, 1) at
        per-slot indices ``lengths`` (N,).  Inactive slots pass index 0;
        their writes are not made.  The select runs on the same logits and
        is stashed for ``select_scored``."""
        li = as_index(lengths)
        write = self._page_write(
            self._scatter_indices(np.arange(self.n_slots), li, li > 0))
        logits, self.cache = onerec_model.decode_step_slots(
            self.params, self._tensor(tokens), self.cfg, self.cache,
            self._tensor(li), page_write=write,
            page_tables=self._tensor(self._table_mat),
            page_size=self.page_size)
        self._fused_select = (logits, *self._select(logits))
        self.counters["fused_decode_steps"] += 1
        self.counters["decode_steps"] += 1
        synchronize(self.device)
        return logits

    def select_scored(self, logits: torch.Tensor
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host (top-k vals, ids, logsumexp) of (N, V) logits; answered
        from the stash when ``logits`` came out of ``decode``."""
        if self._fused_select is not None \
                and logits is self._fused_select[0]:
            _, vals, ids, lse = self._fused_select
            self._fused_select = None
            self.counters["fused_select_hits"] += 1
            return vals, ids, lse
        self.counters["select_calls"] += 1
        return self._select(logits)

    def free_slots(self, slots: List[int]) -> None:
        """Drop retired slots' page references; pages whose refcount hits
        zero get their device pos lane cleared."""
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
        """Device bytes of the whole pool (payload, pos lane, fp8 scales)."""
        return sum(t.numel() * t.element_size()
                   for leaf in self._pool_leaves() for t in leaf.values())

    @property
    def page_bytes(self) -> int:
        """Device bytes one page occupies across every layer leaf."""
        return self.kv_bytes // (self.n_pages + 1)

    @property
    def pool_row_bytes(self) -> int:
        """Worst-case bytes of one slot (a full page table)."""
        return self._p_max * self.page_bytes
