"""OneRec serving engine on the card: the open-system request lifecycle of
``repro/serving/engine.py`` over the paged FP8 KV pool (``paged=True``, the
default; decode through kernel ``paged_decode`` with ``fused_decode="auto"``
or through the gathered view with ``"off"``) or the contiguous slot pool
(``paged=False, fused_decode="off"``), with the continuous scheduler
(``mode="continuous"``; ``max_candidates > 1`` lets a request ask for a
ranked set of ``n_candidates`` items, decoded as a tree) or the fixed-batch
reference (``mode="fixed"``, contiguous only).

  * ``submit(request) -> RequestHandle`` — non-blocking admission into a
    bounded queue; a full queue (``max_queue``) raises ``AdmissionFull``;
  * ``step()`` — one scheduler round (chunked prefills -> join -> decode),
    completions delivered to their handles;
  * ``handle.poll()`` / ``result()`` / ``cancel()`` / ``status``;
  * ``drain()`` — step until every accepted request retired, releasing
    hold windows at the tail;
  * ``serve_requests`` / ``generate_batch`` — the closed-batch shims, and
    ``run_open_loop`` — submission at each request's wall-clock arrival.

The policy knobs (prefix store, chunked prefill, preemption, hold windows)
are the JAX engine's, and so is ``quant_policy``: a ``QuantPolicy``, or the
path of a policy artifact whose calibrated static activation scales are
attached after PTQ.  The engine runs on the card unless it is built with
``device="cpu"``, where every kernel runs its plain PyTorch version;
without a card it raises.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.analysis.guards import steady_state
from repro_torch.configs.base import OneRecConfig
from repro_torch.core.policy import QuantPolicy, load_policy_artifact
from repro_torch.device import resolve_device
from repro_torch.serving.executor import PhaseExecutor
from repro_torch.serving.kv_cache import PrefixStore, SlotPool
from repro_torch.serving.requests import requests_from_arrays
from repro_torch.serving.scheduler import (Completion, ContinuousScheduler,
                                           FixedBatchScheduler, Request,
                                           SchedulingPolicy)


class AdmissionFull(RuntimeError):
    """``submit`` backpressure: the bounded admission queue is at capacity.
    The caller sheds the request, retries after stepping, or routes it to
    another replica; the engine never blocks a submitter."""


class RequestCancelled(RuntimeError):
    """``result()`` on a handle whose request was cancelled."""


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 32           # default pool size
    use_fp8: bool = True           # PAPER_POLICY weights (else bf16)
    kv_dtype: str = "bfloat16"     # "bfloat16" | "float8_e4m3fn" (fp8
    #                                payload + per-(position, head) scales)
    topk: int = 8
    use_radix_topk: bool = False   # every select through kernel radix_topk
    greedy: bool = True            # unused, as in the JAX engine
    mode: str = "continuous"
    n_slots: int = 0               # KV-slot pool size; 0 => batch_size
    prefill_bucket_min: int = 16   # smallest ragged-prefill length bucket
    max_prefill_groups: int = 2    # bucket programs per join round
    max_candidates: int = 1
    max_queue: int = 0             # admission-queue bound; 0 = unbounded
    prefix_cache: bool = False     # content-addressed cross-request KV reuse
    prefix_rows: int = 0           # stored prefixes; 0 => 2x slots
    prefix_bytes_budget: int = 0   # LRU byte budget; 0 => all rows usable
    store_on_first_sight: bool = True   # False = second-sight admission
    prefill_chunk: int = 0         # max history tokens per prefill program
    preemption: bool = False       # free the worst decoding slot for a
    #                                strictly higher-priority arrival
    hold_k: int = 0                # admission hold window: join only when K
    hold_ms: float = 0.0           # requests or T ms accumulated (0 = off)
    paged: bool = True             # paged pool; False = contiguous rows
    page_size: int = 32            # logical positions per page
    n_pages: int = 0               # pool size; 0 => (n_slots + prefix
    #                                rows) full rows
    fused_decode: object = "auto"  # paged: kernel paged_decode (plain
    #                                version on the CPU), or "off" for the
    #                                gathered view; contiguous: must be off
    quant_policy: object = None    # a QuantPolicy, or the path of a
    #                                policy artifact (policy + calibrated
    #                                static activation scales)


_OFF = (False, None, "off")         # fused_decode values that mean off


class RequestHandle:
    """The caller's side of one submitted request: ``poll()`` (the
    ``Completion`` or None), ``result()`` (steps the engine until this
    request retires), ``cancel()`` and ``status``."""

    def __init__(self, engine: "ServingEngine", request: Request):
        self._engine = engine
        self._request = request
        self.completion: Optional[Completion] = None
        self.cancelled = False

    @property
    def rid(self) -> int:
        return self._request.rid

    @property
    def status(self) -> str:
        """``queued`` | ``running`` | ``done`` | ``cancelled``."""
        if self.cancelled:
            return "cancelled"
        if self.completion is not None:
            return "done"
        if any(q is self._request for q in self._engine._sched.queue):
            return "queued"
        return "running"

    def done(self) -> bool:
        return self.completion is not None

    def poll(self) -> Optional[Completion]:
        """Non-blocking: the ``Completion`` once retired, else None."""
        return self.completion

    def result(self) -> np.ndarray:
        """The generated item, stepping the engine until it retires."""
        self._engine._drain_until(
            lambda: self.completion is not None or self.cancelled)
        if self.cancelled:
            raise RequestCancelled(f"request {self.rid} was cancelled")
        if self.completion is None:
            raise RuntimeError(f"request {self.rid} never completed "
                               f"(engine drained without retiring it)")
        return self.completion.item

    def cancel(self) -> bool:
        """Withdraw the request; True when it was still queued or in
        flight (its slot, pages and prefix pins are released), False once
        it completed or was already cancelled."""
        return self._engine.cancel(self)


class ServingEngine:
    def __init__(self, params, cfg: OneRecConfig, engine_cfg: EngineConfig,
                 *, device=None):
        ecfg = engine_cfg
        _validate(ecfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.n_slots = ecfg.n_slots or ecfg.batch_size
        prefix_rows = (ecfg.prefix_rows or 2 * self.n_slots) \
            if ecfg.prefix_cache else 0
        # 0 sizes the pool to (n_slots + prefix_rows) worst-case rows,
        # branch spans included, as the JAX engine does, so both grant and
        # evict the same pages
        s_row = (cfg.context_len + 1 + (ecfg.max_candidates - 1)
                 * max(cfg.decode_len - 1, 0))
        n_pages = ecfg.n_pages or -(-(self.n_slots + prefix_rows) * s_row
                                    // ecfg.page_size)
        # tuned mixed-precision policy: a str is a policy artifact's path
        # (policy and calibrated static activation scales travel
        # together); a QuantPolicy applies as it is
        quant_policy, act_scales = ecfg.quant_policy, None
        if isinstance(quant_policy, str):
            artifact = load_policy_artifact(quant_policy)
            quant_policy = artifact["policy"]
            act_scales = artifact.get("act_scales") or None
        elif quant_policy is not None \
                and not isinstance(quant_policy, QuantPolicy):
            raise ValueError(
                f"quant_policy must be a QuantPolicy or an artifact path, "
                f"got {type(quant_policy).__name__}")
        self.executor = PhaseExecutor(
            params, cfg, n_slots=self.n_slots, device=self.device,
            use_fp8=ecfg.use_fp8, topk=ecfg.topk,
            quant_policy=quant_policy, act_scales=act_scales,
            use_radix_topk=ecfg.use_radix_topk,
            prefill_bucket_min=ecfg.prefill_bucket_min,
            kv_dtype=ecfg.kv_dtype, paged=ecfg.paged,
            page_size=ecfg.page_size, n_pages=n_pages,
            fused_decode=ecfg.fused_decode not in _OFF,
            prefix_rows=0 if ecfg.paged else prefix_rows,
            n_candidates=ecfg.max_candidates)
        # the store persists across stats windows (repeat traffic spans
        # them); paged, its entries are page references priced per page,
        # its budget the whole pool, and an eviction releases the pages
        if not prefix_rows:
            self.prefix_store = None
        elif ecfg.paged:
            self.prefix_store = PrefixStore(
                prefix_rows, self.executor.page_bytes,
                max_bytes=ecfg.prefix_bytes_budget
                or (n_pages + 1) * self.executor.page_bytes,
                n_codebooks=cfg.n_codebooks,
                store_on_first_sight=ecfg.store_on_first_sight,
                release_pages=self.executor.release_pages)
        else:
            self.prefix_store = PrefixStore(
                prefix_rows, self.executor.arena_row_bytes,
                max_bytes=ecfg.prefix_bytes_budget,
                n_codebooks=cfg.n_codebooks,
                store_on_first_sight=ecfg.store_on_first_sight)
        self.pool = SlotPool(self.n_slots)
        self._sched = self._make_scheduler(self.pool)
        self._rids = itertools.count()
        self._handles: Dict[int, RequestHandle] = {}
        self.reset_window()

    def _make_scheduler(self, pool: SlotPool
                        ) -> Union[ContinuousScheduler, FixedBatchScheduler]:
        ecfg = self.ecfg
        if ecfg.mode == "fixed":
            return FixedBatchScheduler(self.executor, pool, ecfg.batch_size)
        return ContinuousScheduler(
            self.executor, pool, ecfg.max_prefill_groups,
            prefix_store=self.prefix_store,
            policy=SchedulingPolicy(prefill_chunk=ecfg.prefill_chunk,
                                    preemption=ecfg.preemption,
                                    hold_k=ecfg.hold_k, hold_ms=ecfg.hold_ms))

    # -- request lifecycle ----------------------------------------------------

    def _check_candidates(self, request: Dict) -> Tuple[int, Optional[int]]:
        n_cand = int(request.get("n_candidates", 1))
        if not 1 <= n_cand <= self.ecfg.max_candidates:
            raise ValueError(
                f"n_candidates {n_cand} outside [1, "
                f"{self.ecfg.max_candidates}] (EngineConfig.max_candidates "
                f"sizes the branch spans of every cache row up front)")
        first = request.get("first_token")
        if first is not None and n_cand != 1:
            raise ValueError("first_token (forced seed) requires "
                             "n_candidates == 1")
        if first is not None and self.ecfg.mode != "continuous":
            raise ValueError("first_token requires continuous mode (the "
                             "fixed scheduler never forces seeds)")
        return n_cand, (int(first) if first is not None else None)

    def _check_history(self, i, n_tokens: int) -> None:
        max_hist = self.cfg.history_len * self.cfg.n_codebooks
        if n_tokens > max_hist:
            raise ValueError(
                f"request {i}: history of {n_tokens} tokens exceeds the "
                f"model's context ({max_hist} = history_len x n_codebooks)")

    def submit(self, request: Dict,
               base_s: Optional[float] = None) -> RequestHandle:
        """Queue one request dict ("tokens", "profile", optional
        "arrival_s" / "deadline_s" offsets from ``base_s``, default now,
        "priority", "n_candidates" (a ranked set of K items, tree decode)
        and "first_token" (a forced seed)); non-blocking.  Raises
        ``AdmissionFull`` when the bounded queue (``max_queue``) is at
        capacity."""
        tokens = np.asarray(request["tokens"], np.int32)
        self._check_history("<submit>", len(tokens))
        n_candidates, first_token = self._check_candidates(request)
        if self.ecfg.max_queue \
                and self._sched.queue_depth >= self.ecfg.max_queue:
            raise AdmissionFull(
                f"admission queue full ({self.ecfg.max_queue} requests); "
                f"step() or drain() to make room")
        base = time.perf_counter() if base_s is None else base_s
        r = Request(
            rid=next(self._rids), tokens=tokens,
            profile=np.asarray(request["profile"], np.float32),
            arrival_s=base + float(request.get("arrival_s", 0.0)),
            priority=int(request.get("priority", 0)),
            deadline_s=base + float(request["deadline_s"])
            if request.get("deadline_s") is not None else None,
            n_candidates=n_candidates, first_token=first_token)
        self._sched.enqueue(r)
        handle = RequestHandle(self, r)
        self._handles[r.rid] = handle
        return handle

    def step(self) -> List[Completion]:
        """Advance the scheduler one round and deliver completions."""
        done = self._sched.step()
        for c in done:
            handle = self._handles.pop(c.rid, None)
            if handle is not None:
                handle.completion = c
            self._window_done.append(c)
        return done

    def cancel(self, handle: RequestHandle) -> bool:
        if handle.cancelled or handle.completion is not None:
            return False
        if not self._sched.cancel(handle._request):
            return False
        handle.cancelled = True
        self._handles.pop(handle.rid, None)
        self._cancelled += 1
        return True

    @property
    def busy(self) -> bool:
        """True while any accepted request has not retired."""
        return self._sched.has_work

    def idle_wait_s(self) -> float:
        """How long ``step()`` would no-op for (next arrival or hold
        release); drive loops sleep this instead of spinning."""
        return self._sched.idle_wait_s()

    def _drain_until(self, predicate: Callable[[], bool]) -> None:
        """Step (and idle-sleep) until ``predicate`` holds or nothing is
        left.  The scheduler runs ``draining``: the caller is blocked here,
        so no submission can arrive and hold windows may release."""
        sched = self._sched
        prev, sched.draining = sched.draining, True
        try:
            while not predicate() and sched.has_work:
                self.step()
                wait = sched.idle_wait_s()
                if wait > 0:
                    time.sleep(wait)
        finally:
            sched.draining = prev

    def drain(self) -> None:
        """Step until every accepted request has retired."""
        self._drain_until(lambda: False)

    def steady_state(self):
        """Guarded region holding the warmed-up engine to the steady-state
        contract on its device (``analysis.guards.steady_state``): no
        unsanctioned host sync, no kernel build.  Warm the engine first on
        a representative batch, then step inside the guard::

            engine.serve_requests(reqs)          # warmup builds kernels
            with engine.steady_state() as mon:
                engine.serve_requests(reqs)
        """
        return steady_state(self.device)

    # -- windowed metrics -----------------------------------------------------

    def reset_window(self) -> None:
        """Start a measurement window: zero the executor counters, the
        scheduler accounting and the prefix-store stats; entries, queues
        and in-flight requests are untouched."""
        if self.prefix_store is not None:
            self.prefix_store.reset_window()
        for k in self.executor.counters:
            self.executor.counters[k] = 0
        self._sched.reset_window()
        self._window_done: List[Completion] = []
        self._rejected = 0
        self._cancelled = 0
        self._window_t0 = time.perf_counter()

    def stats(self) -> Dict[str, object]:
        return self._stats(time.perf_counter() - self._window_t0)

    def _stats(self, wall: float) -> Dict[str, object]:
        done = self._window_done
        sched = self._sched
        counters = self.executor.counters
        lat = np.asarray([c.latency_s for c in done], np.float64)
        join = np.asarray(sched.join_step_s, np.float64)
        return {
            "n_requests": float(len(done)),
            "wall_s": wall,
            "throughput_rps": len(done) / wall if wall else 0.0,
            "mean_latency_s": float(lat.mean()) if lat.size else 0.0,
            "p50_latency_s": float(np.percentile(lat, 50))
            if lat.size else 0.0,
            "p99_latency_s": float(np.percentile(lat, 99))
            if lat.size else 0.0,
            "slot_occupancy": float(np.mean(sched.occupancy))
            if sched.occupancy else 0.0,
            "n_slots": float(self.n_slots),
            "kv_dtype": self.ecfg.kv_dtype,
            "kv_row_bytes": float(self.executor.pool_row_bytes),
            "kv_bytes": float(self.executor.kv_bytes),
            **{k: float(v) for k, v in counters.items()},
            "branches_per_decode_step":
                counters["branch_tokens"] / counters["decode_steps"]
                if counters["decode_steps"] else 0.0,
            "fused_decode_mode": self._fused_decode_mode(),
            "mode": self.ecfg.mode,
            "rejected": float(self._rejected),
            "cancelled": float(self._cancelled),
            "hold_rounds": float(sched.holds),
            "queue_depth": float(sched.queue_depth),
            "prefill_padded_token_frac":
                1.0 - counters["prefill_tokens_real"]
                / counters["prefill_tokens_batched"]
                if counters["prefill_tokens_batched"] else 0.0,
            "join_steps": float(join.size),
            "join_p50_s": float(np.percentile(join, 50))
            if join.size else 0.0,
            "join_p99_s": float(np.percentile(join, 99))
            if join.size else 0.0,
            "decode_stall_frac": sched.decode_stall_s / wall if wall else 0.0,
            "preemptions": float(sched.preemptions),
            **self._sla_stats(done),
            **self._prefix_stats(),
            **self._paged_stats(),
        }

    def _fused_decode_mode(self) -> str:
        """Where ``paged_decode`` runs, or ``off`` (the gathered view, or
        the contiguous layout)."""
        if not self.executor.fused_decode:
            return "off"
        return "cuda" if self.device.type == "cuda" else "plain"

    def _paged_stats(self) -> Dict[str, float]:
        """Page-pool metrics; zeros for the contiguous layout, as JAX."""
        pp = self.executor.page_pool
        if pp is None:
            return {"pages_total": 0.0, "pages_free": 0.0,
                    "page_size": 0.0, "kv_bytes_pinned": 0.0}
        return {"pages_total": float(pp.n_pages),
                "pages_free": float(pp.n_free),
                "page_size": float(pp.page_size),
                "kv_bytes_pinned": float(pp.n_used
                                         * self.executor.page_bytes)}

    def serve_requests(self, requests: List[Dict]
                       ) -> Tuple[List[np.ndarray], Dict[str, object]]:
        """Closed-batch shim over submit + step + drain: serve ``requests``
        (offsets measured from call start); returns per-request outputs in
        input order and the call's stats."""
        for i, r in enumerate(requests):
            self._check_history(i, len(r["tokens"]))
        self.reset_window()
        if not requests:
            return [], self._stats(0.0)
        sched = self._sched
        prev, sched.draining = sched.draining, True
        try:
            handles = []
            for r in requests:
                while True:
                    try:
                        # offsets anchor at call start: a submission the
                        # bounded queue delays keeps its true arrival
                        handles.append(self.submit(r,
                                                   base_s=self._window_t0))
                        break
                    except AdmissionFull:  # bounded queue: step to drain it
                        self._drain_until(
                            lambda: sched.queue_depth < self.ecfg.max_queue)
            self.drain()
        finally:
            sched.draining = prev
        wall = time.perf_counter() - self._window_t0
        return [h.completion.item for h in handles], self._stats(wall)

    def generate_batch(self, tokens: np.ndarray, profile: np.ndarray
                       ) -> np.ndarray:
        """One uniform batch (B, H*3) -> (B, decode_len)."""
        outputs, _ = self.serve_requests(requests_from_arrays(tokens,
                                                              profile))
        return np.stack(outputs)

    @staticmethod
    def _sla_stats(done: List[Completion]) -> Dict[str, object]:
        """Deadline accounting overall and per priority class; miss rates
        are over the requests that HAVE a deadline."""
        with_dl = [c for c in done if c.deadline_s is not None]
        misses = sum(c.deadline_missed for c in with_dl)
        classes: Dict[str, List[Completion]] = {}
        for c in done:
            classes.setdefault(str(c.priority), []).append(c)
        class_stats = {}
        for cls, cs in sorted(classes.items()):
            lat = np.asarray([c.latency_s for c in cs])
            cls_dl = [c for c in cs if c.deadline_s is not None]
            class_stats[cls] = {
                "n": float(len(cs)),
                "mean_latency_s": float(lat.mean()),
                "p99_latency_s": float(np.percentile(lat, 99)),
                "deadline_misses": float(sum(c.deadline_missed
                                             for c in cls_dl)),
                "deadline_miss_rate": sum(c.deadline_missed for c in cls_dl)
                / len(cls_dl) if cls_dl else 0.0,
            }
        return {"deadline_misses": float(misses),
                "deadline_miss_rate": misses / len(with_dl)
                if with_dl else 0.0,
                "class_stats": class_stats}

    def _prefix_stats(self) -> Dict[str, float]:
        """Prefix-store metrics (zeros when the store is off)."""
        s = self.prefix_store
        if s is None:
            return {"prefix_hit_rate": 0.0, "prefix_hits": 0.0,
                    "prefix_admissions": 0.0, "prefix_tokens_saved": 0.0,
                    "prefix_entries": 0.0, "prefix_evictions": 0.0,
                    "prefix_first_sights": 0.0,
                    "prefix_store_bytes": 0.0, "prefix_bytes_pinned": 0.0}
        return {"prefix_hit_rate": s.hit_rate,
                "prefix_hits": float(s.hits),
                "prefix_admissions": float(s.admissions),
                "prefix_tokens_saved": float(s.tokens_saved),
                "prefix_entries": float(s.n_entries),
                "prefix_evictions": float(s.evictions),
                "prefix_first_sights": float(s.first_sights),
                "prefix_store_bytes": float(s.bytes_used),
                "prefix_bytes_pinned": float(s.peak_bytes_pinned)}


def _validate(ecfg: EngineConfig) -> None:
    """The JAX engine's checks of the settings (``ValueError``), and the
    port's on ``fused_decode``, which logs no fallback."""
    if ecfg.mode not in ("continuous", "fixed"):
        raise ValueError(f"unknown scheduler mode {ecfg.mode!r}")
    if ecfg.prefix_cache and ecfg.mode != "continuous":
        raise ValueError("prefix_cache requires continuous mode")
    if not ecfg.store_on_first_sight and not ecfg.prefix_cache:
        raise ValueError("second-sight admission requires prefix_cache")
    if ecfg.mode != "continuous" and (ecfg.prefill_chunk or ecfg.preemption
                                      or ecfg.hold_k or ecfg.hold_ms):
        raise ValueError("prefill_chunk / preemption / hold windows "
                         "require continuous mode")
    if ecfg.max_candidates < 1:
        raise ValueError(f"max_candidates must be >= 1, got "
                         f"{ecfg.max_candidates}")
    if ecfg.max_candidates > 1 and ecfg.mode != "continuous":
        raise ValueError("multi-candidate decode requires continuous mode "
                         "(fixed mode is the single-item reference)")
    if ecfg.max_candidates > ecfg.topk:
        raise ValueError(f"max_candidates ({ecfg.max_candidates}) exceeds "
                         f"topk ({ecfg.topk})")
    if ecfg.max_queue and ecfg.hold_k > ecfg.max_queue:
        raise ValueError(
            f"hold_k ({ecfg.hold_k}) must not exceed max_queue "
            f"({ecfg.max_queue}): a full admission queue could never "
            f"accumulate the hold count, livelocking submitters")
    if ecfg.mode == "fixed" and ecfg.max_queue \
            and ecfg.max_queue < ecfg.batch_size:
        raise ValueError(
            f"max_queue ({ecfg.max_queue}) must cover batch_size "
            f"({ecfg.batch_size}) in fixed mode: a full admission queue "
            f"could never form a batch, livelocking submitters")
    if ecfg.kv_dtype not in ("bfloat16", "float8_e4m3fn"):
        raise ValueError(f"kv_dtype must be 'bfloat16' or 'float8_e4m3fn', "
                         f"got {ecfg.kv_dtype!r}")
    if ecfg.paged and ecfg.mode != "continuous":
        raise ValueError("the paged KV layout requires continuous mode "
                         "(fixed mode is the contiguous reference; pass "
                         "paged=False, fused_decode='off')")
    if ecfg.page_size <= 0:
        raise ValueError(f"page_size must be positive, got "
                         f"{ecfg.page_size}")
    if ecfg.fused_decode not in _OFF + (True, "auto"):
        raise ValueError(f"fused_decode must be 'auto' or 'off', got "
                         f"{ecfg.fused_decode!r}")
    if not ecfg.paged and ecfg.fused_decode not in _OFF:
        raise ValueError(
            f"fused_decode={ecfg.fused_decode!r}: the contiguous layout "
            f"(paged=False) has no fused decode; pass fused_decode='off'")


def run_open_loop(engine: ServingEngine, requests: List[Dict],
                  drop_on_full: bool = False
                  ) -> Tuple[List[Optional[np.ndarray]], Dict[str, object]]:
    """Open-loop serving: submit each request at its WALL-CLOCK arrival
    (its "arrival_s" offset from loop start), stepping the engine between
    arrivals.  "deadline_s" offsets stay anchored to the workload clock.
    With ``drop_on_full`` a bounded queue sheds load (``AdmissionFull`` ->
    output None, counted in ``stats()["rejected"]``); otherwise the
    backpressure propagates.  Returns (outputs in input order, stats)."""
    engine.reset_window()
    t0 = engine._window_t0
    order = sorted(range(len(requests)),
                   key=lambda j: requests[j].get("arrival_s", 0.0))
    handles: List[Optional[RequestHandle]] = [None] * len(requests)
    for j in order:
        target = float(requests[j].get("arrival_s", 0.0))
        while True:
            now = time.perf_counter() - t0
            if now >= target:
                break
            if engine.busy:
                counters = engine.executor.counters
                before = counters["prefill_calls"] + counters["decode_steps"]
                engine.step()
                wait = engine.idle_wait_s()
                if wait <= 0 and (counters["prefill_calls"]
                                  + counters["decode_steps"]) == before:
                    # blocked on submissions the scheduler cannot foresee
                    # (a count-only hold): nap instead of spinning
                    wait = 1e-3
            else:
                wait = target - now
            if wait > 0:
                now = time.perf_counter() - t0
                time.sleep(min(wait, max(0.0, target - now)))
        rel = dict(requests[j])
        rel.pop("arrival_s", None)          # arrival IS the submit instant
        now = time.perf_counter() - t0
        if rel.get("deadline_s") is not None:
            rel["deadline_s"] = float(rel["deadline_s"]) - now
        try:
            handles[j] = engine.submit(rel)
        except AdmissionFull:
            if not drop_on_full:
                raise
            engine._rejected += 1     # shed: the request is never served
    engine.drain()
    outputs = [h.completion.item if h is not None and h.completion is not None
               else None for h in handles]
    return outputs, engine.stats()
