"""OneRec serving engine on the card: the open-system request lifecycle of
``repro/serving/engine.py`` (``submit`` -> ``step`` -> ``drain``, and the
closed-batch ``serve_requests`` shim) over the paged FP8 KV pool with fused
decode.

The engine runs on the card unless it is built with ``device="cpu"``, where
every kernel runs its plain PyTorch version; without a card it raises.
Settings of ``EngineConfig`` that the port does not cover yet raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import OneRecConfig
from repro_torch.device import resolve_device
from repro_torch.serving.executor import PhaseExecutor
from repro_torch.serving.kv_cache import SlotPool
from repro_torch.serving.scheduler import (Completion, ContinuousScheduler,
                                           Request)


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 32           # default pool size
    use_fp8: bool = True           # PAPER_POLICY weights (else bf16)
    kv_dtype: str = "bfloat16"     # "bfloat16" | "float8_e4m3fn" (fp8
    #                                payload + per-(position, head) scales)
    topk: int = 8
    use_radix_topk: bool = False
    mode: str = "continuous"
    n_slots: int = 0               # KV-slot pool size; 0 => batch_size
    prefill_bucket_min: int = 16   # smallest ragged-prefill length bucket
    max_prefill_groups: int = 2    # bucket programs per join round
    max_candidates: int = 1
    prefix_cache: bool = False
    prefill_chunk: int = 0
    preemption: bool = False
    hold_k: int = 0
    hold_ms: float = 0.0
    paged: bool = True             # the port serves the paged layout only
    page_size: int = 32            # logical positions per page
    n_pages: int = 0               # pool size; 0 => n_slots full rows
    fused_decode: object = "auto"  # kernel paged_decode (plain version on
    #                                the CPU); "off" is not ported
    quant_policy: object = None


# (setting is outside the slice, what it is, ROADMAP.md item)
_NOT_PORTED: Tuple[Tuple[Callable[[EngineConfig], bool], str, str], ...] = (
    (lambda c: not c.paged, "paged=False (the contiguous layout)", "N1"),
    (lambda c: c.fused_decode in (False, None, "off"),
     "fused_decode off (the unfused paged decode)", "N1"),
    (lambda c: c.prefix_cache, "prefix_cache", "N2"),
    (lambda c: c.prefill_chunk, "prefill_chunk", "N2"),
    (lambda c: c.preemption, "preemption", "N2"),
    (lambda c: c.hold_k or c.hold_ms, "hold_k / hold_ms", "N2"),
    (lambda c: c.max_candidates != 1, "max_candidates > 1 (tree decode)",
     "N3"),
    (lambda c: c.mode != "continuous", "mode other than continuous", "N4"),
    (lambda c: c.quant_policy is not None, "quant_policy", "N5"),
    (lambda c: c.use_radix_topk, "use_radix_topk", "N6"),
)


class RequestHandle:
    """The caller's side of one submitted request."""

    def __init__(self, engine: "ServingEngine", request: Request):
        self._engine = engine
        self._request = request
        self.completion: Optional[Completion] = None

    def done(self) -> bool:
        return self.completion is not None

    def result(self) -> np.ndarray:
        """The generated item, stepping the engine until it retires."""
        self._engine._drain_until(lambda: self.completion is not None)
        return self.completion.item


class ServingEngine:
    def __init__(self, params, cfg: OneRecConfig, engine_cfg: EngineConfig,
                 *, device=None):
        for not_ported, what, item in _NOT_PORTED:
            if not_ported(engine_cfg):
                raise NotImplementedError(
                    f"EngineConfig {what} is not ported yet "
                    f"(ROADMAP.md queue N, item {item})")
        if engine_cfg.fused_decode not in (True, "auto"):
            raise ValueError(f"fused_decode must be 'auto', got "
                             f"{engine_cfg.fused_decode!r}")
        if engine_cfg.kv_dtype not in ("bfloat16", "float8_e4m3fn"):
            raise ValueError(f"kv_dtype must be 'bfloat16' or "
                             f"'float8_e4m3fn', got {engine_cfg.kv_dtype!r}")
        if engine_cfg.page_size <= 0:
            raise ValueError(f"page_size must be positive, got "
                             f"{engine_cfg.page_size}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.n_slots = engine_cfg.n_slots or engine_cfg.batch_size
        # 0 sizes the pool to n_slots worst-case rows
        n_pages = engine_cfg.n_pages or \
            -(-self.n_slots * (cfg.context_len + 1) // engine_cfg.page_size)
        self.executor = PhaseExecutor(
            params, cfg, n_slots=self.n_slots, device=self.device,
            use_fp8=engine_cfg.use_fp8, topk=engine_cfg.topk,
            prefill_bucket_min=engine_cfg.prefill_bucket_min,
            kv_dtype=engine_cfg.kv_dtype, page_size=engine_cfg.page_size,
            n_pages=n_pages)
        self.pool = SlotPool(self.n_slots)
        self._sched = ContinuousScheduler(self.executor, self.pool,
                                          engine_cfg.max_prefill_groups)
        self._rids = itertools.count()
        self._handles: Dict[int, RequestHandle] = {}
        self.reset_window()

    # -- request lifecycle ----------------------------------------------------

    def _check_history(self, i, n_tokens: int) -> None:
        max_hist = self.cfg.history_len * self.cfg.n_codebooks
        if n_tokens > max_hist:
            raise ValueError(
                f"request {i}: history of {n_tokens} tokens exceeds the "
                f"model's context ({max_hist} = history_len x n_codebooks)")

    def submit(self, request: Dict,
               base_s: Optional[float] = None) -> RequestHandle:
        """Queue one request dict ("tokens", "profile", optional
        "arrival_s" / "deadline_s" offsets from ``base_s``, default now, and
        "priority"); non-blocking."""
        tokens = np.asarray(request["tokens"], np.int32)
        self._check_history("<submit>", len(tokens))
        if request.get("n_candidates", 1) != 1 \
                or request.get("first_token") is not None:
            raise NotImplementedError("multi-candidate and forced-seed "
                                      "requests are not ported yet "
                                      "(ROADMAP.md queue N, item N3)")
        base = time.perf_counter() if base_s is None else base_s
        r = Request(
            rid=next(self._rids), tokens=tokens,
            profile=np.asarray(request["profile"], np.float32),
            arrival_s=base + float(request.get("arrival_s", 0.0)),
            priority=int(request.get("priority", 0)),
            deadline_s=base + float(request["deadline_s"])
            if request.get("deadline_s") is not None else None)
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

    def _drain_until(self, predicate: Callable[[], bool]) -> None:
        sched = self._sched
        while not predicate() and sched.has_work:
            self.step()
            wait = sched.idle_wait_s()
            if wait > 0:
                time.sleep(wait)

    def drain(self) -> None:
        """Step until every accepted request has retired."""
        self._drain_until(lambda: False)

    # -- windowed metrics -----------------------------------------------------

    def reset_window(self) -> None:
        for k in self.executor.counters:
            self.executor.counters[k] = 0
        self._sched.reset_window()
        self._window_done: List[Completion] = []
        self._window_t0 = time.perf_counter()

    def stats(self) -> Dict[str, object]:
        return self._stats(time.perf_counter() - self._window_t0)

    def _stats(self, wall: float) -> Dict[str, object]:
        done = self._window_done
        sched = self._sched
        counters = self.executor.counters
        pp = self.executor.page_pool
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
            "fused_decode_mode": "cuda" if self.device.type == "cuda"
            else "plain",
            "mode": self.ecfg.mode,
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
            "pages_total": float(pp.n_pages),
            "pages_free": float(pp.n_free),
            "page_size": float(pp.page_size),
            "kv_bytes_pinned": float(pp.n_used * self.executor.page_bytes),
        }

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
        handles = [self.submit(r, base_s=self._window_t0) for r in requests]
        self.drain()
        wall = time.perf_counter() - self._window_t0
        return [h.completion.item for h in handles], self._stats(wall)
