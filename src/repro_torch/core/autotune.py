"""Accuracy-driven mixed-precision auto-tuner, the JAX package's
``repro/core/autotune.py`` in PyTorch (same phases, acceptance rules,
trace entries and artifact).

The paper ships one fixed FP8 assignment.  The search turns it into a
quality / bytes frontier:

  1. measure the uniform ``PAPER_POLICY``: teacher-forced top-K overlap
     against the unquantized model plus the quantized bytes;
  2. CONTRACT while overlap < target: de-quantize the worst pattern group
     by per-tensor ``rel_err`` of the ``PTQReport`` (``"skip"``);
  3. EXPAND once at or above target: try fp8 on matmul-consumable groups
     the default policy excludes, accepted while overlap holds the target;
  4. INT8 frontier: push the most robust fp8 linear groups to W8A8;
  5. STATIC activation scales, calibrated and kept if overlap holds.

Every candidate lands in the trace; ``AutotuneResult.save`` writes the
versioned artifact of ``core.policy``, which the port's engine deploys
(``EngineConfig.quant_policy``, ``launch/serve.py --quant-policy``).

The harnesses (``onerec``: prefill + decode against a fixed unquantized
teacher trajectory; ``lm``: per-position logits; ``recsys``: retrieval
ranking) run on reduced configs on ``device`` (the card unless ``"cpu"``).
Their params come from the port's initializers and a seeded
``torch.Generator``, or from the caller (``params=``, e.g. the JAX
package's through ``weights.params_from_numpy``), and so do their
batches; the recsys batches are the JAX package's own numpy draws.  Group
order, which breaks ties between equal ``rel_err``s, is the JAX package's
traversal order (dict keys sorted at every level), whatever the order of
the port's tree.
"""

from __future__ import annotations

import dataclasses
import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import ptq
from repro_torch.core.policy import (PAPER_POLICY, QuantPolicy,
                                     save_policy_artifact)
from repro_torch.device import resolve_device

# Groups the default policy leaves in high precision but whose weights are
# consumed through ``matmul_any`` in every zoo model, so fp8 is safe to TRY
# (acceptance is still measured).  Embedding tables are gathered, not
# multiplied, and cannot hold a QuantizedTensor.
EXPAND_PATTERNS: Tuple[str, ...] = (
    "*lm_head*",             # transformer logits head (untied)
    "*/moe/router/*",        # MoE router projection
    "*/attn_mlp/*/kernel",   # DIN local activation unit
    "*profile_proj*",        # OneRec profile token projection
)


@dataclasses.dataclass
class EvalTask:
    """A config-specific evaluation harness.

    ``params`` is the unquantized tree; ``overlap(qparams)`` returns the
    teacher-forced top-K overlap of the quantized model against it (1.0 =
    identical candidate sets); ``calib_forward`` / ``calib_batches`` drive
    static-scale calibration."""

    name: str
    family: str
    params: Any
    overlap: Callable[[Any], float]
    calib_forward: Optional[Callable[[Any, Any], Any]] = None
    calib_batches: Sequence[Any] = ()


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(x, np.float32)


def _topk_overlap(lg_a, lg_b, k: int) -> float:
    V = lg_a.shape[-1]
    a = np.argsort(-_host(lg_a).reshape(-1, V), -1)[:, :k]
    b = np.argsort(-_host(lg_b).reshape(-1, V), -1)[:, :k]
    return float(np.mean([len(set(x) & set(y)) / k for x, y in zip(a, b)]))


def _rank_overlap(s_a, s_b, k: int) -> float:
    """Top-k overlap of two 1-D candidate score vectors."""
    a = np.argsort(-_host(s_a).ravel())[:k]
    b = np.argsort(-_host(s_b).ravel())[:k]
    return len(set(a) & set(b)) / k


def _generator(device, seed: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _onerec_task(name: str, cfg, *, seed: int, topk: int, device,
                 params=None, batch=None) -> EvalTask:
    from repro_torch.models import onerec as onerec_model

    if params is None:
        params = onerec_model.init_onerec(seed, cfg, device=device)
    T = cfg.history_len * cfg.n_codebooks
    B = 4
    if batch is None:
        gen = _generator(device, seed + 1)
        batch = {
            "tokens": torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                                    device=device, dtype=torch.int32),
            "profile": torch.randn((B, onerec_model.PROFILE_DIM),
                                   generator=gen, device=device)}

    # unquantized teacher trajectory: greedy tokens + per-step logits
    ref_logits: List[np.ndarray] = []
    forced: List[torch.Tensor] = []
    cache = onerec_model.init_cache(cfg, B, device=device)
    lg, cache = onerec_model.prefill(params, batch, cfg, cache)
    for t in range(cfg.decode_len):
        ref_logits.append(_host(lg))
        nxt = onerec_model.stable_top_k(lg, 1)[1].to(torch.int32)  # (B, 1)
        forced.append(nxt)
        lg, cache = onerec_model.decode_step(params, nxt, cfg, cache,
                                             T + 1 + t)

    def overlap(qparams) -> float:
        c = onerec_model.init_cache(cfg, B, device=device)
        lg_q, c = onerec_model.prefill(qparams, batch, cfg, c)
        vals = []
        for t in range(cfg.decode_len):
            vals.append(_topk_overlap(ref_logits[t], lg_q, topk))
            lg_q, c = onerec_model.decode_step(qparams, forced[t], cfg, c,
                                               T + 1 + t)
        return float(np.mean(vals))

    def calib_forward(qparams, b):
        onerec_model.forward(qparams, b, cfg)

    return EvalTask(name=name, family="onerec", params=params,
                    overlap=overlap, calib_forward=calib_forward,
                    calib_batches=[batch])


def _lm_task(name: str, cfg, *, seed: int, topk: int, device, params=None,
             tokens=None) -> EvalTask:
    from repro_torch.models import transformer as tfm

    if params is None:
        params = tfm.init_transformer(_generator(device, seed), cfg,
                                      device=device)
    B, T = 4, 16
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (B, T),
                               generator=_generator(device, seed + 1),
                               device=device, dtype=torch.int32)
    ref = _host(tfm.forward(params, tokens, cfg)[0])

    def overlap(qparams) -> float:
        lg, _ = tfm.forward(qparams, tokens, cfg)
        return _topk_overlap(ref, lg, topk)

    def calib_forward(qparams, b):
        tfm.forward(qparams, b, cfg)

    return EvalTask(name=name, family="lm", params=params, overlap=overlap,
                    calib_forward=calib_forward, calib_batches=[tokens])


def _recsys_task(name: str, cfg, *, seed: int, topk: int, device,
                 params=None, n_users: int = 4,
                 n_candidates: int = 64) -> EvalTask:
    from repro_torch.models import recsys as recsys_model

    if params is None:
        params = recsys_model.init_recsys(_generator(device, seed), cfg,
                                          device=device)
    rng = np.random.default_rng(seed)       # the JAX package's draws

    def ids(high, shape):
        return torch.from_numpy(rng.integers(0, high, shape).astype(
            np.int32)).to(device)

    batches = [{"hist_ids": ids(cfg.n_items, (1, cfg.seq_len)),
                "candidate_ids": ids(cfg.n_items, (n_candidates,)),
                "field_ids": ids(cfg.field_vocab, (1, cfg.n_sparse_fields))}
               for _ in range(n_users)]
    refs = [_host(recsys_model.retrieval_scores(params, b, cfg))
            for b in batches]

    def overlap(qparams) -> float:
        vals = [_rank_overlap(r, recsys_model.retrieval_scores(qparams, b,
                                                               cfg), topk)
                for r, b in zip(refs, batches)]
        return float(np.mean(vals))

    def calib_forward(qparams, b):
        recsys_model.retrieval_scores(qparams, b, cfg)

    return EvalTask(name=name, family="recsys", params=params,
                    overlap=overlap, calib_forward=calib_forward,
                    calib_batches=batches)


def make_eval_task(arch: str, *, seed: int = 0, topk: int = 8, device=None,
                   params=None, **batches) -> EvalTask:
    """The family's harness for ``arch``'s reduced config on ``device`` (the
    card unless ``"cpu"``), with ``params`` and the family's batches
    (``batch=`` for onerec, ``tokens=`` for lm) made from ``seed`` unless
    given."""
    from repro_torch.configs.registry import get_arch

    mod = get_arch(arch)
    cfg = mod.reduced_config()
    kw = dict(seed=seed, topk=topk, device=resolve_device(device),
              params=params, **batches)
    family = mod.FAMILY
    if family == "onerec":
        return _onerec_task(arch, cfg, **kw)
    if family == "lm":
        return _lm_task(arch, cfg, **kw)
    if family == "recsys":
        return _recsys_task(arch, cfg, **kw)
    raise ValueError(f"no autotune eval harness for family {family!r} "
                     f"(arch {arch!r})")


# ---------------------------------------------------------------------------
# Measurement + group introspection
# ---------------------------------------------------------------------------


def measure(task: EvalTask, policy: QuantPolicy,
            act_scales: Optional[Dict[str, float]] = None
            ) -> Tuple[float, int, ptq.PTQReport]:
    """(overlap, quantized bytes_before, report) for one candidate policy."""
    qparams, report = ptq.quantize_params(task.params, policy,
                                          with_report=True,
                                          compute_errors=True)
    if act_scales:
        qparams = ptq.apply_static_act_scales(qparams, act_scales)
    return task.overlap(qparams), report.bytes_before, report


def group_stats(report: ptq.PTQReport) -> List[Dict[str, Any]]:
    """Aggregate report entries by deciding pattern (the tuner's groups),
    worst ``rel_err`` first; entries are read in the JAX package's
    traversal order, so ties break as they do there."""
    groups: Dict[str, Dict[str, Any]] = {}
    for e in sorted(report.entries, key=lambda e: e["path"].split("/")):
        g = groups.setdefault(e["pattern"], dict(
            pattern=e["pattern"], kind=e["kind"], rel_err=0.0,
            bytes=0, n_leaves=0))
        g["rel_err"] = max(g["rel_err"], e["rel_err"])
        g["bytes"] += e["bytes_before"]
        g["n_leaves"] += 1
    return sorted(groups.values(), key=lambda g: -g["rel_err"])


def _unquantized_matches(task: EvalTask, policy: QuantPolicy,
                         pattern: str) -> int:
    """Bytes of ndim >= 2 float leaves ``pattern`` would newly quantize."""
    total = 0
    for p, leaf in tree.leaves_with_path(task.params):
        if not fnmatch.fnmatch(p, pattern):
            continue
        if not torch.is_tensor(leaf) or leaf.ndim < 2:
            continue
        if not leaf.is_floating_point():
            continue
        if policy.classify(p, leaf.ndim, tuple(leaf.shape)) is None:
            total += leaf.numel() * leaf.element_size()
    return total


# ---------------------------------------------------------------------------
# The search
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AutotuneResult:
    policy: QuantPolicy
    overlap: float
    bytes_quantized: int
    uniform: Dict[str, Any]            # PAPER_POLICY reference point
    groups: List[Dict[str, Any]]       # per-group stats under final policy
    trace: List[Dict[str, Any]]        # every candidate evaluation
    act_scales: Dict[str, float]       # static scales (when accepted)
    target: float

    def save(self, path: str, *, config: str = "") -> Dict[str, Any]:
        return save_policy_artifact(
            path, self.policy, config=config or "",
            target_overlap=self.target,
            measured=dict(overlap=self.overlap,
                          bytes_quantized=self.bytes_quantized),
            groups=self.groups, trace=self.trace, uniform=self.uniform,
            act_scales=self.act_scales)


def autotune(task: EvalTask, *,
             target: float = 0.6,
             max_steps: int = 16,
             start: QuantPolicy = PAPER_POLICY,
             expand_patterns: Sequence[str] = EXPAND_PATTERNS,
             try_expand: bool = True,
             try_int8: bool = True,
             max_int8: int = 2,
             try_static_acts: bool = True,
             log: Optional[Callable[[str], None]] = None) -> AutotuneResult:
    """Greedy accuracy-aware search from ``start`` (the uniform policy).

    ``max_steps`` caps candidate evaluations after the uniform measurement
    (each one quantize + eval pass); the phases are the module
    docstring's.  ``log`` (e.g. ``print``) narrates the search."""
    say = log or (lambda s: None)
    trace: List[Dict[str, Any]] = []
    steps = 0

    def _eval(action: str, group: str, policy: QuantPolicy,
              scales=None) -> Tuple[float, int, ptq.PTQReport]:
        nonlocal steps
        steps += 1
        ov, by, rep = measure(task, policy, scales)
        say(f"  [{steps:2d}] {action:12s} {group or '-':28s} "
            f"overlap={ov:.3f} bytes={by}")
        return ov, by, rep

    overlap, nbytes, report = _eval("uniform", "", start)
    uniform = dict(overlap=overlap, bytes_quantized=nbytes)
    trace.append(dict(step=0, action="uniform", group=None, overlap=overlap,
                      bytes_quantized=nbytes, accepted=True))
    policy = start

    # -- contraction: de-quantize worst offenders until target is met ------
    skipped: set = set()
    while overlap < target and steps < max_steps:
        candidates = [g for g in group_stats(report)
                      if g["pattern"] not in skipped]
        if not candidates:
            break
        worst = candidates[0]
        skipped.add(worst["pattern"])
        trial = policy.override(worst["pattern"], "skip")
        ov, by, rep = _eval("skip", worst["pattern"], trial)
        accepted = ov > overlap
        trace.append(dict(step=steps, action="skip", group=worst["pattern"],
                          overlap=ov, bytes_quantized=by, accepted=accepted))
        if accepted:
            policy, overlap, nbytes, report = trial, ov, by, rep

    # -- expansion: quantize default-excluded consumable groups ------------
    if try_expand and overlap >= target:
        for pat in expand_patterns:
            if steps >= max_steps:
                break
            if _unquantized_matches(task, policy, pat) == 0:
                continue                       # nothing new to quantize
            trial = policy.override(pat, "linear")
            ov, by, rep = _eval("expand", pat, trial)
            accepted = ov >= target
            trace.append(dict(step=steps, action="expand", group=pat,
                              overlap=ov, bytes_quantized=by,
                              accepted=accepted))
            if accepted:
                policy, overlap, nbytes, report = trial, ov, by, rep

    # -- int8 frontier: most robust fp8 linear groups down to W8A8 ---------
    if try_int8 and overlap >= target:
        robust = [g for g in reversed(group_stats(report))
                  if g["kind"] == "linear"][:max_int8]
        for g in robust:
            if steps >= max_steps:
                break
            trial = policy.override(g["pattern"], "int8")
            ov, by, rep = _eval("int8", g["pattern"], trial)
            accepted = ov >= target
            trace.append(dict(step=steps, action="int8", group=g["pattern"],
                              overlap=ov, bytes_quantized=by,
                              accepted=accepted))
            if accepted:
                policy, overlap, nbytes, report = trial, ov, by, rep

    # -- static activation scales (drops the runtime amax reduction) -------
    act_scales: Dict[str, float] = {}
    if try_static_acts and overlap >= target and steps < max_steps \
            and task.calib_forward is not None:
        qparams = ptq.quantize_params(task.params, policy)
        scales = ptq.calibrate_static_act_scales(
            task.calib_forward, qparams, task.calib_batches)
        if scales:
            trial = policy.replace(static_acts=True)
            ov, by, rep = _eval("static_acts", "", trial, scales)
            accepted = ov >= target
            trace.append(dict(step=steps, action="static_acts", group=None,
                              overlap=ov, bytes_quantized=by,
                              accepted=accepted))
            if accepted:
                policy, overlap, nbytes, report = trial, ov, by, rep
                act_scales = scales

    return AutotuneResult(policy=policy, overlap=overlap,
                          bytes_quantized=nbytes, uniform=uniform,
                          groups=group_stats(report), trace=trace,
                          act_scales=act_scales, target=target)
