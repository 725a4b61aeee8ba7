"""Quantization policy: WHICH tensors get WHICH granularity (paper §4.1/§5.1).

The paper quantizes only the computation-dominant operators — Linear layers
(attention qkvo, dense-FFN linears) and the grouped GEMM of sparse-MoE
experts — and leaves numerically sensitive / compute-light components
(embeddings, norms, the MoE router, logits head) in high precision.

Policies are declarative (path-glob based) so one policy covers the whole
architecture zoo; per-arch configs may extend/override the default.

Beyond the paper's single fixed config, a policy carries ordered per-group
``overrides`` — ``(pattern, decision)`` pairs the accuracy-driven auto-tuner
(``repro.core.autotune``) searches over: ``"skip"`` de-quantizes a pattern
group the fp8 grid hurts, ``"linear"`` quantizes a group the default
excludes (frontier expansion, e.g. the logits head), ``"int8"`` pushes the
most robust groups below fp8.  Policies round-trip through JSON
(`to_json_dict`/`from_json_dict`) and ship inside a versioned artifact file
(`save_policy_artifact`/`load_policy_artifact`) together with the tuner's
measured (overlap, bytes) trace and optional calibrated static activation
scales — a tuned policy is a deployable object, not code.

This module is deliberately stdlib-only (no jax): policy artifacts must be
loadable by lightweight tooling.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

# Matches our param-naming convention (see repro/layers): every matmul weight
# is a leaf called "kernel" inside a named projection module.
DEFAULT_LINEAR_PATTERNS: Tuple[str, ...] = (
    "*/attn/q_proj/kernel",
    "*/attn/k_proj/kernel",
    "*/attn/v_proj/kernel",
    "*/attn/o_proj/kernel",
    "*/mlp/gate/kernel",
    "*/mlp/up/kernel",
    "*/mlp/down/kernel",
    "*/moe/shared/gate/kernel",
    "*/moe/shared/up/kernel",
    "*/moe/shared/down/kernel",
    # recsys / onerec dense compute
    "*/tower/*/kernel",
    "*/interaction_mlp/*/kernel",
    "*/score_mlp/*/kernel",
)

# The MoE grouped GEMM: stacked per-expert kernels, block-wise 1x128 / 128x128.
DEFAULT_BLOCK_PATTERNS: Tuple[str, ...] = (
    "*/moe/experts/gate",
    "*/moe/experts/up",
    "*/moe/experts/down",
)

# Never quantized (paper: "other numerically sensitive or less compute-
# dominant components remain in their original precision").
DEFAULT_EXCLUDE_PATTERNS: Tuple[str, ...] = (
    "*embed*",
    "*norm*",
    "*/moe/router/*",
    "*lm_head*",
    "*bias*",
    "*scale*",
    "*/rotary/*",
    "*augru*",       # DIEN recurrence: recurrent error accumulation
    "*/coord_mlp/*",  # EGNN equivariant coordinate path
)


# Decisions an override (and therefore ``classify``) may produce.  "skip"
# pins a group to high precision; "linear"/"block" are the paper's fp8
# schemes; "int8" is the beyond-paper per-channel W8A8 frontier.
OVERRIDE_DECISIONS = ("skip", "linear", "block", "int8")

# Artifact / serialization schema version (bump on breaking changes).
POLICY_VERSION = 1


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Declarative FP8 PTQ policy (+ per-group tuner overrides)."""

    enabled: bool = True
    fmt: str = "e4m3"                      # storage format
    weight_granularity: str = "per_channel"
    act_granularity: str = "per_token"     # dynamic, runtime amax (paper)
    block: int = 128                       # MoE block granularity
    linear_patterns: Tuple[str, ...] = DEFAULT_LINEAR_PATTERNS
    block_patterns: Tuple[str, ...] = DEFAULT_BLOCK_PATTERNS
    exclude_patterns: Tuple[str, ...] = DEFAULT_EXCLUDE_PATTERNS
    # Minimum dims for block quantization to engage (both of the last two
    # dims must be multiples of ``block``); linears fall back to per-channel.
    min_dim: int = 2
    # Ordered (pattern, decision) pairs consulted BEFORE the default
    # pattern lists (first match wins; decisions in OVERRIDE_DECISIONS).
    # Overrides beat exclude_patterns — that is how the auto-tuner expands
    # coverage onto default-excluded groups (e.g. the logits head) — but
    # never engage below ``min_dim`` dims.
    overrides: Tuple[Tuple[str, str], ...] = ()
    # Static (calibrated) activation scales instead of the paper's runtime
    # per-token amax.  The scales themselves are VALUES, not config: they
    # ride in the policy artifact (``act_scales``) and are attached to the
    # quantized leaves by ``repro.core.ptq.apply_static_act_scales``.
    static_acts: bool = False

    def __post_init__(self):
        for pat, decision in self.overrides:
            if decision not in OVERRIDE_DECISIONS:
                raise ValueError(
                    f"override {pat!r}: unknown decision {decision!r} "
                    f"(one of {OVERRIDE_DECISIONS})")

    def match(self, path: str, ndim: int, shape: Sequence[int]
              ) -> Tuple[Optional[str], Optional[str]]:
        """``(kind, deciding pattern)`` for a param path.

        ``kind`` is ``'linear' | 'block' | 'int8' | None``; ``pattern`` is
        the glob that decided it (an override pattern, a block/linear
        pattern, or the exclude pattern / None for unquantized leaves).
        The pattern is the tuner's GROUP key: every leaf a pattern decides
        moves together when the tuner overrides that pattern.
        """
        if not self.enabled or ndim < self.min_dim:
            return None, None
        for pat, decision in self.overrides:
            if fnmatch.fnmatch(path, pat):
                if decision == "skip":
                    return None, pat
                if decision == "block" and (
                        ndim < 2 or shape[-1] % self.block
                        or shape[-2] % self.block):
                    return "linear", pat   # degrade like the default path
                return decision, pat
        for pat in self.exclude_patterns:
            if fnmatch.fnmatch(path, pat):
                return None, pat
        for pat in self.block_patterns:
            if fnmatch.fnmatch(path, pat):
                if shape[-1] % self.block == 0 and shape[-2] % self.block == 0:
                    return "block", pat
                return "linear", pat  # paper granularity needs alignment
        for pat in self.linear_patterns:
            if fnmatch.fnmatch(path, pat):
                return "linear", pat
        return None, None

    def classify(self, path: str, ndim: int,
                 shape: Sequence[int]) -> Optional[str]:
        """Return 'linear' | 'block' | 'int8' | None for a param path."""
        return self.match(path, ndim, shape)[0]

    def replace(self, **kw) -> "QuantPolicy":
        return dataclasses.replace(self, **kw)

    def override(self, pattern: str, decision: str) -> "QuantPolicy":
        """A new policy with ``(pattern, decision)`` PREPENDED (it wins
        over existing overrides for the paths it matches)."""
        return self.replace(overrides=((pattern, decision),) + self.overrides)

    # -- serialization -------------------------------------------------------

    def to_json_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["overrides"] = [list(o) for o in self.overrides]
        d["version"] = POLICY_VERSION
        return d

    @classmethod
    def from_json_dict(cls, d: Mapping[str, Any]) -> "QuantPolicy":
        version = d.get("version", POLICY_VERSION)
        if version > POLICY_VERSION:
            raise ValueError(
                f"policy version {version} is newer than this code "
                f"understands ({POLICY_VERSION})")
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        for key in ("linear_patterns", "block_patterns", "exclude_patterns"):
            if key in kw:
                kw[key] = tuple(kw[key])
        if "overrides" in kw:
            kw["overrides"] = tuple((str(p), str(dec))
                                    for p, dec in kw["overrides"])
        return cls(**kw)


def save_policy_artifact(path: str, policy: QuantPolicy, *,
                         config: str = "",
                         target_overlap: Optional[float] = None,
                         measured: Optional[Mapping[str, Any]] = None,
                         groups: Optional[Sequence[Mapping[str, Any]]] = None,
                         trace: Optional[Sequence[Mapping[str, Any]]] = None,
                         uniform: Optional[Mapping[str, Any]] = None,
                         act_scales: Optional[Mapping[str, float]] = None,
                         ) -> Dict[str, Any]:
    """Write a versioned tuner artifact JSON and return the dict written.

    Schema (version ``POLICY_VERSION``)::

        {version, config, policy: {<QuantPolicy json>},
         target_overlap, measured: {overlap, bytes_quantized, ...},
         groups:  [{pattern, decision, rel_err, bytes, n_leaves, ...}],
         trace:   [{step, action, group, overlap, bytes_quantized, accepted}],
         uniform: {overlap, bytes_quantized},   # PAPER_POLICY reference point
         act_scales: {param_path: float scale}} # when policy.static_acts

    ``act_scales`` are plain floats so the artifact stays jax-free.
    """
    artifact: Dict[str, Any] = {
        "version": POLICY_VERSION,
        "config": config,
        "policy": policy.to_json_dict(),
        "target_overlap": target_overlap,
        "measured": dict(measured) if measured else {},
        "groups": [dict(g) for g in (groups or ())],
        "trace": [dict(t) for t in (trace or ())],
        "uniform": dict(uniform) if uniform else {},
        "act_scales": {k: float(v) for k, v in (act_scales or {}).items()},
    }
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    return artifact


def load_policy_artifact(path: str) -> Dict[str, Any]:
    """Load an artifact written by :func:`save_policy_artifact`.

    Returns the raw dict with ``artifact["policy"]`` replaced by a
    reconstructed :class:`QuantPolicy` instance.
    """
    with open(path) as f:
        artifact = json.load(f)
    version = artifact.get("version", 0)
    if version > POLICY_VERSION:
        raise ValueError(
            f"{path}: artifact version {version} is newer than this code "
            f"understands ({POLICY_VERSION})")
    artifact["policy"] = QuantPolicy.from_json_dict(artifact["policy"])
    artifact.setdefault("act_scales", {})
    return artifact


# Paper-faithful default: FP8 e4m3, per-channel W / per-token A on Linears,
# 1x128 / 128x128 blocks on MoE grouped GEMM.
PAPER_POLICY = QuantPolicy()

# Everything in high precision — the FP16/BF16 baseline system.
BASELINE_POLICY = QuantPolicy(enabled=False)
