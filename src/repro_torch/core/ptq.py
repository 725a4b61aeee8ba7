"""Post-training quantization pass over the port's param tree.

``quantize_params`` replaces every policy-matched leaf with a
``QuantizedTensor`` of ``(fp8 or int8 data, f32 scale)``, exactly as
``repro.core.ptq.quantize_params`` does: block-matched leaves get
``128 x 128`` block scales, linear-matched leaves per-channel scales over
the contraction axis, int8 leaves (the policy's ``fmt="int8"`` or an
``"int8"`` override) symmetric per-channel int8.  Payloads and scales are
bit-identical to the JAX package's, and every leaf is tagged with its path.
Per-channel and block payloads are laid out K-major (the transpose view of
a contiguous ``(..., out, in)`` array, ``quant.k_major``): the bytes move
once here, so the kernels and ``torch._int_mm`` never transpose a weight
per call.

Static activation scales (beyond the paper's dynamic scheme):
``calibrate_static_act_scales`` runs a forward with
``quant.capture_act_amax`` and returns ``{param path: scale}`` (a stacked
leaf's layers fold into its one path, as in the JAX package), which a
policy artifact carries (``core.policy.save_policy_artifact``) and
``apply_static_act_scales`` attaches to the per-channel fp8 leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core import quant
from repro_torch.core.policy import PAPER_POLICY, QuantPolicy
from repro_torch.core.quant import QuantizedTensor


@dataclasses.dataclass
class PTQReport:
    """What got quantized, how well, and what it saved."""

    entries: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def add(self, path: str, kind: str, shape, rel_err: float,
            bytes_before: int, bytes_after: int, *,
            granularity: Optional[str] = None,
            pattern: Optional[str] = None) -> None:
        """``kind`` is the scheme actually applied ('linear'|'block'|'int8'),
        ``granularity`` the produced ``QuantizedTensor.granularity``, and
        ``pattern`` the policy glob that decided this leaf (the tuner's
        group key)."""
        self.entries.append(dict(path=path, kind=kind, shape=tuple(shape),
                                 rel_err=float(rel_err),
                                 bytes_before=bytes_before,
                                 bytes_after=bytes_after,
                                 granularity=granularity,
                                 pattern=pattern))

    @property
    def n_quantized(self) -> int:
        return len(self.entries)

    @property
    def bytes_before(self) -> int:
        return sum(e["bytes_before"] for e in self.entries)

    @property
    def bytes_after(self) -> int:
        return sum(e["bytes_after"] for e in self.entries)

    @property
    def max_rel_err(self) -> float:
        return max((e["rel_err"] for e in self.entries), default=0.0)

    @property
    def mean_rel_err(self) -> float:
        if not self.entries:
            return 0.0
        return float(np.mean([e["rel_err"] for e in self.entries]))

    def summary(self) -> str:
        if not self.entries:
            return "PTQ: nothing quantized (policy disabled or no matches)"
        ratio = self.bytes_before / max(self.bytes_after, 1)
        return (f"PTQ: {self.n_quantized} tensors -> fp8 "
                f"({self.bytes_before / 1e6:.1f} MB -> "
                f"{self.bytes_after / 1e6:.1f} MB, {ratio:.2f}x), "
                f"rel_err mean={self.mean_rel_err:.2e} "
                f"max={self.max_rel_err:.2e}")


def quantize_params(params: Dict[str, Any],
                    policy: QuantPolicy = PAPER_POLICY, *,
                    with_report: bool = False,
                    compute_errors: bool = False, prefix: str = ""):
    """Apply the paper's PTQ scheme to a param tree.  Returns the quantized
    tree (and a ``PTQReport`` when ``with_report``); ``compute_errors``
    also measures each tensor's relative L2 quantization error.  ``prefix``
    is the path of ``params`` inside the whole tree (a layer made on its own
    by ``models.transformer.init_transformer``), so its leaves are matched
    and tagged by their whole-tree paths."""
    if policy.fmt == "int8":
        fmt = None                                  # symmetric int8 path
    else:
        fmt = quant.E4M3 if policy.fmt == "e4m3" else quant.E5M2
    report = PTQReport()

    def _maybe_quantize(path: str, leaf):
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            return leaf
        kind, pattern = policy.match(path, leaf.ndim, tuple(leaf.shape))
        if kind is None:
            return leaf
        if fmt is None or kind == "int8":
            # per-channel int8 everywhere, the scheme reported as applied
            q = quant.quantize_per_channel_int8(leaf, contract_axis=-2)
            applied = "int8"
        elif kind == "block":
            q = quant.quantize_blockwise(leaf, block=policy.block, fmt=fmt)
            applied = "block"
        else:
            q = quant.quantize_per_channel(leaf, contract_axis=-2, fmt=fmt)
            applied = "linear"
        q.tag = path
        if with_report:
            err = float(quant.quant_error(leaf, q)) if compute_errors \
                else float("nan")
            report.add(path, applied, tuple(leaf.shape), err,
                       bytes_before=leaf.numel() * leaf.element_size(),
                       bytes_after=q.nbytes(), granularity=q.granularity,
                       pattern=pattern)
        return q

    quantized = tree.map_with_path(_maybe_quantize, params, prefix)
    if with_report:
        return quantized, report
    return quantized


def dequantize_params(params: Dict[str, Any],
                      dtype=torch.bfloat16) -> Dict[str, Any]:
    """Inverse transform (for reload / requantization workflows)."""
    return tree.map_with_path(
        lambda _, leaf: leaf.dequantize(dtype)
        if isinstance(leaf, QuantizedTensor) else leaf, params)


# ---------------------------------------------------------------------------
# Static activation calibration (beyond the paper's dynamic scheme)
# ---------------------------------------------------------------------------


def calibrate_activation_scales(
    apply_fn: Callable[..., Tuple[Any, Dict[str, torch.Tensor]]],
    params: Any,
    batches,
    *,
    momentum: float = 0.9,
) -> Dict[str, torch.Tensor]:
    """EMA-of-amax calibration over sample batches: ``apply_fn(params,
    batch)`` returns ``(out, taps)``, ``taps`` mapping activation names to
    tensors.  Returns ``{name: scale}`` (f32 tensors)."""
    ema: Dict[str, torch.Tensor] = {}
    for batch in batches:
        _, taps = apply_fn(params, batch)
        for name, act in taps.items():
            amax = act.to(torch.float32).abs().max()
            if name in ema:
                ema[name] = momentum * ema[name] + (1 - momentum) * amax
            else:
                ema[name] = amax
    return {k: quant.amax_to_scale(v) for k, v in ema.items()}


def calibrate_static_act_scales(
    forward_fn: Callable[[Any, Any], Any],
    qparams: Any,
    batches,
    *,
    fmt=None,
) -> Dict[str, float]:
    """Max-of-amax static activation calibration keyed by param path:
    ``forward_fn(qparams, batch)`` runs under ``quant.capture_act_amax``,
    every fp8 linear folding ``max|x|`` into its weight's tag (the path
    ``quantize_params`` set).  Returns plain-float scales, ready to ride in
    a policy artifact and be attached by ``apply_static_act_scales``."""
    fmt = fmt or quant.E4M3
    amax: Dict[str, float] = {}
    for batch in batches:
        with quant.capture_act_amax() as cap:
            forward_fn(qparams, batch)
        for k, v in cap.items():
            if v > amax.get(k, 0.0):
                amax[k] = v
    return {k: float(quant.amax_to_scale(v, fmt)) for k, v in amax.items()}


def apply_static_act_scales(qparams: Dict[str, Any],
                            scales: Mapping[str, float]) -> Dict[str, Any]:
    """Attach calibrated static activation scales to quantized leaves.

    Only per-channel / per-tensor fp8 leaves consume a static scale (the
    static path of ``fp8_linear``); block and int8 leaves keep the dynamic
    scheme and are left untouched, as are leaves with no calibrated scale.
    The scale is shaped ``(*data.shape[:-2], 1, 1)`` on the leaf's device,
    so a stacked leaf's layer slice holds one value."""

    def _attach(_, leaf):
        if not isinstance(leaf, QuantizedTensor):
            return leaf
        if leaf.granularity not in ("per_channel", "per_tensor"):
            return leaf
        if leaf.data.dtype == torch.int8 or leaf.tag not in scales:
            return leaf
        act_scale = torch.full((*leaf.data.shape[:-2], 1, 1),
                               scales[leaf.tag], dtype=torch.float32,
                               device=leaf.data.device)
        return dataclasses.replace(leaf, act_scale=act_scale)

    return tree.map_with_path(_attach, qparams)
