"""Distribution analysis of weights and activations (paper §3.2, Fig. 1),
the JAX package's ``repro/core/stats.py`` in PyTorch.

The paper's feasibility argument rests on measuring variance, AbsMax and
AbsP99 across all tensors of a model and comparing model families:
classical ranking models (mean weight variance ~1e7) against OneRec-V2 and
LLMs (mean weight variance < 0.1).  The report's types, text formats and
thresholds are the JAX package's.

The statistics are computed on the tensor's own device, so a full-width
param tree is never copied to the host, with numpy's definitions: the
population variance (ddof 0, summed here in float64 in slices of
``CHUNK`` elements) and ``np.percentile``'s "linear" rule, which
interpolates between the order statistics ``floor(0.99 (n - 1))`` and the
next.  The two order statistics are the two smallest of one ``torch.topk``
of the largest ``n - floor`` values, a radix select spread over the whole
card, where ``torch.kthvalue`` runs one thread block a slice (seconds for
a stacked expert leaf of OneRec-V2, 1.6e9 elements) and ``torch.quantile``
refuses more than 2^24 elements.

Activation taps: models call ``tap(name, x)`` at the JAX package's points;
inside a ``capture_taps()`` block each call records ``x`` (repeated names
get ``.1``, ``.2``, ...), outside it a tap is one ``None`` check.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch

from repro_torch import tree
from repro_torch.core.quant import QuantizedTensor

CHUNK = 1 << 26      # elements a slice of the float64 variance sums


@dataclasses.dataclass
class TensorStats:
    name: str
    variance: float
    absmax: float
    absp99: float
    numel: int

    def row(self) -> str:
        return (f"{self.name:60s} var={self.variance:12.4e} "
                f"absmax={self.absmax:12.4e} absp99={self.absp99:12.4e}")


def _variance(xf: torch.Tensor) -> float:
    """Population variance of flat f32 ``xf``, summed in float64 a slice
    at a time (two passes: the mean, then the squared deviations)."""
    n = xf.numel()
    mean = sum(c.double().sum() for c in xf.split(CHUNK)) / n
    return float(sum((c.double() - mean).square().sum()
                     for c in xf.split(CHUNK)) / n)


def _percentile(ax: torch.Tensor, q: float) -> float:
    """``np.percentile(ax, q)`` of flat non-negative f32 ``ax``: numpy's
    "linear" rule in its float32 arithmetic (the virtual index ``q / 100 *
    (n - 1)``, its fraction and the interpolation all in f32, as numpy
    computes them for an f32 array), between the order statistics at the
    index's floor and the next one."""
    n = ax.numel()
    v = np.asanyarray((n - 1) * np.asanyarray(np.true_divide(
        q, np.float32(100))))
    lo = n - 1 if v >= n - 1 else int(np.floor(v))
    gamma = np.asanyarray(v - np.floor(v))
    top = torch.topk(ax, n - lo, sorted=False).values
    two = torch.topk(top, min(2, top.numel()), largest=False,
                     sorted=True).values.cpu().numpy()
    a, b = two[0], two[-1]
    diff = np.subtract(b, a)
    if gamma >= 0.5:
        return float(np.subtract(b, diff * (1 - gamma)))
    return float(np.add(a, diff * gamma))


def tensor_stats(name: str, x: torch.Tensor) -> TensorStats:
    """Variance, AbsMax and AbsP99 of ``x`` as f32, on ``x``'s device."""
    xf = x.detach().to(torch.float32).reshape(-1)
    if xf.numel() == 0:
        return TensorStats(name, 0.0, 0.0, 0.0, 0)
    ax = xf.abs()
    return TensorStats(name=name, variance=_variance(xf),
                       absmax=float(ax.max()),
                       absp99=_percentile(ax, 99.0), numel=xf.numel())


@dataclasses.dataclass
class DistributionReport:
    """Mean variance / AbsMax / AbsP99 across all tensors (Fig. 1 metrics)."""

    family: str
    kind: str  # "weights" | "activations"
    per_tensor: List[TensorStats]

    @property
    def mean_variance(self) -> float:
        return float(np.mean([t.variance for t in self.per_tensor])) \
            if self.per_tensor else 0.0

    @property
    def mean_absmax(self) -> float:
        return float(np.mean([t.absmax for t in self.per_tensor])) \
            if self.per_tensor else 0.0

    @property
    def mean_absp99(self) -> float:
        return float(np.mean([t.absp99 for t in self.per_tensor])) \
            if self.per_tensor else 0.0

    def summary(self) -> str:
        return (f"[{self.family}:{self.kind}] n={len(self.per_tensor)} "
                f"mean_var={self.mean_variance:.4e} "
                f"mean_absmax={self.mean_absmax:.4e} "
                f"mean_absp99={self.mean_absp99:.4e}")

    def csv_rows(self) -> List[str]:
        return [
            f"{self.family},{self.kind},mean_variance,{self.mean_variance:.6e}",
            f"{self.family},{self.kind},mean_absmax,{self.mean_absmax:.6e}",
            f"{self.family},{self.kind},mean_absp99,{self.mean_absp99:.6e}",
        ]


def collect_weight_stats(params: Dict[str, Any], family: str = "model",
                         min_numel: int = 1) -> DistributionReport:
    """Fig.-1 weight statistics over every floating leaf of a param tree
    (``QuantizedTensor`` leaves dequantized), one leaf at a time, in the
    JAX package's order (dict keys sorted at every level)."""
    rows: List[TensorStats] = []
    for path, leaf in sorted(tree.leaves_with_path(params),
                             key=lambda pl: pl[0].split("/")):
        if isinstance(leaf, QuantizedTensor):
            leaf = leaf.dequantize()
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            continue
        if leaf.numel() < min_numel:
            continue
        rows.append(tensor_stats(path, leaf))
    return DistributionReport(family, "weights", rows)


def collect_activation_stats(taps: Mapping[str, torch.Tensor],
                             family: str = "model") -> DistributionReport:
    """Fig.-1 activation statistics over a dict of captured activations."""
    rows = [tensor_stats(k, v) for k, v in sorted(taps.items())]
    return DistributionReport(family, "activations", rows)


_TAPS: Optional[Dict[str, torch.Tensor]] = None


def tap(name: str, x) -> None:
    """Record ``x`` under ``name`` while a ``capture_taps()`` block is
    open (no copy: the tensor itself).  ``x`` may be a function of no
    arguments that makes the tensor: it runs only inside such a block."""
    if _TAPS is None:
        return
    if callable(x):
        x = x()
    base, i = name, 0
    while name in _TAPS:
        i += 1
        name = f"{base}.{i}"
    _TAPS[name] = x


@contextlib.contextmanager
def capture_taps() -> Iterator[Dict[str, torch.Tensor]]:
    """Collect every ``tap`` made inside the block into the yielded dict;
    the enclosing capture, if any, is restored on exit."""
    global _TAPS
    prev = _TAPS
    _TAPS = {}
    try:
        yield _TAPS
    finally:
        _TAPS = prev


def feasibility_verdict(report: DistributionReport,
                        var_threshold: float = 10.0,
                        absmax_threshold: float = 100.0) -> str:
    """The paper's qualitative read: controlled statistics => fp8-friendly."""
    ok = (report.mean_variance < var_threshold
          and report.mean_absmax < absmax_threshold)
    return "fp8-friendly" if ok else "fp8-risky (wide dynamic range)"
