"""FP8 quantization primitives (the paper's §4.1 scheme), in PyTorch.

The same numerics as ``repro.core.quant``:

  * Linear layers: per-CHANNEL weight scales (offline) x per-TOKEN dynamic
    activation scales (runtime amax over the feature dim), fp8 x fp8
    products with f32 accumulation, cast back to the compute dtype.
  * MoE grouped GEMM: BLOCK-wise scales, activations ``1 x 128`` along the
    reduction dim, weights ``128 x 128``.
  * Quantized weights are ``(fp8 data, f32 scale)`` pairs.

The fp8 products run through the port's kernels (``repro_torch.kernels``):
on a CUDA tensor the hand-written Hopper kernel, on a CPU tensor its plain
PyTorch version.  One difference from the JAX package is deliberate: the
block-scaled expert product follows the Pallas kernel ``fp8_grouped_gemm``
(each 128-deep partial scaled by ``s_x * s_w`` and accumulated in f32), not
the JAX XLA path that folds the block scales into bf16 operands before one
dot (``repro/core/quant.py`` ``fp8_grouped_matmul``).  The two agree to bf16
rounding of the folded operands.

Casts are bit-identical to the JAX package: divide by the scale (a true
division, never a multiply by the reciprocal), clip into the finite e4m3
range (e4m3fn has no inf; an unclipped cast gives NaN), round to nearest.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.fp8_gemm import ops as fp8_gemm_ops
from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops

E4M3 = torch.float8_e4m3fn
E5M2 = torch.float8_e5m2
FP8_MAX = {E4M3: 448.0, E5M2: 57344.0}

DEFAULT_BLOCK = 128  # the paper's 1x128 / 128x128 block granularity
_EPS = 1e-12


@dataclasses.dataclass
class QuantizedTensor:
    """An fp8 tensor plus its f32 scale(s).

    ``granularity``: ``per_tensor`` (scale ``()``), ``per_channel`` (scale
    broadcastable against ``data`` along the output-channel axis),
    ``per_token`` (scale ``(..., 1)``), ``block`` (weights, one scale per
    ``block x block`` tile of the last two dims) or ``block_act``
    (activations, one scale per ``1 x block`` tile of the last dim).
    ``tag`` names the param path the weight came from.

    Indexing (``q[i]``) slices the leading axis of data and scale together:
    the per-layer view of a stacked leaf.
    """

    data: torch.Tensor
    scale: torch.Tensor
    granularity: str = "per_channel"
    block: int = DEFAULT_BLOCK
    tag: Optional[str] = None

    def __getitem__(self, i) -> "QuantizedTensor":
        return dataclasses.replace(self, data=self.data[i],
                                   scale=self.scale[i])


def is_fp8_dtype(dtype) -> bool:
    return dtype in FP8_MAX


# ---------------------------------------------------------------------------
# Scale computation + casting
# ---------------------------------------------------------------------------


def amax_to_scale(amax, fmt=E4M3) -> torch.Tensor:
    """scale s.t. x/s fits the fp8 grid: s = max(amax, eps) / fp8_max.

    The divisor is a device tensor, not a Python number: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which is one
    ulp off the true quotient for some amax and flips e4m3 roundings."""
    amax = torch.as_tensor(amax, dtype=torch.float32)
    fmax = torch.full((), FP8_MAX[fmt], dtype=torch.float32,
                      device=amax.device)
    return torch.clamp(amax, min=_EPS) / fmax


def cast_to_fp8(x: torch.Tensor, scale: torch.Tensor,
                fmt=E4M3) -> torch.Tensor:
    """Divide by scale, clamp into the finite fp8 range, round-to-nearest."""
    fmax = FP8_MAX[fmt]
    y = x.to(torch.float32) / scale
    return y.clamp_(-fmax, fmax).to(fmt)


def _amax(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    return torch.amax(x.to(torch.float32).abs(), dim=dim, keepdim=keepdim)


def quantize_per_channel(w: torch.Tensor, contract_axis: int = -2,
                         fmt=E4M3) -> QuantizedTensor:
    """Offline weight quantization, one scale per output channel; reduces
    only over the contraction axis, so a stacked ``(L, in, out)`` kernel
    gets independent ``(L, 1, out)`` scales per layer."""
    scale = amax_to_scale(_amax(w, contract_axis, keepdim=True), fmt)
    return QuantizedTensor(cast_to_fp8(w, scale, fmt), scale, "per_channel")


def quantize_per_token(x: torch.Tensor, fmt=E4M3) -> QuantizedTensor:
    """Runtime dynamic activation quantization: one scale per row/token."""
    scale = amax_to_scale(_amax(x, -1, keepdim=True), fmt)
    return QuantizedTensor(cast_to_fp8(x, scale, fmt), scale, "per_token")


def quantize_blockwise(w: torch.Tensor, block: int = DEFAULT_BLOCK,
                       fmt=E4M3, act: bool = False) -> QuantizedTensor:
    """Block-wise quantization.  ``act=False``: ``block x block`` tiles over
    the last two dims, scale ``(..., in/b, out/b)``.  ``act=True``:
    ``1 x block`` tiles along the last dim, scale ``(..., tokens, in/b)``."""
    if act:
        if w.shape[-1] % block:
            raise ValueError(f"act dim {w.shape[-1]} not a multiple of "
                             f"{block}")
        nb = w.shape[-1] // block
        xb = w.reshape(*w.shape[:-1], nb, block)
        scale = amax_to_scale(_amax(xb, -1), fmt)                 # (..., nb)
        q = cast_to_fp8(xb, scale[..., None], fmt).reshape(w.shape)
        return QuantizedTensor(q, scale, "block_act", block)
    if w.ndim < 2:
        raise ValueError("block weight quantization needs >=2 dims")
    if w.shape[-1] % block or w.shape[-2] % block:
        raise ValueError(f"weight dims {tuple(w.shape[-2:])} not multiples "
                         f"of {block}")
    bi, bo = w.shape[-2] // block, w.shape[-1] // block
    xb = w.reshape(*w.shape[:-2], bi, block, bo, block)
    scale = amax_to_scale(_amax(xb, (-3, -1)), fmt)               # (.., bi, bo)
    q = cast_to_fp8(xb, scale[..., :, None, :, None], fmt).reshape(w.shape)
    return QuantizedTensor(q, scale, "block", block)


def quantize_kv(x: torch.Tensor, fmt=E4M3
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KV-cache quantization, one dynamic scale per (position, head): the
    amax reduces over head_dim only.  Returns ``(fp8 data, f32 scale)``
    with ``scale.shape == x.shape[:-1]``."""
    scale = amax_to_scale(_amax(x, -1), fmt)
    return cast_to_fp8(x, scale[..., None], fmt), scale


def dequantize_kv(data: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of ``quantize_kv``: f32 payload x scale, cast to ``dtype``."""
    return (data.to(torch.float32) * scale[..., None]).to(dtype)


# ---------------------------------------------------------------------------
# FP8 matmuls (through the port's kernels)
# ---------------------------------------------------------------------------


def fp8_linear(x: torch.Tensor, wq: QuantizedTensor, *,
               out_dtype=None) -> torch.Tensor:
    """The paper's Linear-layer FP8 path (dynamic per-token mode): per-row
    activation quant, fp8 x fp8 dot with f32 accumulation, rescale by
    (act scale x channel scale), cast.  ``wq`` is one ``(in, out)`` kernel
    (a layer slice), per-channel over the output axis.  Runs as kernel
    ``fp8_gemm``."""
    if wq.granularity not in ("per_channel", "per_tensor"):
        raise ValueError(f"fp8_linear needs per_channel/per_tensor weights, "
                         f"got {wq.granularity}")
    if wq.data.ndim != 2:
        raise ValueError(f"fp8_linear takes one (in, out) kernel, got shape "
                         f"{tuple(wq.data.shape)}")
    k, n = wq.data.shape
    sw = wq.scale.reshape(1, -1).expand(1, n).contiguous()
    lead = x.shape[:-1]
    out = fp8_gemm_ops.fp8_gemm(x.reshape(1, -1, k), wq.data.unsqueeze(0),
                                sw, out_dtype=out_dtype or x.dtype)
    return out.reshape(*lead, n)


def fp8_grouped_linear(x: torch.Tensor, wq: QuantizedTensor, *,
                       out_dtype=None) -> torch.Tensor:
    """Grouped GEMM with per-channel weight scales (the non-128-aligned
    fallback): x (E, C, K) @ wq (E, K, N), scale (E, 1, N).  Kernel
    ``fp8_gemm`` with its leading batch dim."""
    e, _, n = wq.data.shape
    sw = wq.scale.reshape(e, -1).expand(e, n).contiguous()
    return fp8_gemm_ops.fp8_gemm(x, wq.data, sw,
                                 out_dtype=out_dtype or x.dtype)


def fp8_grouped_matmul(x: torch.Tensor, wq: QuantizedTensor, *,
                       out_dtype=None) -> torch.Tensor:
    """Block-scaled grouped GEMM x (E, C, K) @ wq (E, K, N): kernel
    ``fp8_grouped_gemm`` (exact per-block-partial accumulation)."""
    if wq.granularity != "block" or wq.block != grouped_ops.B:
        raise ValueError("fp8_grouped_matmul needs 128-block weights")
    return grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale,
                                        out_dtype=out_dtype or x.dtype)


def matmul_any(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """``x @ w`` where ``w`` is a raw tensor OR a QuantizedTensor; the one
    dispatch point the layers funnel through.  A raw weight is cast to the
    activation dtype and the product accumulates in f32 (computed as an
    f32 product of the bf16-valued operands, so an f32 ``out_dtype`` gets
    the unrounded sum, as ``jnp.dot(..., preferred_element_type=f32)``)."""
    out_dtype = out_dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        return fp8_linear(x, w, out_dtype=out_dtype)
    out = torch.matmul(x.to(torch.float32),
                       w.to(x.dtype).to(torch.float32))
    return out.to(out_dtype)
