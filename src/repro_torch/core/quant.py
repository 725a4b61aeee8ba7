"""FP8 and INT8 quantization primitives (the paper's §4.1 scheme), in
PyTorch.

The same numerics as ``repro.core.quant``:

  * Linear layers: per-CHANNEL weight scales (offline) x per-TOKEN dynamic
    activation scales (runtime amax over the feature dim), or one STATIC
    calibrated activation scale carried on the weight (``act_scale``, from
    ``core.ptq.apply_static_act_scales``); fp8 x fp8 products summed in f32,
    cast back to the compute dtype.
  * MoE grouped GEMM, and dense weights a policy marks ``"block"``:
    BLOCK-wise scales, activations ``1 x 128`` along the reduction dim,
    weights ``128 x 128``.
  * INT8 W8A8 (beyond the paper): symmetric per-channel int8 weights x
    per-token int8 activations, exact int32 sums.
  * Quantized weights are ``(fp8 or int8 data, f32 scale)`` pairs.

The fp8 products run through the port's kernels (``repro_torch.kernels``):
on a CUDA tensor the hand-written Hopper kernel, on a CPU tensor its plain
PyTorch version; both sum the exact products of the e4m3 values in f32, as
the Pallas kernels do.  The int8 products, which the JAX package leaves to
an XLA int32 ``dot`` outside any Pallas kernel, are ``torch._int_mm``
(cuBLAS) on the card and an exact product on the CPU: the int32 sums are
exact either way.  One difference from the JAX package is deliberate: the
block-scaled products follow the Pallas kernel ``fp8_grouped_gemm`` (each
128-deep partial scaled by ``s_x * s_w`` and accumulated in f32), not the
JAX XLA path that folds the block scales into bf16 operands before one dot
(``repro/core/quant.py`` ``fp8_grouped_matmul``, ``fp8_block_matmul``).
The two agree to bf16 rounding of the folded operands.

Casts are bit-identical to the JAX package: divide by the scale (a true
division, never a multiply by the reciprocal), clip into the finite e4m3
range (e4m3fn has no inf; an unclipped cast gives NaN), round to nearest.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import tree
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
    ``act_scale`` (optional) is a calibrated static activation scale for
    the product that consumes this weight, shaped ``(*data.shape[:-2], 1,
    1)``: ``fp8_linear`` casts its input with it instead of reducing the
    per-token amax.  ``tag`` names the param path the weight came from; it
    keys activation-amax capture during calibration.

    Indexing (``q[i]``) slices the leading axis of data, scale and
    act_scale together, keeping the tag: the per-layer view of a stacked
    leaf.
    """

    data: torch.Tensor
    scale: torch.Tensor
    granularity: str = "per_channel"
    block: int = DEFAULT_BLOCK
    act_scale: Optional[torch.Tensor] = None
    tag: Optional[str] = None

    def __getitem__(self, i) -> "QuantizedTensor":
        return dataclasses.replace(
            self, data=self.data[i], scale=self.scale[i],
            act_scale=None if self.act_scale is None else self.act_scale[i])

    def map_parts(self, fn) -> "QuantizedTensor":
        """``fn`` applied to data, scale and act_scale (when set)."""
        return dataclasses.replace(
            self, data=fn(self.data), scale=fn(self.scale),
            act_scale=None if self.act_scale is None else fn(self.act_scale))

    def to(self, device) -> "QuantizedTensor":
        """The same tensor on ``device``, each part keeping its memory
        layout (``Tensor.to`` would lay a K-major payload out row-major,
        which the kernels refuse): a quantized tree made or loaded on one
        device serves on another."""
        device = torch.device(device)

        def move(t):
            if t.device.type == device.type and device.index in (
                    None, t.device.index):
                return t
            return tree.empty_like(t, device=device).copy_(t)
        return self.map_parts(move)

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        if self.granularity in ("block", "block_act"):
            return _dequantize_block(self, dtype)
        return (self.data.to(torch.float32) * self.scale).to(dtype)

    def nbytes(self) -> int:
        n = self.data.numel() * self.data.element_size() \
            + 4 * self.scale.numel()
        if self.act_scale is not None:
            n += 4 * self.act_scale.numel()
        return n


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


K_ALIGN = 16     # bytes (e4m3 / int8 elements) a K-major payload row spans


def k_major(t: torch.Tensor, contract_axis: int = -2) -> torch.Tensor:
    """The same values and shape, laid out with the contraction axis
    innermost in memory: an ``(..., in, out)`` kernel becomes the transpose
    view of a contiguous ``(..., out, K16)`` array (``stride(-2) == 1``),
    ``K16`` the contraction length rounded up to a multiple of ``K_ALIGN``
    with a zero tail past it: TMA copies rows at 16-byte strides, so a
    kernel of any K (DIN's 180) has rows the kernels can read."""
    moved = t.movedim(contract_axis, -1)
    k = moved.shape[-1]
    k16 = -(-k // K_ALIGN) * K_ALIGN
    # a fresh allocation, not ``contiguous()``: that keeps a view whose
    # size-1 axes (one output channel) have strides TMA refuses
    base = (moved.new_empty if k16 == k else moved.new_zeros)(
        (*moved.shape[:-1], k16))
    base[..., :k] = moved
    return base[..., :k].movedim(-1, contract_axis)


def quantize_per_channel(w: torch.Tensor, contract_axis: int = -2,
                         fmt=E4M3) -> QuantizedTensor:
    """Offline weight quantization, one scale per output channel; reduces
    only over the contraction axis, so a stacked ``(L, in, out)`` kernel
    gets independent ``(L, 1, out)`` scales per layer.  The payload is laid
    out K-major (``k_major``, rows padded to 16 bytes), the layout kernel
    ``fp8_gemm`` reads; its shape and values are those of the row-major
    cast."""
    scale = amax_to_scale(_amax(w, contract_axis, keepdim=True), fmt)
    data = k_major(cast_to_fp8(w, scale, fmt), contract_axis)
    return QuantizedTensor(data, scale, "per_channel")


def quantize_per_token(x: torch.Tensor, fmt=E4M3) -> QuantizedTensor:
    """Runtime dynamic activation quantization: one scale per row/token."""
    scale = amax_to_scale(_amax(x, -1, keepdim=True), fmt)
    return QuantizedTensor(cast_to_fp8(x, scale, fmt), scale, "per_token")


def quantize_blockwise(w: torch.Tensor, block: int = DEFAULT_BLOCK,
                       fmt=E4M3, act: bool = False) -> QuantizedTensor:
    """Block-wise quantization.  ``act=False``: ``block x block`` tiles over
    the last two dims, scale ``(..., in/b, out/b)``; the payload is laid out
    K-major (``k_major``), the layout kernel ``fp8_grouped_gemm`` reads, with
    the shape and values of the row-major cast.  ``act=True``: ``1 x block``
    tiles along the last dim, scale ``(..., tokens, in/b)``."""
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
    return QuantizedTensor(k_major(q), scale, "block", block)


def _dequantize_block(q: QuantizedTensor,
                      dtype=torch.float32) -> torch.Tensor:
    b = q.block
    d = q.data.to(torch.float32)
    if q.granularity == "block_act":  # activation: 1 x block tiles
        nb = d.shape[-1] // b
        xb = d.reshape(*d.shape[:-1], nb, b) * q.scale[..., None]
        return xb.reshape(d.shape).to(dtype)
    bi, bo = d.shape[-2] // b, d.shape[-1] // b
    xb = d.reshape(*d.shape[:-2], bi, b, bo, b) \
        * q.scale[..., :, None, :, None]
    return xb.reshape(d.shape).to(dtype)


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
# Activation-amax capture (calibration only; a host read per product)
# ---------------------------------------------------------------------------

_ACT_AMAX: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def capture_act_amax():
    """Record the running max |activation| per consuming weight ``tag``.

    While active, every ``fp8_linear`` call on a tagged weight folds
    ``max|x|`` into the yielded ``{tag: amax}`` dict; every layer's slice of
    a stacked leaf folds into the leaf's one key.  Each record reads a host
    float, so this is for calibration, never the serving path."""
    global _ACT_AMAX
    prev = _ACT_AMAX
    _ACT_AMAX = {}
    try:
        yield _ACT_AMAX
    finally:
        _ACT_AMAX = prev


def _record_act_amax(tag: Optional[str], x: torch.Tensor) -> None:
    if _ACT_AMAX is None or tag is None:
        return
    amax = x.to(torch.float32).abs().max()
    # calibration only (capture_act_amax), never the serving path
    amax = float(amax)  # lint: allow[hidden-host-sync]
    if amax > _ACT_AMAX.get(tag, 0.0):
        _ACT_AMAX[tag] = amax


# ---------------------------------------------------------------------------
# FP8 matmuls (through the port's kernels)
# ---------------------------------------------------------------------------


def fp8_linear(x: torch.Tensor, wq: QuantizedTensor, *, out_dtype=None,
               act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's Linear-layer FP8 path: per-row activation quant (or,
    with a static scale passed as ``act_scale`` or carried on the weight,
    the cast with it: no runtime amax reduction), fp8 x fp8 dot with f32
    accumulation, rescale by (act scale x channel scale), cast.  ``wq`` is
    one ``(in, out)`` kernel (a layer slice), per-channel over the output
    axis.  Runs as kernel ``fp8_gemm`` (its static mode with a scale).
    ``DTensor`` operands run tensor parallel (``tp_matmul``)."""
    # imported here: the distributed package imports this module
    import repro_torch.distributed.sharding as sh
    if sh.is_dtensor(x) or sh.is_dtensor(wq.data):
        return tp_matmul(x, wq, out_dtype=out_dtype or x.dtype,
                         act_scale=act_scale)
    if wq.granularity not in ("per_channel", "per_tensor"):
        raise ValueError(f"fp8_linear needs per_channel/per_tensor weights, "
                         f"got {wq.granularity}")
    if wq.data.ndim != 2:
        raise ValueError(f"fp8_linear takes one (in, out) kernel, got shape "
                         f"{tuple(wq.data.shape)}")
    _record_act_amax(wq.tag, x)
    if act_scale is None:
        act_scale = wq.act_scale
    k, n = wq.data.shape
    sw = wq.scale.reshape(1, -1).expand(1, n).contiguous()
    lead = x.shape[:-1]
    out = fp8_gemm_ops.fp8_gemm(x.reshape(1, -1, k), wq.data.unsqueeze(0),
                                sw, out_dtype=out_dtype or x.dtype,
                                act_scale=act_scale)
    return out.reshape(*lead, n)


def fp8_block_matmul(x: torch.Tensor, wq: QuantizedTensor, *,
                     out_dtype=None) -> torch.Tensor:
    """A dense ``(in, out)`` weight with ``128 x 128`` block scales (a
    policy's ``"block"`` override) times x (..., in): 1 x 128 activation
    blocks, each 128-deep partial scaled by ``s_x * s_w`` and accumulated
    in f32.  Kernel ``fp8_grouped_gemm`` with one expert: the Pallas
    kernel's function, not the JAX XLA path's fold into bf16 operands (the
    deliberate departure in the module docstring)."""
    if wq.granularity != "block" or wq.block != grouped_ops.B:
        raise ValueError("fp8_block_matmul needs 128-block weights")
    if wq.data.ndim != 2:
        raise ValueError(f"fp8_block_matmul takes one (in, out) kernel, got "
                         f"shape {tuple(wq.data.shape)}")
    k, n = wq.data.shape
    lead = x.shape[:-1]
    out = grouped_ops.fp8_grouped_gemm(
        x.reshape(1, -1, k), wq.data.unsqueeze(0), wq.scale.unsqueeze(0),
        out_dtype=out_dtype or x.dtype)
    return out.reshape(*lead, n)


def fp8_grouped_matmul(x: torch.Tensor, wq: QuantizedTensor, *,
                       out_dtype=None) -> torch.Tensor:
    """Block-scaled grouped GEMM x (E, C, K) @ wq (E, K, N): kernel
    ``fp8_grouped_gemm`` (exact per-block-partial accumulation)."""
    if wq.granularity != "block" or wq.block != grouped_ops.B:
        raise ValueError("fp8_grouped_matmul needs 128-block weights")
    return grouped_ops.fp8_grouped_gemm(x, wq.data, wq.scale,
                                        out_dtype=out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# INT8 W8A8 (beyond the paper; the same scaling machinery, symmetric)
# ---------------------------------------------------------------------------

INT8_MAX = 127.0


def _amax_to_scale_int8(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, eps) / 127, divided by a device tensor (see
    ``amax_to_scale``)."""
    imax = torch.full((), INT8_MAX, dtype=torch.float32, device=amax.device)
    return torch.clamp(amax.to(torch.float32), min=_EPS) / imax


def cast_to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Divide by scale, round half to even, clip to +-127."""
    y = torch.round(x.to(torch.float32) / scale)
    return y.clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


def quantize_per_channel_int8(w: torch.Tensor,
                              contract_axis: int = -2) -> QuantizedTensor:
    """Symmetric per-output-channel int8 weights; the payload laid out
    K-major (``k_major``), the layout ``torch._int_mm`` reads as its
    column-major second operand."""
    scale = _amax_to_scale_int8(_amax(w, contract_axis, keepdim=True))
    data = k_major(cast_to_int8(w, scale), contract_axis)
    return QuantizedTensor(data, scale, "per_channel")


def quantize_per_token_int8(x: torch.Tensor) -> QuantizedTensor:
    scale = _amax_to_scale_int8(_amax(x, -1, keepdim=True))
    return QuantizedTensor(cast_to_int8(x, scale), scale, "per_token")


_INT_MM_MIN_ROWS = 17     # torch._int_mm takes more than 16 rows


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (M, K) int8 @ b (K, N) int8 -> (M, N) int32, exact.  On the card
    ``torch._int_mm`` (cuBLAS; the JAX package's int32 ``dot`` is XLA's,
    outside any Pallas kernel), with M padded to more than 16 rows; on the
    CPU a float64 product, exact for |sum| < 2**53."""
    if a.device.type == "cpu":
        return torch.matmul(a.to(torch.float64),
                            b.to(torch.float64)).to(torch.int32)
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, a.shape[1])])
    out = torch._int_mm(a, b)
    int8_matmul.launches += 1
    return out[:m]


int8_matmul.launches = 0


def int8_linear(x: torch.Tensor, wq: QuantizedTensor, *,
                out_dtype=None) -> torch.Tensor:
    """W8A8: per-token int8 activations x int8 ``(in, out)`` kernel, int32
    accumulation, dequant epilogue ``(acc * s_x) * s_w``."""
    k, n = wq.data.shape
    lead = x.shape[:-1]
    xq = quantize_per_token_int8(x.reshape(-1, k))
    acc = int8_matmul(xq.data, wq.data)
    w_scale = wq.scale.reshape(-1) if wq.granularity == "per_channel" \
        else wq.scale
    out = acc.to(torch.float32) * xq.scale * w_scale
    return out.to(out_dtype or x.dtype).reshape(*lead, n)


def fp8_grouped_linear(x: torch.Tensor, wq: QuantizedTensor, *,
                       out_dtype=None) -> torch.Tensor:
    """Grouped GEMM with per-channel weight scales (the non-128-aligned
    fallback, and int8 experts): x (E, C, K) @ wq (E, K, N), scale
    (E, 1, N).  fp8: kernel ``fp8_gemm`` with its leading batch dim; int8:
    the exact int8 product per expert, ``(acc * s_x) * s_w``."""
    e, _, n = wq.data.shape
    if wq.data.dtype == torch.int8:                       # W8A8 grouped
        xq = quantize_per_token_int8(x)                   # scale (E, C, 1)
        acc = torch.stack([int8_matmul(xq.data[i], wq.data[i])
                           for i in range(e)])
        out = acc.to(torch.float32) * xq.scale * wq.scale
        return out.to(out_dtype or x.dtype)
    sw = wq.scale.reshape(e, -1).expand(e, n).contiguous()
    return fp8_gemm_ops.fp8_gemm(x, wq.data, sw,
                                 out_dtype=out_dtype or x.dtype)


# ---------------------------------------------------------------------------
# The one dispatch point the layers funnel through
# ---------------------------------------------------------------------------


# depth of the f32 partial sums of a raw product on the card: cuBLAS's
# bf16 tensor-core sums keep fewer bits than IEEE f32 adds (at K = 2048 -
# 4096 one call puts 0.11-0.24% of outputs off the bf16 rounding of the
# float64 product, ``chip_smoke.py`` phase 2), so K is cut into chunks this
# deep whose f32 products are added in f32, as the fp8 GEMM kernels fold
# their f32 sums every 128 deep
RAW_K_CHUNK = 512


def _f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of 16-bit operands on the card with an f32 result: one
    cuBLAS call if K fits one chunk; else for a 2-D ``b`` one batched call
    over the whole chunks (``a`` (M, K) read as (K / c, M, c) in place),
    their partials summed, the ragged tail's product added by an ``addmm``
    epilogue; for a 3-D ``b`` each chunk's product added by a ``baddbmm``
    epilogue."""
    k, c, f32 = a.shape[-1], RAW_K_CHUNK, torch.float32
    if b.ndim == 3:
        acc = torch.bmm(a[..., :c], b[:, :c], out_dtype=f32)
        for i in range(c, k, c):
            torch.baddbmm(acc, a[..., i:i + c], b[:, i:i + c],
                          out_dtype=f32, out=acc)
        return acc
    if k <= c:
        return torch.mm(a, b, out_dtype=f32)
    whole = k // c * c
    acc = torch.bmm(a[:, :whole].unflatten(1, (-1, c)).transpose(0, 1),
                    b[:whole].unflatten(0, (-1, c)), out_dtype=f32).sum(0)
    if whole < k:
        torch.addmm(acc, a[:, whole:], b[whole:], out_dtype=f32, out=acc)
    return acc


def _card_product(a: torch.Tensor, b: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """``raw_matmul`` on the card: one ``matmul`` when K fits one
    ``RAW_K_CHUNK`` and ``out_dtype`` is the operands', else
    ``RAW_K_CHUNK``-deep f32 partials (``_f32_product``) rounded once.
    Operands of two dtypes (an f32 gradient against a 16-bit operand) are
    multiplied as f32, as XLA multiplies them."""
    if a.dtype != b.dtype:
        return torch.matmul(a.to(torch.float32),
                            b.to(torch.float32)).to(out_dtype)
    if a.shape[-1] <= RAW_K_CHUNK and out_dtype == a.dtype:
        return torch.matmul(a, b)
    if b.ndim == 3:
        return _f32_product(a, b).to(out_dtype)
    out = _f32_product(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1]).to(out_dtype)


class _CardProduct(torch.autograd.Function):
    """``_card_product`` with the JAX transpose of ``jnp.dot(a, b,
    preferred_element_type=f32)`` as its backward: dA = dY @ Bᵀ and dB =
    Aᵀ @ dY, each summed in f32 in ``RAW_K_CHUNK``-deep chunks and rounded
    once to its operand's dtype (autograd refuses the chunked product's
    ``out=`` epilogues)."""

    @staticmethod
    def forward(ctx, a, b, out_dtype):
        ctx.save_for_backward(a, b)
        return _card_product(a, b, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _card_product(dy, b.transpose(-1, -2), a.dtype)
        if ctx.needs_input_grad[1]:
            if b.ndim == 3:
                db = _card_product(a.transpose(-1, -2), dy, b.dtype)
            else:
                db = _card_product(a.reshape(-1, a.shape[-1]).T,
                                   dy.reshape(-1, dy.shape[-1]), b.dtype)
        return da, db, None


def raw_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype) -> torch.Tensor:
    """``a @ b`` of raw operands of one dtype, summed in f32 and rounded
    once to ``out_dtype`` (``jnp.dot(..., preferred_element_type=f32)
    .astype(out_dtype)``).  On the CPU, and for f32 operands, the f32
    product of the operands' values: the bit-parity path against the JAX
    package, whose autograd rounds each gradient product once at the
    casts, as JAX's transpose does.  On the card, 16-bit operands run on
    the tensor cores (cuBLAS with f32 accumulation, ``device.py``) with no
    f32 copies (``_card_product``), through ``_CardProduct`` whose backward
    sums the same way.  ``b`` is 2-D, or 3-D with ``a`` 3-D (a batch of
    products).  On ``meta`` (the dry run's shapes) the CPU's form: the same
    result shape and operation count (``baddbmm`` with an ``out_dtype`` has
    no meta kernel)."""
    if a.device.type in ("cpu", "meta") or a.dtype == torch.float32:
        return torch.matmul(a.to(torch.float32),
                            b.to(torch.float32)).to(out_dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _CardProduct.apply(a, b, out_dtype)
    return _card_product(a, b, out_dtype)


def matmul_any(x: torch.Tensor, w, *, out_dtype=None) -> torch.Tensor:
    """``x @ w`` where ``w`` is a raw tensor OR a QuantizedTensor: block
    weights through ``fp8_block_matmul``, int8 through ``int8_linear``,
    the rest through ``fp8_linear``.  A raw weight is cast to the
    activation dtype and multiplied by ``raw_matmul`` (f32 sums, so an f32
    ``out_dtype`` gets the unrounded sum).  ``DTensor`` operands run tensor
    parallel (``tp_matmul``)."""
    import repro_torch.distributed.sharding as sh
    out_dtype = out_dtype or x.dtype
    if sh.is_dtensor(x) or sh.is_dtensor(_payload(w)):
        return tp_matmul(x, w, out_dtype=out_dtype)
    if isinstance(w, QuantizedTensor):
        if w.granularity == "block":
            return fp8_block_matmul(x, w, out_dtype=out_dtype)
        if w.data.dtype == torch.int8:
            return int8_linear(x, w, out_dtype=out_dtype)
        return fp8_linear(x, w, out_dtype=out_dtype)
    return raw_matmul(x, w.to(x.dtype), out_dtype)


# ---------------------------------------------------------------------------
# Tensor parallelism: the products on DTensors
# ---------------------------------------------------------------------------


def _payload(w):
    return w.data if isinstance(w, QuantizedTensor) else w


def tp_matmul(x, w, *, out_dtype, act_scale=None):
    """``x @ w`` (``matmul_any``'s function) with ``x`` and the weight's
    parts ``DTensor``s on one mesh (a plain weight is a rank's full copy:
    replicated), by the weight's layout on each mesh dim:

      * replicated (the router, small dense nets): the local product;
      * column-parallel (weight ``Shard`` on its output axis, x
        replicated): the local product, output ``Shard`` on its last dim;
        fp8 per-token scales reduce over the full, replicated K, so the
        rank's e4m3 payload is one rank's, bit for bit;
      * row-parallel (weight ``Shard`` on its contraction axis, x
        ``Shard`` on its last): fp8 weights take the per-row amax of the
        local slab, a max all-reduce over the mesh dim (exact),
        ``amax_to_scale``, kernel ``fp8_gemm`` in its given-scale mode
        with f32 output (or its static mode, given a static scale), a sum
        all-reduce of the f32 partials, one rounding to ``out_dtype``; raw
        weights the f32 partial product, summed, rounded once.  The local
        payload is the slice of one rank's, bit for bit: only the f32 sum
        over ranks is associated otherwise.

    x's rows may be sharded where the weight is replicated (the ``data``
    axis).  Any other layout raises: nothing is gathered silently."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    import repro_torch.distributed.sharding as sh
    wdata = _payload(w)
    mesh = (x if sh.is_dtensor(x) else wdata).device_mesh
    w_nd, x_nd = wdata.ndim, x.ndim
    x_pl = x.placements if sh.is_dtensor(x) \
        else [Replicate()] * mesh.ndim
    w_pl = wdata.placements if sh.is_dtensor(wdata) \
        else [Replicate()] * mesh.ndim
    if sh.is_dtensor(wdata) and wdata.device_mesh != mesh:
        raise ValueError("tp_matmul: operands on two meshes")
    out_pl, rows = [], []
    for i, (xp, wp) in enumerate(zip(x_pl, w_pl)):
        if wp == Replicate() and (xp == Replicate() or (
                isinstance(xp, Shard) and xp.dim < x_nd - 1)):
            out_pl.append(xp)
        elif wp == Shard(w_nd - 1) and xp == Replicate():
            out_pl.append(Shard(x_nd - 1))
        elif wp == Shard(w_nd - 2) and xp == Shard(x_nd - 1):
            out_pl.append(Replicate())
            rows.append(mesh.get_group(i))
        else:
            raise ValueError(
                f"tp_matmul: no tensor-parallel product takes x {xp} "
                f"against a weight {wp} on mesh dim "
                f"{mesh.mesh_dim_names[i]} (x {tuple(x.shape)}, weight "
                f"{tuple(wdata.shape)})")
    xl = sh.local_shard(x)
    wl = w.map_parts(sh.local_shard) if isinstance(w, QuantizedTensor) \
        else sh.local_shard(w)
    if not rows:
        if act_scale is not None:
            out = fp8_linear(xl, wl, out_dtype=out_dtype,
                             act_scale=sh.local_shard(act_scale))
        else:
            out = matmul_any(xl, wl, out_dtype=out_dtype)
    else:
        out = _row_parallel(xl, wl, rows, out_dtype,
                            None if act_scale is None
                            else sh.local_shard(act_scale))
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def _row_parallel(x, w, groups, out_dtype, act_scale):
    """The rank's K-slice product summed over ``groups`` (``tp_matmul``'s
    row-parallel case) on local tensors."""
    import repro_torch.distributed.sharding as sh
    f32 = torch.float32
    if not isinstance(w, QuantizedTensor):
        part = raw_matmul(x, w.to(x.dtype), f32)
    else:
        if w.granularity not in ("per_channel", "per_tensor") \
                or w.data.dtype == torch.int8:
            raise ValueError(f"tp_matmul: a row-parallel {w.granularity} "
                             f"{w.data.dtype} weight is not supported")
        k, n = w.data.shape
        lead = x.shape[:-1]
        xs = x.reshape(1, -1, k)
        sw = w.scale.reshape(1, -1).expand(1, n).contiguous()
        act_scale = act_scale if act_scale is not None else w.act_scale
        if act_scale is not None:
            part = fp8_gemm_ops.fp8_gemm(xs, w.data.unsqueeze(0), sw,
                                         out_dtype=f32, act_scale=act_scale)
        else:
            amax = _amax(xs, -1)
            for g in groups:
                sh.all_reduce(amax, g, "max")
            part = fp8_gemm_ops.fp8_gemm(xs, w.data.unsqueeze(0), sw,
                                         out_dtype=f32,
                                         row_scale=amax_to_scale(amax))
        part = part.reshape(*lead, n)
    for g in groups:
        sh.all_reduce(part, g, "sum")
    return part.to(out_dtype)


def quant_error(x: torch.Tensor, q: QuantizedTensor) -> torch.Tensor:
    """Relative L2 quantization error (the PTQ report's ``rel_err``)."""
    xf = x.to(torch.float32)
    return torch.linalg.norm(xf - q.dequantize()) \
        / (torch.linalg.norm(xf) + _EPS)
