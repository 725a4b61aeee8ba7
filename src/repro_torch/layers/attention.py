"""GQA attention for the serving path: per-slot prefill fill and paged
single-token decode.

Two of the JAX layer's modes (``repro/layers/attention.py``):

  * **prefill fill** into a contiguous per-slot cache (``init_cache``
    ``per_slot``): full causal attention over the right-padded rows, then
    the K/V of positions ``< lengths[i]`` stored (fp8 through
    ``quantize_kv`` when the cache is fp8) and the padded tail marked empty
    (``pos = -1``);
  * **paged decode**: the new token's K/V written into the paged pool at
    host-resolved flat positions (``PageWrite``), then the POST-WRITE pool
    read through kernel ``paged_decode`` (page-table gather, fp8 dequant,
    online softmax).

Resume prefill, tree decode, chunked attention and the gathered-view
unfused path are later slices.  Plain torch matmul and softmax stand where
the JAX code is plain ``jnp``; scores and softmax are f32, the PV product
takes bf16 probabilities, as there.

The port updates cache tensors IN PLACE (the JAX code returns new arrays):
a layer's cache dict holds views into the stacked cache, so a write lands
in the pool without a copy.  A JAX ``.at[...].set(..., mode="drop")``
write whose index is out of range is dropped; here the host passes only
the writes that land (``PageWrite`` pairs), so nothing is dropped on the
device and ``index_put_`` never sees an out-of-range index.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quant import is_fp8_dtype, matmul_any, quantize_kv
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.layers.common import dense_init
from repro_torch.layers.rotary import apply_rope

NEG_INF = -2.0e38


class AttnSpec(NamedTuple):
    """Static attention hyperparameters for one layer."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    softmax_scale: Optional[float] = None
    chunk_size: int = 1024     # q-chunking threshold/size for long sequences

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


class PageWrite(NamedTuple):
    """The paged writes of one step, resolved on the host: flat physical
    pool position ``dst[j]`` receives row ``src[j]`` of the flattened new
    K/V (rows whose JAX scatter index was the drop index are absent)."""

    dst: torch.Tensor          # (W,) int64
    src: torch.Tensor          # (W,) int64


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec, *,
                   stack: Tuple[int, ...] = (), device=None) -> dict:
    qkv_std = 1.0 / math.sqrt(d_model)
    o_std = 1.0 / math.sqrt(spec.n_heads * spec.head_dim)
    return {
        "q_proj": dense_init(gen, d_model, spec.n_heads * spec.head_dim,
                             stack=stack, stddev=qkv_std, device=device),
        "k_proj": dense_init(gen, d_model, spec.n_kv_heads * spec.head_dim,
                             stack=stack, stddev=qkv_std, device=device),
        "v_proj": dense_init(gen, d_model, spec.n_kv_heads * spec.head_dim,
                             stack=stack, stddev=qkv_std, device=device),
        "o_proj": dense_init(gen, spec.n_heads * spec.head_dim, d_model,
                             stack=stack, stddev=o_std, device=device),
    }


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def _kv_leaves(lead: Tuple[int, ...], spec: AttnSpec, dtype, device
               ) -> Dict[str, torch.Tensor]:
    cache = {
        "k": torch.zeros((*lead, spec.n_kv_heads, spec.head_dim),
                         dtype=dtype, device=device),
        "v": torch.zeros((*lead, spec.n_kv_heads, spec.head_dim),
                         dtype=dtype, device=device),
        "pos": torch.full(lead, -1, dtype=torch.int32, device=device),
    }
    if is_fp8_dtype(dtype):
        cache["k_scale"] = torch.zeros((*lead, spec.n_kv_heads),
                                       dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros_like(cache["k_scale"])
    return cache


def init_cache(batch: int, cache_len: int, spec: AttnSpec, *,
               stack: Tuple[int, ...] = (), dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """Per-slot cache: k/v (..., B, S, Kv, hd) and pos (..., B, S), -1 =
    empty; an fp8 ``dtype`` adds f32 ``k_scale``/``v_scale`` (..., B, S, Kv),
    one scale per (position, KV head)."""
    return _kv_leaves((*stack, batch, cache_len), spec, dtype, device)


def init_page_cache(n_positions: int, spec: AttnSpec, *,
                    stack: Tuple[int, ...] = (), dtype=torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Paged pool: k/v (..., NP, Kv, hd) and pos (..., NP), one flat heap of
    ``n_pages * page_size`` positions plus a trailing SENTINEL page that is
    never written (unmapped table entries point at it; its pos stays -1)."""
    return _kv_leaves((*stack, n_positions), spec, dtype, device)


def _store_kv(cache, k, v):
    """New K/V in storage form: a cast for a bf16 cache, ``quantize_kv``
    for an fp8 one.  Returns ``(k, v, k_scale, v_scale)``; the scales are
    None for a non-fp8 cache."""
    if "k_scale" in cache:
        fmt = cache["k"].dtype
        kq, ks = quantize_kv(k, fmt)
        vq, vs = quantize_kv(v, fmt)
        return kq, vq, ks, vs
    return k.to(cache["k"].dtype), v.to(cache["v"].dtype), None, None


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float
                ) -> torch.Tensor:
    """q (B,T,K,G,hd) x k (B,S,K,hd) -> scores (B,K,G,T,S) in f32."""
    return torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) * scale


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,K,G,T,S) x v (B,S,K,hd) -> (B,T,K,G,hd), f32 sums of the
    bf16-rounded probabilities, cast to v's dtype."""
    out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype).float(),
                       v.float())
    return out.to(v.dtype)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key: zero them out
    return torch.where(mask.any(-1, keepdim=True), probs, 0.0)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor) -> torch.Tensor:
    """(T, S) causal mask (the ported layers have no sliding window)."""
    return k_pos[None, :] <= q_pos[:, None]


def _full_attention(q, k, v, positions, spec: AttnSpec) -> torch.Tensor:
    """Materialized-scores causal attention for short sequences."""
    b, t = q.shape[0], q.shape[1]
    g = spec.n_heads // spec.n_kv_heads
    qh = q.reshape(b, t, spec.n_kv_heads, g, spec.head_dim)
    scores = _gqa_scores(qh, k, spec.scale)
    mask = _causal_mask(positions, positions)
    probs = _masked_softmax(scores, mask[None, None, None])
    return _gqa_combine(probs, v).reshape(b, t, spec.n_heads * spec.head_dim)


# ---------------------------------------------------------------------------
# Public layer API
# ---------------------------------------------------------------------------


def apply_attention(
    params: dict,
    x: torch.Tensor,
    spec: AttnSpec,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    fill_cache: bool = False,
    lengths: Optional[torch.Tensor] = None,
    page_write: Optional[PageWrite] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer; returns ``(out, cache)``.

    * ``cache=None`` — plain causal forward.
    * ``cache, fill_cache=True`` — prefill into a per-slot cache: ``x`` is
      right-padded to T, ``lengths`` (B,) the true sequence lengths; every
      position's K/V is stored and positions ``>= lengths[i]`` are marked
      empty.
    * ``cache, page_write, page_tables`` — paged single-token decode:
      ``x`` (B, 1, D), ``lengths`` (B,) the absolute index of the new
      token; the write lands at ``page_write``, then kernel ``paged_decode``
      reads the post-write pool through ``page_tables`` (B, P).
    """
    b, t, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    decode = cache is not None and not fill_cache
    if decode:
        if page_write is None or page_tables is None or t != 1:
            raise NotImplementedError(
                "only paged single-token decode is ported (ROADMAP.md queue "
                "N: N1 contiguous / unfused decode, N3 tree decode)")
        positions = lengths[:, None].to(torch.int32)
    else:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)

    q = matmul_any(x, params["q_proj"]["kernel"]).reshape(b, t, h, hd)
    k = matmul_any(x, params["k_proj"]["kernel"]).reshape(b, t, kvh, hd)
    v = matmul_any(x, params["v_proj"]["kernel"]).reshape(b, t, kvh, hd)
    q = apply_rope(q, positions, theta=spec.rope_theta)
    k = apply_rope(k, positions, theta=spec.rope_theta)

    if decode:
        ks, vs, k_sc, v_sc = _store_kv(cache, k[:, 0], v[:, 0])
        dst, src = page_write
        _put(cache["k"], dst, ks, src)
        _put(cache["v"], dst, vs, src)
        cache["pos"][dst] = lengths.to(torch.int32)[src]
        if k_sc is not None:
            cache["k_scale"][dst] = k_sc[src]
            cache["v_scale"][dst] = v_sc[src]
        out = paged_decode_attention(q, cache, page_tables, lengths,
                                     page_size=page_size, scale=spec.scale)
        out = out.to(x.dtype)
    else:
        if t > 2 * spec.chunk_size and t % spec.chunk_size == 0:
            raise NotImplementedError("chunked attention is not ported yet "
                                      "(ROADMAP.md queue N, item N7)")
        out = _full_attention(q, k, v, positions, spec)
        if cache is not None:
            if cache["pos"].ndim != 2 or cache["pos"].shape[1] < t:
                raise ValueError("prefill fill takes a per-slot cache of at "
                                 "least T positions")
            ks, vs, k_sc, v_sc = _store_kv(cache, k, v)
            cache["k"][:, :t] = ks
            cache["v"][:, :t] = vs
            row_pos = positions[None, :].expand(b, t)
            if lengths is not None:
                row_pos = torch.where(positions[None, :] < lengths[:, None],
                                      row_pos, -1)
            cache["pos"][:, :t] = row_pos
            if k_sc is not None:
                cache["k_scale"][:, :t] = k_sc
                cache["v_scale"][:, :t] = v_sc

    proj = matmul_any(out, params["o_proj"]["kernel"])
    return proj, cache


def _u8(t: torch.Tensor) -> torch.Tensor:
    """fp8 payloads move as bytes through index ops."""
    return t.view(torch.uint8) if is_fp8_dtype(t.dtype) else t


def _put(dst_tensor: torch.Tensor, dst: torch.Tensor, new: torch.Tensor,
         src: torch.Tensor) -> None:
    _u8(dst_tensor)[dst] = _u8(new)[src]
