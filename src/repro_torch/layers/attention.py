"""GQA attention for the serving path: per-slot and shared prefill fill,
resume prefill over a cached prefix, single-token and tree decode over the
paged pool or the contiguous slot pool, and the shared-index decode of the
batch-shared cache.

The cached modes of the JAX layer (``repro/layers/attention.py``):

  * **prefill fill** into a contiguous per-slot cache (``init_cache``
    ``per_slot``): full causal attention over the right-padded rows, then
    the K/V of positions ``< lengths[i]`` stored (fp8 through
    ``quantize_kv`` when the cache is fp8) and the padded tail marked empty
    (``pos = -1``);
  * **resume prefill** (``fill_cache`` with ``starts``): row i's token j
    sits at absolute position ``starts[i] + j``; its K/V lands at the
    host-resolved write (``KVWrite``) and the queries attend over the whole
    post-write row, the cached prefix included, masked by ``0 <= pos <=
    q_pos`` — through each row of a per-slot cache, or through the paged
    pool's gathered view (``page_gather``);
  * **paged decode**: the new token's K/V written into the paged pool at
    host-resolved flat positions (``KVWrite``), then the POST-WRITE pool
    read through kernel ``paged_decode`` (``page_tables``: page-table
    gather, fp8 dequant, online softmax) or, unfused, through the gathered
    view (``page_gather``) and the plain masked softmax;
  * **per-slot decode** over the contiguous slot pool: the new token's K/V
    written at ``lengths[i] % S`` of its row (a row passed index 0 is
    inactive and not written), the post-write rows dequantized to the
    query's dtype (``_read_kv``), then kernel ``batch_attention``
    (``AttnSpec.use_kernel``) or the plain length-masked softmax;
  * **tree decode** (``branch_stride``): ``x`` carries T = C candidate
    branches per row, all at logical depth ``lengths[i]`` (one RoPE
    position).  Branch b's token lands at ``starts[i] + b * R + (lengths[i]
    - starts[i])`` (R = ``branch_stride``, resolved on the host into
    ``KVWrite``; inactive rows and dummy branches are not written) and
    attends over the shared prefix (logical ``< starts[i]``) and its own
    span ``[starts[i] + b * R, + R)`` only: through kernel ``paged_decode``
    in tree mode (``page_tables``), or the plain tree mask over the
    gathered view (``page_gather``) or over each contiguous row;
  * **shared-index decode** (``cache_index``) over the batch-shared cache
    (``init_cache(..., per_slot=False)``: one ``pos`` row for the batch,
    every row at the same depth): the new K/V at ring slot ``idx % S``,
    then kernel ``batch_attention`` (``use_kernel``, positions broadcast to
    every row, the layer's window passed on) or the plain masked softmax,
    keys valid where ``0 <= pos <= idx`` and, in a window layer, ``idx -
    pos < window``.  The shared prefill fill keeps the last ``min(S, T)``
    positions at ``pos % S``: a window layer's cache holds ``window``
    slots (``cache_len_for``), a ring that wraps once the prompt or the
    decode passes it.

The gathered view (``page_gather`` (B, Sp), the flat pool position of each
row's logical position) is dense in logical position, so the contiguous
masks apply to it unchanged; unmapped pages read the sentinel page (``pos``
-1).  The uncached and prefill-fill forwards mask causally and, in a window
layer, by ``q_pos - k_pos < window``; above ``2 * chunk_size`` tokens (and
a multiple of it) they run ``_chunked_attention``, a loop over q chunks
against the whole K/V.  QK-norm (``use_qk_norm``) applies a plain RMSNorm
over head_dim to q and k before RoPE (not zero-centred, as in the JAX
package, whatever the model's norms).  The paged, per-slot and resume
modes take full attention only (a window raises ``ValueError``, as in the
JAX package).  Plain torch matmul and softmax stand where the JAX code is
plain ``jnp``; scores and softmax are f32, the PV product takes bf16
probabilities, as there.

Tensor parallelism (``DTensor`` activations, params laid out by
``launch.steps.shard_args`` under ``INFER_RULES``): q/k/v come out of
column-parallel products, whole heads to a rank (a rank whose column
slice splits a head gathers first); ``constrain`` at the JAX package's
sites lays q out by ``heads`` and gathers k/v (``kv_heads`` is
replicated); each rank attends with its own query heads, grouped by the
model's G (local head j is global head ``h_off + j`` and reads KV head
``(h_off + j) // G``), and the output goes row-parallel into ``o_proj``.
The shared cache is laid out over ``kv_seq`` (sequence-sharded over
``model``): a write lands on the rank that holds its slot, and the layer's
K/V (payload, scales, positions) are gathered whole before the read.
Only the shared-cache modes and the uncached forward run so; the paged
pool, the per-slot cache and the resume prefill stay single-rank.

The port updates cache tensors IN PLACE (the JAX code returns new arrays):
a layer's cache dict holds views into the stacked cache, so a write lands
in the pool without a copy.  A JAX ``.at[...].set(..., mode="drop")``
write whose index is out of range is dropped; here the host passes only
the writes that land (``KVWrite`` pairs), so nothing is dropped on the
device and ``index_put_`` never sees an out-of-range index.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.quant import (dequantize_kv, is_fp8_dtype, matmul_any,
                                    quantize_kv, raw_matmul)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.batch_attention.ops import batch_attention
from repro_torch.kernels.paged_decode.ops import paged_decode_attention
from repro_torch.layers.common import dense_init
from repro_torch.layers.norms import rmsnorm_apply
from repro_torch.layers.rotary import apply_rope

NEG_INF = -2.0e38


class AttnSpec(NamedTuple):
    """Static attention hyperparameters for one layer."""

    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int = 0            # 0 => full (causal) attention
    use_qk_norm: bool = False
    softmax_scale: Optional[float] = None
    chunk_size: int = 1024     # q-chunking threshold/size for long sequences
    use_kernel: bool = False   # decode through batch_attention

    @property
    def scale(self) -> float:
        return self.softmax_scale or 1.0 / math.sqrt(self.head_dim)


class KVWrite(NamedTuple):
    """The cache writes of one decode step, resolved on the host: flat
    position ``dst[j]`` of the cache's position axis (the paged heap, or
    the per-slot cache's rows flattened to ``slot * S + position``)
    receives row ``src[j]`` of the flattened new K/V.  Rows whose JAX
    scatter index was the drop index are absent."""

    dst: torch.Tensor          # (W,) int64
    src: torch.Tensor          # (W,) int64


def init_attention(gen: torch.Generator, d_model: int, spec: AttnSpec, *,
                   stack: Tuple[int, ...] = (), dtype=torch.float32,
                   device=None) -> dict:
    qkv_std = 1.0 / math.sqrt(d_model)
    o_std = 1.0 / math.sqrt(spec.n_heads * spec.head_dim)
    kw = dict(stack=stack, dtype=dtype, device=device)
    params = {
        "q_proj": dense_init(gen, d_model, spec.n_heads * spec.head_dim,
                             stddev=qkv_std, **kw),
        "k_proj": dense_init(gen, d_model, spec.n_kv_heads * spec.head_dim,
                             stddev=qkv_std, **kw),
        "v_proj": dense_init(gen, d_model, spec.n_kv_heads * spec.head_dim,
                             stddev=qkv_std, **kw),
        "o_proj": dense_init(gen, spec.n_heads * spec.head_dim, d_model,
                             stddev=o_std, **kw),
    }
    if spec.use_qk_norm:
        params["q_norm"] = {"scale": torch.ones((*stack, spec.head_dim),
                                                dtype=dtype, device=device)}
        params["k_norm"] = {"scale": torch.ones((*stack, spec.head_dim),
                                                dtype=dtype, device=device)}
    return params


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
               per_slot: bool = True,
               device=None) -> Dict[str, torch.Tensor]:
    """Cache slots: k/v (..., B, S, Kv, hd) and pos, -1 = empty: (..., B, S)
    per slot (every row its own occupancy, the serving layout), or one
    shared (..., S) with ``per_slot=False`` (every row at the same depth,
    the generation layout).  An fp8 ``dtype`` adds f32
    ``k_scale``/``v_scale`` (..., B, S, Kv), one scale per (position, KV
    head)."""
    cache = _kv_leaves((*stack, batch, cache_len), spec, dtype, device)
    if not per_slot:
        cache["pos"] = torch.full((*stack, cache_len), -1, dtype=torch.int32,
                                  device=device)
    return cache


def init_page_cache(n_positions: int, spec: AttnSpec, *,
                    stack: Tuple[int, ...] = (), dtype=torch.bfloat16,
                    device=None) -> Dict[str, torch.Tensor]:
    """Paged pool: k/v (..., NP, Kv, hd) and pos (..., NP), one flat heap of
    ``n_pages * page_size`` positions plus a trailing SENTINEL page that is
    never written (unmapped table entries point at it; its pos stays -1)."""
    return _kv_leaves((*stack, n_positions), spec, dtype, device)


def cache_len_for(spec: AttnSpec, max_target_len: int) -> int:
    """A window layer's cache holds ``window`` positions (a ring), a full
    layer ``max_target_len``."""
    if spec.window and spec.window < max_target_len:
        return spec.window
    return max_target_len


def _read_kv(ck, cv, cks, cvs, dtype):
    """Cache K/V in compute form: dequantized for an fp8 cache (scales
    present), cast for any other dtype than ``dtype``."""
    if cks is not None:
        return dequantize_kv(ck, cks, dtype), dequantize_kv(cv, cvs, dtype)
    if ck.dtype != dtype:
        return ck.to(dtype), cv.to(dtype)
    return ck, cv


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
    """q (B,T,K,G,hd) x k (B,S,K,hd) -> scores (B,K,G,T,S) in f32.  On the
    CPU an f32 einsum of the operands' values; on the card one batch of
    (G*T, hd) x (hd, S) products per (row, KV head) through ``raw_matmul``
    (bf16 operands on the tensor cores, f32 out)."""
    if q.device.type == "cpu":
        return torch.einsum("btkgh,bskh->bkgts", q.float(), k.float()) \
            * scale
    b, t, kv, g, hd = q.shape
    s = k.shape[1]
    qm = q.permute(0, 2, 3, 1, 4).reshape(b * kv, g * t, hd)
    km = k.permute(0, 2, 3, 1).reshape(b * kv, hd, s)
    return raw_matmul(qm, km, torch.float32).view(b, kv, g, t, s) * scale


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs (B,K,G,T,S) x v (B,S,K,hd) -> (B,T,K,G,hd), f32 sums of the
    probabilities rounded to v's dtype, cast to v's dtype (on the card
    through ``raw_matmul``, as ``_gqa_scores``)."""
    if probs.device.type == "cpu":
        out = torch.einsum("bkgts,bskh->btkgh", probs.to(v.dtype).float(),
                           v.float())
        return out.to(v.dtype)
    b, kv, g, t, s = probs.shape
    pm = probs.to(v.dtype).reshape(b * kv, g * t, s)
    vm = v.permute(0, 2, 1, 3).reshape(b * kv, s, v.shape[-1])
    out = raw_matmul(pm, vm, v.dtype).view(b, kv, g, t, v.shape[-1])
    return out.permute(0, 3, 1, 2, 4)


def _masked_softmax(scores: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # rows with no valid key: zero them out
    return torch.where(mask.any(-1, keepdim=True), probs, 0.0)


def _causal_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 window: int) -> torch.Tensor:
    """(T, S) mask: causal, plus sliding window when ``window > 0``."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _attend_block(q, k, v, q_pos, k_pos, spec: AttnSpec) -> torch.Tensor:
    """q (B, T, K, G, hd) at ``q_pos`` (T,) over k/v (B, S, K, hd) at
    ``k_pos`` (S,) -> (B, T, K, G, hd)."""
    scores = _gqa_scores(q, k, spec.scale)
    mask = _causal_mask(q_pos, k_pos, spec.window)
    probs = _masked_softmax(scores, mask[None, None, None])
    return _gqa_combine(probs, v)


def _full_attention(q, k, v, positions, spec: AttnSpec) -> torch.Tensor:
    """Materialized-scores path for short sequences."""
    b, t = q.shape[0], q.shape[1]
    g = spec.n_heads // spec.n_kv_heads
    qh = q.reshape(b, t, spec.n_kv_heads, g, spec.head_dim)
    return _attend_block(qh, k, v, positions, positions, spec).reshape(
        b, t, spec.n_heads * spec.head_dim)


def _chunked_attention(q, k, v, positions, spec: AttnSpec) -> torch.Tensor:
    """A loop over q chunks of ``chunk_size``, each against the whole K/V
    (f32 softmax): O(chunk x S) scores at a time instead of O(T x S), the
    JAX package's ``lax.scan`` over chunks.  Row-wise the same function as
    ``_full_attention``."""
    b, t = q.shape[0], q.shape[1]
    c = spec.chunk_size
    g = spec.n_heads // spec.n_kv_heads
    qh = q.reshape(b, t, spec.n_kv_heads, g, spec.head_dim)
    out = torch.empty((b, t, spec.n_kv_heads, g, spec.head_dim),
                      dtype=v.dtype, device=q.device)
    for i in range(t // c):
        sl = slice(i * c, (i + 1) * c)
        out[:, sl] = _attend_block(qh[:, sl], k, v, positions[sl],
                                   positions, spec)
    return out.reshape(b, t, spec.n_heads * spec.head_dim)


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
    starts: Optional[torch.Tensor] = None,
    kv_write: Optional[KVWrite] = None,
    page_gather: Optional[torch.Tensor] = None,
    page_tables: Optional[torch.Tensor] = None,
    page_size: int = 0,
    branch_stride: Optional[int] = None,
    cache_index: Optional[int] = None,
    norm_eps: float = 1e-6,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention layer; returns ``(out, cache)``.

    * ``cache=None`` — plain causal (and windowed) forward.
    * ``cache, fill_cache=True`` — prefill into a per-slot cache: ``x`` is
      right-padded to T, ``lengths`` (B,) the true sequence lengths; every
      position's K/V is stored and positions ``>= lengths[i]`` are marked
      empty.  Into a shared cache (1-D ``pos``) the last ``min(S, T)``
      positions are stored at ``pos % S``.
    * ``cache, fill_cache=True, starts, kv_write`` — resume prefill: ``x``
      holds each row's suffix, token j at position ``starts[i] + j``; the
      writes land at ``kv_write`` (rows of the flattened (B, T) new K/V),
      then the queries attend over each post-write row of a per-slot
      cache, or over the paged pool's rows through ``page_gather`` (B, Sp).
    * ``cache, kv_write, page_tables`` — paged single-token decode:
      ``x`` (B, 1, D), ``lengths`` (B,) the absolute index of the new
      token; the write lands at ``kv_write``, then kernel ``paged_decode``
      reads the post-write pool through ``page_tables`` (B, P).
    * ``cache, kv_write, page_gather`` — the unfused paged decode: the
      same write, then the plain masked softmax over the gathered view.
    * ``cache, kv_write`` with a per-slot cache and neither — per-slot
      single-token decode (the host resolves the write to the flattened
      rows), then ``batch_attention`` or the plain masked softmax over
      each row.
    * ``branch_stride`` with any of the three decode forms above — tree
      decode: ``x`` (B, C, D) holds C branch tokens per row at depth
      ``lengths`` (B,), ``starts`` (B,) the rows' branch bases.
    * ``cache, cache_index`` (an int) with a shared cache — shared-index
      decode: ``x`` (B, 1, D) at absolute position ``cache_index``.
    """
    b, t, _ = x.shape
    h, kvh, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    decode = cache is not None and not fill_cache
    resume = cache is not None and fill_cache and starts is not None
    tree = decode and branch_stride is not None
    shared = decode and cache_index is not None
    shared_cache = cache is not None and cache["pos"].ndim == 1 and (
        shared or (fill_cache and not resume))
    if spec.window and cache is not None and not shared_cache:
        raise ValueError("paged, per-slot and resume caches require full "
                         "attention")
    if shared:
        if cache["pos"].ndim != 1:
            raise ValueError("shared-index decode takes a shared cache")
        positions = torch.full((1,), int(cache_index), dtype=torch.int32,
                               device=x.device)
    elif decode:
        if kv_write is None or lengths is None:
            raise ValueError("decode takes host-resolved writes and lengths")
        if tree and (starts is None or branch_stride <= 0):
            raise ValueError("tree decode takes starts and a positive "
                             "branch_stride")
        if not tree and t != 1:
            raise ValueError(f"single-token decode takes one token a row, "
                             f"got {t} (tree decode takes branch_stride)")
        positions = lengths[:, None].to(torch.int32)
    elif resume:
        if kv_write is None:
            raise ValueError("resume prefill takes host-resolved writes")
        positions = starts[:, None].to(torch.int32) + torch.arange(
            t, dtype=torch.int32, device=x.device)[None, :]
    else:
        positions = torch.arange(t, dtype=torch.int32, device=x.device)

    q = _heads(matmul_any(x, params["q_proj"]["kernel"]), h, hd)
    k = _heads(matmul_any(x, params["k_proj"]["kernel"]), kvh, hd)
    v = _heads(matmul_any(x, params["v_proj"]["kernel"]), kvh, hd)
    if spec.use_qk_norm:
        q = rmsnorm_apply(params["q_norm"], q, eps=norm_eps)
        k = rmsnorm_apply(params["k_norm"], k, eps=norm_eps)
    q = sh.local_call(apply_rope, q, positions, theta=spec.rope_theta)
    k = sh.local_call(apply_rope, k, positions, theta=spec.rope_theta)
    q = constrain(q, ("batch", "seq", "heads", None))
    k = constrain(k, ("batch", "seq", "kv_heads", None))
    v = constrain(v, ("batch", "seq", "kv_heads", None))

    if sh.is_dtensor(q):
        if cache is not None and not shared_cache:
            raise NotImplementedError(
                "tensor-parallel attention runs the uncached forward and "
                "the shared cache; the paged pool, the per-slot cache and "
                "the resume prefill stay single-rank")
        out = _tp_attention(q, k, v, cache, positions, spec,
                            None if not shared else int(cache_index))
        out = out.to(x.dtype)
    elif shared:
        out = _shared_decode(q, k, v, cache, int(cache_index), spec)
        out = out.to(x.dtype)
    elif decode or resume:
        paged = page_tables is not None or page_gather is not None
        _write_kv(cache, k, v, positions, kv_write, paged)
        if page_tables is not None:
            out = paged_decode_attention(
                q, cache, page_tables, lengths, starts if tree else None,
                page_size=page_size, branch_stride=branch_stride or 1,
                scale=spec.scale)
        else:
            rows = cache
            if page_gather is not None:
                g = page_gather.long()
                rows = {n: _u8(leaf)[g].view(leaf.dtype)
                        for n, leaf in cache.items()}
            if tree:
                out = _tree_attention(q, rows, lengths.to(torch.int32),
                                      starts.to(torch.int32), branch_stride,
                                      spec)
            elif decode and page_gather is None:
                out = _slot_decode(q, cache, lengths.to(torch.int32), spec)
            else:
                out = _view_attention(q, rows, positions, spec)
        out = out.to(x.dtype)
    else:
        if t > 2 * spec.chunk_size and t % spec.chunk_size == 0:
            out = _chunked_attention(q, k, v, positions, spec)
        else:
            out = _full_attention(q, k, v, positions, spec)
        if cache is not None and cache["pos"].ndim == 1:
            _shared_fill(cache, k, v, positions)
        elif cache is not None:
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

    out = constrain(out, ("batch", "seq", "qkv_out"))
    proj = matmul_any(out, params["o_proj"]["kernel"])
    return constrain(proj, ("batch", "seq", "embed")), cache


def _heads(t, n: int, hd: int):
    """(B, T, n * hd) -> (B, T, n, hd).  A DTensor sharded on its last dim
    whose rank slices split a head (fewer heads than ranks, or a count the
    ranks do not divide) is gathered along it first."""
    if sh.is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        for i in reversed(range(t.device_mesh.ndim)):
            if t.placements[i] == Shard(2):
                _, cols = sh.shard_range(t.device_mesh, t.placements, 2,
                                         t.shape[2])
                if cols % hd:
                    t = sh.redistribute(t, [
                        pl if pl != Shard(2) else Replicate()
                        for pl in t.placements])
                break
    return t.reshape(*t.shape[:2], n, hd)


def _local_group(q, spec: AttnSpec) -> Tuple[int, AttnSpec]:
    """The first KV head of this rank's query heads and the layer's spec
    for them: q holds global heads ``h_off ..`` of a DTensor sharded on
    dim 2 (all of them, replicated); grouped by the model's G, either a
    whole number of groups or a part of one group."""
    h_off, h_loc = sh.shard_range(q.device_mesh, q.placements, 2,
                                  spec.n_heads)
    g = spec.n_heads // spec.n_kv_heads
    if h_loc % g == 0:
        kv_loc = h_loc // g
    elif g % h_loc == 0:
        kv_loc = 1
    else:
        raise ValueError(f"{h_loc} query heads a rank do not group by G = "
                         f"{g}")
    return h_off // g, spec._replace(n_heads=h_loc, n_kv_heads=kv_loc)


def _tp_attention(q, k, v, cache, positions, spec: AttnSpec,
                  idx: Optional[int]):
    """Attention of the rank's query heads (``q`` a DTensor, k/v gathered
    over ``model``): the uncached or shared-fill forward (``idx`` None),
    or the shared-index decode at ``idx``; a shared ``cache`` is written
    on the rank that holds each slot and read whole.  Returns the
    (B, T, H * hd) output with q's placements."""
    from torch.distributed.tensor import DTensor, Shard
    for pl in (*k.placements, *v.placements):
        if isinstance(pl, Shard) and pl.dim != 0:
            raise ValueError(f"tensor-parallel attention takes k/v split "
                             f"on the batch alone, got {k.placements}")
    kv0, lspec = _local_group(q, spec)
    ql = q.to_local()
    kl = k.to_local()[:, :, kv0:kv0 + lspec.n_kv_heads]
    vl = v.to_local()[:, :, kv0:kv0 + lspec.n_kv_heads]
    if idx is None:
        t = ql.shape[1]
        if t > 2 * spec.chunk_size and t % spec.chunk_size == 0:
            out = _chunked_attention(ql, kl, vl, positions, lspec)
        else:
            out = _full_attention(ql, kl, vl, positions, lspec)
        if cache is not None:
            _shared_fill(cache, k.to_local(), v.to_local(), positions)
    else:
        rows = _gather_slots(cache, _shared_write(cache, k.to_local(),
                                                  v.to_local(), idx))
        rows = {n: (r[:, :, kv0:kv0 + lspec.n_kv_heads].contiguous()
                    if n != "pos" else r) for n, r in rows.items()}
        out = _shared_read(ql, rows, idx, lspec)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _cache_slab(cache) -> Tuple[dict, int, int]:
    """A shared cache's local leaves and this rank's slot range
    ``(offset, length)`` of its S positions (all of them, unless laid out
    over ``kv_seq``)."""
    pos = cache["pos"]
    if not sh.is_dtensor(pos):
        return cache, 0, pos.shape[0]
    off, n = sh.shard_range(pos.device_mesh, pos.placements, 0,
                            pos.shape[0])
    return {name: leaf.to_local() for name, leaf in cache.items()}, off, n


def _gather_slots(cache, slab) -> Dict[str, torch.Tensor]:
    """A shared cache's leaves gathered whole along S from each rank's
    ``slab`` (exact: bytes moved), for the read; ``slab`` itself where
    the cache is not laid out over ``kv_seq``."""
    from torch.distributed.tensor import Shard
    if not sh.is_dtensor(cache["pos"]):
        return dict(slab)
    out = {}
    for name, leaf in cache.items():
        dim = 0 if name == "pos" else 1
        local = slab[name]
        mesh = leaf.device_mesh
        for i in reversed(range(mesh.ndim)):
            if leaf.placements[i] == Shard(dim):
                local = sh.all_gather(local, dim, mesh.get_group(i))
        out[name] = local
    return out


def _write_kv(cache: Dict[str, torch.Tensor], k: torch.Tensor,
              v: torch.Tensor, positions: torch.Tensor, kv_write: KVWrite,
              paged: bool) -> None:
    """Store the new K/V (B, T, Kv, hd) and their positions (B, T) at the
    host-resolved ``kv_write``: flat positions of the paged heap, or of the
    per-slot cache's rows flattened to ``slot * S + position`` (views, so
    the write lands in the pool).  ``src`` indexes the flattened (B, T)
    rows."""
    ks, vs, k_sc, v_sc = _store_kv(cache, k.flatten(0, 1), v.flatten(0, 1))
    flat = cache if paged else \
        {n: leaf.flatten(0, 1) for n, leaf in cache.items()}
    dst, src = kv_write
    _put(flat["k"], dst, ks, src)
    _put(flat["v"], dst, vs, src)
    flat["pos"][dst] = positions.expand(k.shape[:2]).reshape(-1)[src]
    if k_sc is not None:
        flat["k_scale"][dst] = k_sc[src]
        flat["v_scale"][dst] = v_sc[src]


def _view_attention(q: torch.Tensor, rows: Dict[str, torch.Tensor],
                    q_pos: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Attention of q (B, T, H, hd) at absolute positions ``q_pos`` (B, T)
    over per-row cache views (k/v (B, S, Kv, hd), pos (B, S), fp8 scales):
    keys valid where ``0 <= pos <= q_pos``.  Returns (B, T, H * hd)."""
    ck, cv = _read_kv(_kv_view(rows["k"]), _kv_view(rows["v"]),
                      rows.get("k_scale"), rows.get("v_scale"), q.dtype)
    cpos = rows["pos"]
    b, t = q.shape[:2]
    qh = q.reshape(b, t, spec.n_kv_heads, spec.n_heads // spec.n_kv_heads,
                   spec.head_dim)
    scores = _gqa_scores(qh, ck, spec.scale)              # (B,K,G,T,S)
    valid = (cpos[:, None, :] >= 0) \
        & (cpos[:, None, :] <= q_pos[:, :, None])        # (B, T, S)
    probs = _masked_softmax(scores, valid[:, None, None])
    return _gqa_combine(probs, cv).reshape(b, t, -1)


def _tree_attention(q: torch.Tensor, rows: Dict[str, torch.Tensor],
                    idx: torch.Tensor, starts: torch.Tensor,
                    branch_stride: int, spec: AttnSpec) -> torch.Tensor:
    """Tree attention of q (B, C, H, hd), C branches per row at depth
    ``idx`` (B,), over per-row cache views indexed by logical position
    (k/v (B, S, Kv, hd), pos (B, S), fp8 scales): branch b sees the keys
    with ``0 <= pos <= idx`` that lie below ``starts`` or in its own span
    ``[starts + b * R, + R)``.  Returns (B, C, H * hd)."""
    ck, cv = _read_kv(_kv_view(rows["k"]), _kv_view(rows["v"]),
                      rows.get("k_scale"), rows.get("v_scale"), q.dtype)
    cpos = rows["pos"]
    b, c = q.shape[:2]
    s_len = cpos.shape[1]
    qh = q.reshape(b, c, spec.n_kv_heads, spec.n_heads // spec.n_kv_heads,
                   spec.head_dim)
    scores = _gqa_scores(qh, ck, spec.scale)              # (B,K,G,C,S)
    st = starts.long()
    phys = torch.arange(s_len, device=q.device)[None, None, :]
    own_lo = (st[:, None] + torch.arange(c, device=q.device)[None, :]
              * branch_stride)[..., None]                 # (B, C, 1)
    shared = phys < st[:, None, None]                     # (B, 1, S)
    own = (phys >= own_lo) & (phys < own_lo + branch_stride)
    valid = (cpos[:, None, :] >= 0) \
        & (cpos[:, None, :] <= idx[:, None, None]) & (shared | own)
    probs = _masked_softmax(scores, valid[:, None, None])
    return _gqa_combine(probs, cv).reshape(b, c, -1)


def _shared_fill(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, positions: torch.Tensor) -> None:
    """Prefill into a shared cache: the last ``min(S, T)`` positions of
    k/v (B, T, Kv, hd) at slots ``pos % S``, their positions in the shared
    ``pos`` row; on a cache laid out over ``kv_seq`` each rank writes the
    slots it holds (``_cache_slab``).  The positions are ``0 .. T - 1``,
    so the slots form at most two runs, each found by arithmetic on
    shapes and written as a slice."""
    slab, off, n = _cache_slab(cache)
    s_len, t = cache["pos"].shape[0], k.shape[1]
    first = t - min(s_len, t)
    ks, vs, k_sc, v_sc = _store_kv(slab, k[:, first:], v[:, first:])
    for base in range(first // s_len * s_len, t, s_len):
        lo, hi = max(first, base + off), min(t, base + off + n)
        if lo >= hi:
            continue
        dst = slice(lo - base - off, hi - base - off)
        src = slice(lo - first, hi - first)
        _u8(slab["k"])[:, dst] = _u8(ks)[:, src]
        _u8(slab["v"])[:, dst] = _u8(vs)[:, src]
        slab["pos"][dst] = positions[lo:hi]
        if k_sc is not None:
            slab["k_scale"][:, dst] = k_sc[:, src]
            slab["v_scale"][:, dst] = v_sc[:, src]


def _shared_write(cache: Dict[str, torch.Tensor], k: torch.Tensor,
                  v: torch.Tensor, idx: int) -> Dict[str, torch.Tensor]:
    """The new k/v (B, 1, Kv, hd) at ring slot ``idx % S`` of every row,
    ``pos[idx % S] = idx``; on a cache laid out over ``kv_seq`` only the
    rank holding the slot writes.  Returns the local leaves."""
    slab, off, n = _cache_slab(cache)
    slot = idx % cache["pos"].shape[0] - off
    if 0 <= slot < n:
        ks, vs, k_sc, v_sc = _store_kv(slab, k, v)
        _u8(slab["k"])[:, slot] = _u8(ks)[:, 0]
        _u8(slab["v"])[:, slot] = _u8(vs)[:, 0]
        slab["pos"][slot] = idx
        if k_sc is not None:
            slab["k_scale"][:, slot] = k_sc[:, 0]
            slab["v_scale"][:, slot] = v_sc[:, 0]
    return slab


def _shared_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache: Dict[str, torch.Tensor], idx: int,
                   spec: AttnSpec) -> torch.Tensor:
    """Shared-index decode: ``_shared_write``, then q (B, 1, H, hd)
    attends over the post-write rows, keys valid where ``0 <= pos <=
    idx`` and, in a window layer, ``idx - pos < window``: kernel
    ``batch_attention`` under ``use_kernel`` (positions broadcast to (B, 1)
    and (B, S)), else the plain masked softmax.  Returns (B, 1, H * hd)."""
    _shared_write(cache, k, v, idx)
    return _shared_read(q, cache, idx, spec)


def _shared_read(q: torch.Tensor, cache: Dict[str, torch.Tensor], idx: int,
                 spec: AttnSpec) -> torch.Tensor:
    """``_shared_decode``'s read of the post-write leaves (k/v (B, S, Kv,
    hd), pos (S,), fp8 scales)."""
    s_len = cache["k"].shape[1]
    ck, cv = _read_kv(_kv_view(cache["k"]), _kv_view(cache["v"]),
                      cache.get("k_scale"), cache.get("v_scale"), q.dtype)
    cpos = cache["pos"]
    b, t = q.shape[:2]
    if spec.use_kernel:
        q_pos = torch.full((b, t), idx, dtype=torch.int32, device=q.device)
        k_pos = cpos[None, :].expand(b, s_len).contiguous()
        return batch_attention(q, ck, cv, q_pos, k_pos, scale=spec.scale,
                               window=spec.window)
    qh = q.reshape(b, t, spec.n_kv_heads, spec.n_heads // spec.n_kv_heads,
                   spec.head_dim)
    scores = _gqa_scores(qh, ck, spec.scale)              # (B,K,G,T,S)
    valid = (cpos >= 0) & (cpos <= idx)
    if spec.window:
        valid &= (idx - cpos) < spec.window
    probs = _masked_softmax(scores, valid[None, None, None, None, :])
    return _gqa_combine(probs, cv).reshape(b, t, -1)


def _slot_decode(q: torch.Tensor, cache: Dict[str, torch.Tensor],
                 idx: torch.Tensor, spec: AttnSpec) -> torch.Tensor:
    """Per-slot decode attention over the POST-WRITE rows: q (B, 1, H, hd)
    at per-row absolute index ``idx`` (B,); kernel ``batch_attention``
    under ``use_kernel``, else the plain masked softmax.  Returns
    (B, 1, H * hd)."""
    if spec.use_kernel:
        ck, cv = _read_kv(_kv_view(cache["k"]), _kv_view(cache["v"]),
                          cache.get("k_scale"), cache.get("v_scale"),
                          q.dtype)
        return batch_attention(q, ck, cv, idx[:, None], cache["pos"],
                               scale=spec.scale)
    return _view_attention(q, cache, idx[:, None], spec)


def _kv_view(t: torch.Tensor) -> torch.Tensor:
    """A per-row K or V view (B, S, Kv, hd) as the cached modes read it:
    the long-context cache is laid out over ``kv_seq``."""
    return constrain(t, ("batch", "kv_seq", "kv_heads", None))


def _u8(t: torch.Tensor) -> torch.Tensor:
    """fp8 payloads move as bytes through index ops."""
    return t.view(torch.uint8) if is_fp8_dtype(t.dtype) else t


def _put(dst_tensor: torch.Tensor, dst: torch.Tensor, new: torch.Tensor,
         src: torch.Tensor) -> None:
    _u8(dst_tensor)[dst] = _u8(new)[src]
