"""Sparse MoE with capacity-bounded dispatch and a grouped GEMM expert path.

Route in f32 with top-k by a STABLE descending sort (ties to the lowest
expert index, as ``lax.top_k``), dispatch each assignment to a cumsum slot
of its expert's fixed-capacity buffer (assignments past capacity go to a
trash row that is cut off), run the grouped expert FFN over
``(E, capacity, d)`` buffers, and combine the weighted outputs back per
token.  The same arithmetic as ``repro/layers/moe.py`` ``_moe_local``.
Shared experts (``n_shared_experts``) are one dense gated MLP of width
``n_shared_experts * d_expert`` (``params["shared"]``) added to the routed
sum.

Expert parallelism (the JAX package's ``shard_map`` body): under a mesh
(``distributed.sharding.use_mesh``) whose ``model`` axis is larger than 1,
each rank holds ``n_experts_padded / ep`` experts (``model`` rank r the
experts ``r * e_local ..``: a DTensor sharded over ``model`` on its expert
axis, or a plain tree cut once by ``keep_experts``), routes its own token
slab (the rank's ``data`` shard, replicated over ``model``) with the
replicated router, runs only the assignments to its experts (the others
go to the trash slot), and the partial outputs are summed over the
``model`` group.  A local expert's slot positions count over its own
column, so every rank keeps and drops the tokens one rank would; with
top-2 each token's sum over ranks is its two contributions plus exact
zeros, rounded once, as one rank's combine rounds it: the same bits.
Under tensor parallelism the input is a ``DTensor`` replicated over
``model`` (after ``o_proj``'s all-reduce): its local slab goes through the
same body, and the summed result goes back as a ``DTensor`` of the
input's placements; the shared experts run as a tensor-parallel dense
MLP (``layers.mlp``).

Training (autograd on the local shards, the JAX ``shard_map``'s
transposes): tokens replicated over ``model`` enter the rank's experts
through ``sharding.fan`` (their cotangents, and the router's, summed over
``model``) and the partial outputs are summed by ``sharding.psum``.  Under
``TRAIN_RULES_FSDP`` the tokens are split over ``model`` too: the rank's
``data`` slab is gathered over ``model`` (a reduce-scatter backward), the
expert leaves (replicated there) are cut to the rank's experts, and the
partial outputs are reduce-scattered back to the rank's rows.  Under
``TRAIN_RULES_SP`` the tokens arrive split by sequence over ``model``:
they are gathered whole (``sharding.unsplit``), routed as the data slab
(the tokens and the router fanned over ``model``), the ranks' partial
outputs summed and sliced back to the input's layout
(``sharding.match``), the shared experts on the whole rows too.
Capacity counts a ``(pod, data)`` shard's tokens, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.core.quant import (QuantizedTensor, fp8_grouped_linear,
                                    fp8_grouped_matmul, matmul_any,
                                    raw_matmul)
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import (constrain, current_mesh,
                                              is_dtensor, local_shard,
                                              mesh_axes)
from repro_torch.layers.common import truncated_normal
from repro_torch.layers.embedding import gather_rows
from repro_torch.layers.mlp import ACTIVATIONS, apply_mlp, init_mlp


class MoESpec(NamedTuple):
    n_experts: int           # logical experts (may be < padded)
    n_experts_padded: int    # padded to a multiple of the EP degree
    top_k: int
    d_model: int
    d_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
    norm_topk_prob: bool = False


def make_moe_spec(n_experts: int, top_k: int, d_model: int, d_expert: int,
                  *, n_shared_experts: int = 0, capacity_factor: float = 1.25,
                  act: str = "silu", norm_topk_prob: bool = False,
                  ep_degree: int = 16) -> MoESpec:
    padded = int(math.ceil(n_experts / ep_degree) * ep_degree)
    return MoESpec(n_experts, padded, top_k, d_model, d_expert,
                   n_shared_experts, capacity_factor, act, norm_topk_prob)


def init_moe(gen: torch.Generator, spec: MoESpec, *,
             stack: Tuple[int, ...] = (), dtype=torch.float32,
             device=None) -> dict:
    e, d, f = spec.n_experts_padded, spec.d_model, spec.d_expert
    std_in, std_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)

    def tn(shape, std):
        return truncated_normal(shape, std, gen, device, dtype)

    params = {
        "router": {"kernel": tn((*stack, d, e), std_in)},
        # stacked per-expert kernels == the grouped-GEMM operands
        "experts": {
            "gate": tn((*stack, e, d, f), std_in),
            "up": tn((*stack, e, d, f), std_in),
            "down": tn((*stack, e, f, d), std_out),
        },
    }
    if spec.n_shared_experts:
        params["shared"] = init_mlp(gen, d, spec.n_shared_experts * f,
                                    stack=stack, dtype=dtype, device=device)
    return params


def _grouped_matmul(x: torch.Tensor, w) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N); w raw (``raw_matmul``) or a
    QuantizedTensor: block-scaled, or per-channel (fp8 where the dims are
    not 128-aligned, or int8 experts: the exact int8 grouped product)."""
    if isinstance(w, QuantizedTensor):
        if w.granularity == "block":
            return fp8_grouped_matmul(x, w)
        return fp8_grouped_linear(x, w)
    return raw_matmul(x, w.to(x.dtype), x.dtype)


def _grouped_ffn(buf: torch.Tensor, experts: dict, act: str) -> torch.Tensor:
    """The grouped GEMM expert FFN (the paper's quantization target)."""
    fn = ACTIVATIONS[act]
    g = _grouped_matmul(buf, experts["gate"])
    u = _grouped_matmul(buf, experts["up"])
    h = fn(g.to(torch.float32)).to(buf.dtype) * u
    return _grouped_matmul(h, experts["down"])


def _capacity(n_tokens: int, spec: MoESpec, n_shards: int) -> int:
    """Static per-expert capacity for the local token slab of ``n_tokens //
    n_shards`` tokens (``n_shards`` the data shards)."""
    t_loc = max(n_tokens // n_shards, 1)
    c = int(math.ceil(t_loc * spec.top_k * spec.capacity_factor
                      / spec.n_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def _route(router_kernel, xt: torch.Tensor, spec: MoESpec):
    """Router in f32.  Returns (weights (T, k), experts (T, k))."""
    logits = matmul_any(xt, router_kernel, out_dtype=torch.float32)
    if spec.n_experts_padded > spec.n_experts:  # mask padded experts
        bias = torch.zeros(spec.n_experts_padded, dtype=torch.float32,
                           device=xt.device)
        bias[spec.n_experts:] = -1e30
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :spec.top_k], topi[:, :spec.top_k]
    if spec.norm_topk_prob:
        topv = topv / (torch.sum(topv, dim=-1, keepdim=True) + 1e-9)
    return topv, topi


def _moe_local(params: dict, xt: torch.Tensor, spec: MoESpec, *,
               e_start: int, e_local: int, capacity: int) -> torch.Tensor:
    """Route -> dispatch -> grouped GEMM -> combine over the token slab
    ``xt`` (T, D), for the experts ``e_start .. e_start + e_local`` that
    ``params["experts"]`` holds; assignments to other experts go to the
    trash slot and add zero.  Under expert parallelism the caller sums
    the result over the ``model`` group."""
    t, d = xt.shape
    k = spec.top_k
    topv, topi = _route(params["router"]["kernel"], xt, spec)

    flat_e = topi.reshape(-1)                                # (T*k,)
    flat_w = topv.reshape(-1)
    token_id = torch.arange(t, device=xt.device).repeat_interleave(k)
    local = (flat_e >= e_start) & (flat_e < e_start + e_local)
    le = torch.where(local, flat_e - e_start, e_local)       # e_local: trash
    # position of each assignment within its expert, in flat order
    oh = torch.nn.functional.one_hot(le, e_local + 1)       # (T*k, E_loc+1)
    pos = ((torch.cumsum(oh, dim=0) - 1) * oh).sum(dim=1)
    keep = local & (pos < capacity)
    trash = e_local * capacity
    slot = torch.where(keep, le * capacity + pos, trash)

    # dispatch into the fixed (E_loc*C [+1 trash], D) buffer
    buf = torch.zeros((trash + 1, d), dtype=xt.dtype, device=xt.device)
    buf[slot] = gather_rows(xt, token_id)
    h = _grouped_ffn(buf[:-1].reshape(e_local, capacity, d),
                     params["experts"], spec.act)

    # combine: gather each kept assignment's output, weight, and add a
    # token's k contributions in order, each sum rounded to the activation
    # dtype: the JAX scatter-add's order on the CPU (top-k > 2 makes the
    # order matter), deterministic on the card (no atomics)
    contrib = gather_rows(h.reshape(trash, d),
                          torch.clamp(slot, max=trash - 1))
    contrib = contrib * (flat_w * keep).to(contrib.dtype)[:, None]
    contrib = contrib.reshape(t, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


def _local(w):
    """A rank's own part of a leaf: a DTensor's local shard."""
    return w.map_parts(local_shard) if isinstance(w, QuantizedTensor) \
        else local_shard(w)


def _rank_experts(experts: dict, e_local: int,
                  first: Optional[int] = None) -> dict:
    """The rank's expert tree, each leaf's expert axis exactly ``e_local``
    long (a rank never cuts a full tree per call; with ``first``, the
    training step's gathered leaves, replicated over ``model``, are cut
    to the experts ``first ..`` here, a view)."""
    def leaf(path, w):
        w = _local(w)
        n = (w.data if isinstance(w, QuantizedTensor) else w).shape[0]
        if first is not None and torch.is_tensor(w) and n > e_local:
            return w.narrow(0, first, e_local)
        if n != e_local:
            raise ValueError(
                f"experts/{path} holds {n} experts, a rank of this mesh "
                f"{e_local}: shard the expert tree once (a DTensor over "
                f"'model', or layers.moe.keep_experts)")
        return w
    return tree.map_with_path(leaf, experts)


def keep_experts(params: dict, e_start: int, e_local: int) -> dict:
    """``params`` with every MoE expert leaf (path ``.../experts/...``,
    stacked or not) cut to the experts ``e_start .. e_start + e_local``:
    fresh tensors in the source's layout (a K-major payload stays K-major,
    rows padded), so the rest can be freed.  Other leaves are shared."""
    def cut(t):
        part = t.narrow(t.ndim - 3, e_start, e_local)
        return tree.empty_like(part).copy_(part)

    def leaf(path, w):
        if "/experts/" not in f"/{path}":
            return w
        return w.map_parts(cut) if isinstance(w, QuantizedTensor) \
            else cut(w)
    return tree.map_with_path(leaf, params)


def apply_moe(params: dict, x: torch.Tensor, spec: MoESpec) -> torch.Tensor:
    """MoE FFN over x (B, S, D): all experts on this device, or expert
    parallel over the active mesh's ``model`` axis (module docstring);
    x a plain tensor (a rank's slab) or a ``DTensor``."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Shard
        mesh = x.device_mesh
        if mesh != current_mesh():
            raise ValueError("apply_moe: a DTensor input off the active "
                             "mesh")
        on_model = sh.placement_on(x, "model")
        if isinstance(on_model, Shard) and on_model.dim > 0:
            if on_model.dim == x.ndim - 1:
                raise ValueError("apply_moe: tokens split on their features")
            # TRAIN_RULES_SP: the rows gathered whole, routed as the data
            # slab, the ranks' partial outputs summed and sliced back
            whole = sh.unsplit(x, ("batch", "seq", "embed"), tag="ep-gather")
            return sh.match(apply_moe(params, whole, spec), x)
        # expert leaves replicated over ``model`` (TRAIN_RULES_FSDP's
        # gathered weights) are cut to the rank's experts per call
        cut = any(is_dtensor(w) and sh.placement_on(w, "model") != Shard(0)
                  for _, w in tree.leaves_with_path(params["experts"]))
        slab_params = {name: tree.map_with_path(
            lambda _, w: sh.param_local(w, x), params[name])
            for name in ("router", "experts")}
        xl = x.to_local()
        split = sh.placement_on(x, "model") == Shard(0)
        if split:               # TRAIN_RULES_FSDP: the data slab, gathered
            xl = sh.gather(xl, 0, mesh.get_group("model"), tag="ep-gather")
        out = DTensor.from_local(_moe_slab(slab_params, xl, spec,
                                           scatter=split, cut=cut),
                                 mesh, x.placements, run_check=False)
    else:
        out = _moe_slab(params, x, spec)
    if spec.n_shared_experts:
        out = out + apply_mlp(params["shared"], x, act=spec.act)
    return constrain(out, ("batch", "seq", "embed"))


def _moe_slab(params: dict, x: torch.Tensor, spec: MoESpec, *,
              scatter: bool = False, cut: bool = False) -> torch.Tensor:
    """The routed experts over a plain slab x (B, S, D) (``apply_moe``);
    ``scatter``: x is the ``model`` group's rows gathered, and each rank
    keeps its own rows of the sum; ``cut``: the expert leaves hold every
    expert, and the rank takes its own (``_rank_experts``)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    mesh = current_mesh()
    sizes = mesh_axes(mesh) if mesh is not None else {}
    ep = sizes.get("model", 1)
    if ep == 1:
        y = _moe_local(params, xt, spec, e_start=0,
                       e_local=spec.n_experts_padded,
                       capacity=_capacity(b * s, spec, 1))
    else:
        if spec.n_experts_padded % ep:
            raise ValueError(f"{spec.n_experts_padded} experts do not split "
                             f"over {ep} model ranks")
        e_local = spec.n_experts_padded // ep
        first = mesh.get_local_rank("model") * e_local if cut else None
        experts = _rank_experts(params["experts"], e_local, first)
        e_start = mesh.get_local_rank("model") * e_local
        n_dp = sizes.get("pod", 1) * sizes.get("data", 1)
        group = mesh.get_group("model")
        # tokens and router alike on every model rank unless the tokens
        # were gathered here (``scatter``): their cotangents sum over it
        fan = [] if scatter else [group]
        local = {"router": {"kernel": sh.fan(params["router"]["kernel"],
                                             fan, tag="ep-fan")},
                 "experts": experts}
        y = _moe_local(local, sh.fan(xt, fan, tag="ep-fan"), spec,
                       e_start=e_start, e_local=e_local,
                       capacity=_capacity(b * s * n_dp, spec, n_dp))
        # gloo sums bf16 as c10 does (f32 add, one rounding), so the bf16
        # partials are reduced as they are
        if scatter:
            return sh.sum_scatter(y.reshape(b, s, d), 0, group,
                                  tag="ep-sum")
        y = sh.psum(y, [group], tag="ep-sum")
    return y.reshape(b, s, d)


def load_balance_loss(params: dict, x: torch.Tensor,
                      spec: MoESpec) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style f_i * P_i) of the
    router ``params["router"]`` over x (B, S, D), as the JAX package's:
    the padded experts unmasked, top-k by a stable descending sort.  On a
    ``DTensor`` x split by rows the per-expert assignment counts and
    probability sums are summed over those mesh dims before the product
    (the JAX package computes this loss on global shapes)."""
    router = params["router"]["kernel"]
    groups = []
    if is_dtensor(x):
        router = sh.param_local(router, x)
        groups = sh.mesh_groups(x, "rows")
        n_tok = x.shape[0] * x.shape[1]
        x = x.to_local()
    xt = x.reshape(-1, spec.d_model)
    logits = matmul_any(xt, router, out_dtype=torch.float32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    topi = torch.sort(probs, dim=-1, descending=True,
                      stable=True)[1][:, :spec.top_k]
    onehot = torch.nn.functional.one_hot(
        topi, spec.n_experts_padded).to(torch.float32)
    if not groups:
        frac = torch.mean(onehot, dim=(0, 1))
        return spec.n_experts_padded * torch.sum(
            frac * torch.mean(probs, dim=0))
    count = sh.psum(onehot.sum(dim=(0, 1)), groups, tag="aux-sum")
    mass = sh.psum(probs.sum(dim=0), groups, tag="aux-sum")
    frac = count / (n_tok * spec.top_k)
    return spec.n_experts_padded * torch.sum(frac * (mass / n_tok))
