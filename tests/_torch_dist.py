"""Rank bodies of the port's multi-process tests (``tests/test_torch_sharded
.py``): gloo ranks on the CPU, spawned with a ``FileStore``, each running
one function of this module and saving what it returns for the parent to
check.  This module imports torch and the port only (no JAX), so a spawned
rank starts in a few seconds."""

import datetime
import os

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as tree_util
from repro_torch.checkpoint import store
from repro_torch.configs import onerec_v2
from repro_torch.core.ptq import quantize_params
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed import compression, elastic
from repro_torch.distributed import sharding as sh
from repro_torch.launch import mesh as mesh_mod
from repro_torch.layers import moe
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm

TIMEOUT = datetime.timedelta(seconds=120)


def run(world: int, fn, args, tmpdir: str, device: str = "cpu"):
    """``fn(rank, world, *args)`` in ``world`` spawned gloo ranks; returns
    each rank's result.  A rank that raises makes this raise."""
    # gloo finds the loopback interface by name on a host without a network
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    torch.multiprocessing.spawn(_entry, args=(world, tmpdir, fn, args,
                                              device), nprocs=world)
    return [torch.load(os.path.join(tmpdir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _entry(rank, world, tmpdir, fn, args, device):
    torch.set_num_threads(1)
    if device == "cuda":
        from repro_torch.device import resolve_device
        torch.cuda.set_device(0)         # every rank shares the one card
        resolve_device("cuda")           # the parent's product settings
    fstore = dist.FileStore(os.path.join(tmpdir, "store"), world)
    dist.init_process_group("gloo", store=fstore, rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        out = fn(rank, world, *args)
        torch.save(out, os.path.join(tmpdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def jax_leaves(t):
    """(JAX path, leaf) of a tree, ``QuantizedTensor`` children as ``/0``,
    ``/1``, ``/2``."""
    for path, leaf in tree_util.leaves_with_path(t):
        if isinstance(leaf, QuantizedTensor):
            for i, name in enumerate(("data", "scale", "act_scale")):
                if getattr(leaf, name) is not None:
                    yield f"{path}/{i}", getattr(leaf, name)
        else:
            yield path, leaf


def local_tree(t):
    """A tree of DTensors -> {JAX path: (local shard, placements, the
    shard's strides)}."""
    return {p: (d.to_local(), str(list(d.placements)), d.to_local().stride())
            for p, d in jax_leaves(t)}


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def rank_params(cfg, fp8: bool, e_start: int, e_local: int, device="cpu"):
    """Reduced OneRec-V2 from seed 0, made layer by layer (PTQ'd when
    ``fp8``), each layer cut to this rank's experts as it is made."""
    def transform(path, t):
        if fp8:
            t = quantize_params(t, prefix=path)
        return moe.keep_experts(t, e_start, e_local)
    return onerec.init_onerec(0, cfg, device=device, transform=transform)


def ep_outputs(params, cfg, x, batch, spec):
    """apply_moe of layer 0 (the config's spec and a tight one that drops
    tokens), the prefill's last logits, and ``generate_items``."""
    lp = tree_util.index(params["backbone"]["stacks"]["0"]["p0"]["moe"], 0)
    tight = spec._replace(capacity_factor=0.5)
    cache = onerec.init_cache(cfg, batch["tokens"].shape[0],
                              device=x.device)
    logits, _ = onerec.prefill(params, batch, cfg, cache)
    return {"moe": moe.apply_moe(lp, x, spec),
            "moe_tight": moe.apply_moe(lp, x, tight),
            "logits": logits,
            "items": onerec.generate_items(params, batch, cfg)}


def ep_job(rank, world, meshes, x, batch, device="cpu"):
    """For each (n_data, n_model) mesh and raw / fp8 params: this rank's
    EP outputs on its data shard's rows."""
    cfg = onerec_v2.reduced_config()
    spec = tfm.moe_spec_for(cfg.transformer)
    dev = torch.device(device)
    out = {}
    for n_data, n_model in meshes:
        mesh = mesh_mod.make_debug_mesh(n_data, n_model, device_type=device)
        d, m = mesh.get_coordinate()
        e_local = spec.n_experts_padded // n_model
        rows = slice(d * x.shape[0] // n_data, (d + 1) * x.shape[0] // n_data)
        for fp8 in (False, True):
            params = rank_params(cfg, fp8, m * e_local, e_local, dev)
            with sh.use_mesh(mesh, sh.INFER_RULES):
                res = ep_outputs(params, cfg, x[rows].to(dev),
                                 {k: v[rows].to(dev) for k, v in batch.items()},
                                 spec)
            out[(n_data, n_model, fp8)] = {
                k: v.cpu() for k, v in res.items()}
    return out


# ---------------------------------------------------------------------------
# compressed_psum, constrain on DTensors, sharded restores
# ---------------------------------------------------------------------------


def psum_grads(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    grads = {"a": torch.randn(3, 5, generator=g) * 3.0,
             "b": {"c": torch.randn(257, generator=g) * 1e-3}}
    res = {"a": torch.randn(3, 5, generator=g) * 1e-2,
           "b": {"c": torch.randn(257, generator=g) * 1e-6}}
    return grads, res


def psum_job(mesh, axis):
    grads, res = psum_grads(dist.get_rank())
    with sh.use_mesh(mesh):
        a = compression.compressed_psum(grads, axis, res)
        b = compression.compressed_psum(grads, axis, res)
    return {"reduced": a[0], "residuals": a[1], "rerun": b[0]}


def constrain_job(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    g = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    g3 = g[:3].clone()
    out = {}
    with sh.use_mesh(mesh, sh.TRAIN_RULES):
        kept = sh.constrain(distribute_tensor(g, mesh, [Shard(0), Shard(2)]),
                            ("batch", "seq", "mlp"))
        rep = sh.constrain(distribute_tensor(g, mesh, [Shard(0), Shard(2)]),
                           ("batch", None, None))
        drop = sh.constrain(distribute_tensor(g3, mesh,
                                              [Replicate(), Replicate()]),
                            ("batch", "seq", "mlp"))
    for name, t in (("kept", kept), ("replicate", rep), ("dropped", drop)):
        out[name] = (str(list(t.placements)), t.full_tensor(), t.to_local())
    return out


def dtensor_moe(mesh, x):
    """Layer 0's ``apply_moe`` with raw experts as DTensors sharded over
    ``model`` on their expert axis (each rank's local shard its own)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    cfg = onerec_v2.reduced_config()
    params = onerec.init_onerec(0, cfg, device="cpu")
    lp = tree_util.index(params["backbone"]["stacks"]["0"]["p0"]["moe"], 0)
    lp = dict(lp, experts=tree_util.map_with_path(
        lambda _, w: distribute_tensor(w, mesh, [Replicate(), Shard(0)]),
        lp["experts"]))
    with sh.use_mesh(mesh, sh.INFER_RULES):
        return moe.apply_moe(lp, x, tfm.moe_spec_for(cfg.transformer))


def template(cfg):
    """The PTQ'd reduced OneRec-V2 tree on ``meta``: no values."""
    return quantize_params(onerec.init_onerec(0, cfg, device="meta"))


def world4_job(rank, world, x, batch, jax_ckpt):
    """(2, 2) and (1, 4): EP, ``compressed_psum``, ``constrain`` on
    DTensors and the JAX checkpoint restored under both rule sets."""
    out = {"ep": ep_job(rank, world, ((2, 2), (1, 4)), x, batch)}
    m22 = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    m14 = mesh_mod.make_debug_mesh(1, 4, device_type="cpu")
    out["coord22"] = list(m22.get_coordinate())
    out["psum"] = {("22", "data"): psum_job(m22, "data"),
                   ("22", "model"): psum_job(m22, "model"),
                   ("14", "model"): psum_job(m14, "model")}
    out["constrain"] = constrain_job(m22)
    out["moe_dtensor"] = dtensor_moe(m14, x)
    cfg = onerec_v2.reduced_config()
    for name, rules in (("train", sh.TRAIN_RULES), ("infer", sh.INFER_RULES)):
        restored, _ = elastic.restore_elastic(jax_ckpt, template(cfg), m22,
                                              rules)
        out[name] = local_tree(restored)
    return out


ELASTIC_TREE_SHAPE = (2, 16, 32)


def elastic_tree():
    return {"stacks": {"0": {"p0": {"attn": {"q_proj": {"kernel":
            torch.arange(2 * 16 * 32, dtype=torch.float32).reshape(
                ELASTIC_TREE_SHAPE)}}}}}}


def elastic_job(rank, world, ckpt_dir):
    """Save on (2, 4), restore on (4, 2)."""
    from torch.distributed.tensor import distribute_tensor
    tree = elastic_tree()
    mesh_a = mesh_mod.make_debug_mesh(2, 4, device_type="cpu")
    shard_a = elastic.shardings_for_tree(tree, mesh_a)
    placed = tree_util.map_with_path(
        lambda p, t: distribute_tensor(t, mesh_a, dict(
            tree_util.leaves_with_path(shard_a))[p].placements), tree)
    path = store.save_checkpoint(ckpt_dir, 1, placed)
    mesh_b = mesh_mod.make_debug_mesh(4, 2, device_type="cpu")
    meta = tree_util.map_with_path(lambda _, t: t.to("meta"), tree)
    restored, manifest = elastic.restore_elastic(path, meta, mesh_b)
    leaf = restored["stacks"]["0"]["p0"]["attn"]["q_proj"]["kernel"]
    return {"path": path, "hash": manifest["hash"],
            "coord": list(mesh_b.get_coordinate()),
            "placements": str(list(leaf.placements)),
            "local": leaf.to_local(), "full": leaf.full_tensor()}


# ---------------------------------------------------------------------------
# tensor parallelism (N9e.1)
# ---------------------------------------------------------------------------


class NoFunctionalCollectives(TorchDispatchMode):
    """Records every functional collective dispatched in the block: the
    tensor-parallel path must run none (gloo runs none on CUDA tensors)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("_c10d_functional"):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


def _lay_out(tree, mesh):
    from repro_torch.launch import steps
    return sh.lay_out_tree(tree, steps.params_axes(tree), mesh,
                           sh.INFER_RULES)


def _local_part(t):
    """(local shard, row range, last-dim range) of a DTensor output."""
    mesh = t.device_mesh
    rows = sh.shard_range(mesh, t.placements, 0, t.shape[0])
    cols = sh.shard_range(mesh, t.placements, t.ndim - 1, t.shape[-1])
    return t.to_local(), rows, cols


def tp_serve(params, batch, cfg, mesh, decode_tok, index):
    """OneRec ``prefill`` into a cache laid out over ``kv_seq``, then one
    ``decode_step`` and ``generate_items``, on laid-out params and batch."""
    from repro_torch.launch import steps
    p = _lay_out(params, mesh)
    with sh.use_mesh(mesh, sh.INFER_RULES):
        b = sh.lay_out_tree(batch, steps.batch_axes(batch, {
            "tokens": ("batch", "seq"), "profile": ("batch", None)}))
        cache = sh.lay_out_cache(onerec.init_cache(
            cfg, batch["tokens"].shape[0]), b["tokens"])
        logits, cache = onerec.prefill(p, b, cfg, cache)
        tok = sh.lay_out_tree({"tokens": decode_tok},
                              {"tokens": ("batch", "seq")})["tokens"]
        dec, _ = onerec.decode_step(p, tok, cfg, cache, index)
        items = onerec.generate_items(p, b, cfg)
    return {"prefill": _local_part(logits), "decode": _local_part(dec),
            "items": _local_part(items)}


def tp_lm(params, cfg, mesh, tokens, decode_tok):
    """A dense LM's prefill and one decode step on laid-out params."""
    p = _lay_out(params, mesh)
    with sh.use_mesh(mesh, sh.INFER_RULES):
        tok = sh.lay_out_tree({"tokens": tokens},
                              {"tokens": ("batch", "seq")})["tokens"]
        cache = sh.lay_out_cache(tfm.init_kv_cache(
            cfg, tokens.shape[0], tokens.shape[1] + 1, per_slot=False), tok)
        logits, cache = tfm.prefill(p, tok, cfg, cache)
        nxt = sh.lay_out_tree({"tokens": decode_tok},
                              {"tokens": ("batch", "seq")})["tokens"]
        dec, _ = tfm.decode_step(p, nxt, cfg, cache, tokens.shape[1])
    return {"prefill": _local_part(logits), "decode": _local_part(dec)}


def tp_layouts(mesh, x, wq, w_raw, table, ids):
    """``matmul_any`` in the three layouts (fp8 and raw weights), an
    uncovered layout's error, and the vocabulary-parallel lookup."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.core import quant
    from repro_torch.layers.embedding import gather_rows
    rep = [Replicate()] * mesh.ndim
    on_model = [Shard(1) if a == "model" else Replicate()
                for a in mesh.mesh_dim_names]
    on_rows = [Shard(0) if a == "model" else Replicate()
               for a in mesh.mesh_dim_names]
    out = {}
    xd = DTensor.from_local(x, mesh, rep)
    for name, w in (("fp8", wq), ("raw", w_raw)):
        col = sh.lay_out_tree({"k": w}, {"k": (None, "mlp")}, mesh,
                              sh.INFER_RULES)["k"]
        out[f"column_{name}"] = _local_part(quant.matmul_any(xd, col))
        row = sh.lay_out_tree({"k": w}, {"k": ("mlp", None)}, mesh,
                              sh.INFER_RULES)["k"]
        off, n = sh.shard_range(mesh, on_model, 1, x.shape[1])
        xs = DTensor.from_local(x[:, off:off + n].contiguous(), mesh,
                                on_model)
        out[f"row_{name}"] = _local_part(quant.matmul_any(xs, row))
        try:
            quant.matmul_any(xs, col)
            out[f"uncovered_{name}"] = None
        except ValueError as e:
            out[f"uncovered_{name}"] = str(e)
        out[f"k_major_{name}"] = [
            t.data.to_local().stride(-2) == 1 for t in (col, row)
            if isinstance(t, QuantizedTensor)]
    tab = sh.lay_out_tree({"t": table}, {"t": ("vocab", None)}, mesh,
                          sh.INFER_RULES)["t"]
    assert list(tab.placements) == on_rows
    out["rows"] = _local_part(gather_rows(tab, DTensor.from_local(
        ids, mesh, rep)))
    return out


def tp_attention(mesh, lp, spec, x_pre, x_dec):
    """Layer 0's ``apply_attention``: a shared fill of the prompt, then one
    shared-index decode, on a cache laid out over ``kv_seq``; the outputs
    and the whole cache gathered after."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.layers import attention
    p = _lay_out(lp, mesh)
    rep = [Replicate()] * mesh.ndim
    t = x_pre.shape[1]
    with sh.use_mesh(mesh, sh.INFER_RULES):
        cache = attention.init_cache(x_pre.shape[0], t + 4, spec,
                                     per_slot=False)
        cache = sh.lay_out_cache(cache, DTensor.from_local(
            x_pre, mesh, rep))
        pre, _ = attention.apply_attention(
            p, DTensor.from_local(x_pre, mesh, rep), spec, cache=cache,
            fill_cache=True)
        dec, _ = attention.apply_attention(
            p, DTensor.from_local(x_dec, mesh, rep), spec, cache=cache,
            cache_index=t)
        whole = {n: sh.redistribute(c, rep).to_local()
                 for n, c in cache.items()}
    return {"prefill": pre.to_local(), "decode": dec.to_local(),
            "cache": whole, "kv_cache_placements": str(
                list(cache["k"].placements))}


def tp_job(rank, world, onerec_params, batch, decode_tok, index, lm_params,
           lm_tokens, lm_decode, layouts, attn):
    """(1, 4) and (2, 2): OneRec-V2 and a dense LM tensor and expert
    parallel, the product layouts, the lookup and the attention layer,
    with the functional collectives the path ran."""
    from repro_torch.configs import llama3_8b
    cfg = onerec_v2.reduced_config()
    out = {}
    for n_data, n_model in ((1, 4), (2, 2)):
        mesh = mesh_mod.make_debug_mesh(n_data, n_model, device_type="cpu")
        guard = NoFunctionalCollectives()
        with guard:
            res = {"onerec": tp_serve(onerec_params, batch, cfg, mesh,
                                      decode_tok, index),
                   "lm": tp_lm(lm_params, llama3_8b.reduced_config(), mesh,
                               lm_tokens, lm_decode),
                   "layouts": tp_layouts(mesh, *layouts)}
            if (n_data, n_model) == (1, 4):
                res["attention"] = tp_attention(mesh, *attn)
            res["rerun"] = tp_serve(onerec_params, batch, cfg, mesh,
                                    decode_tok, index)
        res["functional"] = guard.seen
        out[n_data, n_model] = res
    return out
