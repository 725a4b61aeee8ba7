"""Rank bodies of the port's multi-process tests (``tests/test_torch_sharded
.py``): gloo ranks on the CPU, spawned with a ``FileStore``, each running
one function of this module and saving what it returns for the parent to
check.  This module imports torch and the port only (no JAX), so a spawned
rank starts in a few seconds."""

import dataclasses
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


def tp_slots(params, cfg, inp, mesh):
    """``cached_modes.slot_run`` of the whole batch's steps on ``mesh``
    with ``params`` laid out by the JAX rules, and the collectives' tags
    it ran."""
    from repro_torch.serving import cached_modes
    sh.STATS = {}
    try:
        res = cached_modes.slot_run(_lay_out(params, mesh), cfg,
                                    cached_modes.slot_steps(inp, slice(None)),
                                    torch.device("cpu"), mesh)
        res["tags"] = sorted({tag for tag, _ in sh.STATS})
    finally:
        sh.STATS = None
    return res


def tp_job(rank, world, onerec_params, batch, decode_tok, index, lm_params,
           lm_tokens, lm_decode, layouts, attn, slots):
    """(1, 4) and (2, 2): OneRec-V2 and a dense LM tensor and expert
    parallel, the product layouts, the lookup, the attention layer and
    the cached modes (``slots``: a config and ``slot_inputs``), with the
    functional collectives the path ran."""
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
                   "layouts": tp_layouts(mesh, *layouts),
                   "slots": tp_slots(onerec_params, *slots, mesh)}
            if (n_data, n_model) == (1, 4):
                res["attention"] = tp_attention(mesh, *attn)
            res["rerun"] = tp_serve(onerec_params, batch, cfg, mesh,
                                    decode_tok, index)
        res["functional"] = guard.seen
        out[n_data, n_model] = res
    return out


# ---------------------------------------------------------------------------
# the sharded train step (N9e.3)
# ---------------------------------------------------------------------------


TRAIN_MESHES = (((1, 4), "train"), ((2, 2), "train"), ((2, 2), "train_fsdp"))


def full(t):
    """A DTensor gathered whole (c10d only), as a plain tensor."""
    from torch.distributed.tensor import Replicate
    return sh.redistribute(t, [Replicate()] * t.device_mesh.ndim
                           ).to_local().clone()


def sharded_step(loss_fn, params, batch, mesh, rules, batch_axes):
    """One train step on ``mesh`` under ``rules``: params and their AdamW
    state laid out by ``steps.params_axes``, the batch by ``batch_axes``;
    the loss, every gradient and the params, ``mu`` and ``nu`` after the
    update gathered whole, each gradient's and each updated param's local
    shard beside its offsets, and the functional collectives the step
    ran."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init, adamw_update
    params = tree_util.map_with_path(lambda _, t: t.clone(), params)
    opt = adamw_init(params)
    p = sh.lay_out_tree(params, steps.params_axes(params), mesh, rules)
    o = sh.lay_out_tree(opt, steps.params_axes(opt), mesh, rules)
    b = sh.lay_out_tree(batch, steps.batch_axes(batch, batch_axes), mesh,
                        rules)
    guard = NoFunctionalCollectives()
    with guard, sh.use_mesh(mesh, rules):
        loss, grads = tree_util.value_and_grad(loss_fn, p, b)
        g_full = tree_util.map_with_path(lambda _, t: full(t), grads)
        g_local = tree_util.map_with_path(_local_with_ranges, grads)
        p, o, _ = adamw_update(p, grads, o, steps.OPT_CFG)
        after = {name: tree_util.map_with_path(lambda _, t: full(t), tr)
                 for name, tr in (("params", p), ("mu", o["mu"]),
                                  ("nu", o["nu"]))}
    return {"loss": loss, "grads": g_full, "local": g_local, **after,
            "params_local": tree_util.map_with_path(_local_with_ranges, p),
            "functional": guard.seen}


def _local_with_ranges(_, t):
    """A DTensor's local shard (a copy) and its ``(offset, size)`` on each
    dim."""
    return (t.to_local().clone(),
            [sh.shard_range(t.device_mesh, t.placements, d, t.shape[d])
             for d in range(t.ndim)])


# The bounds of a sharded step against the port's world 1
# (``tests/test_torch_fsdp.py``'s docstring gives their reasons).
GRAD_REL_L2 = 3e-2
NU_REL_L2 = 6e-2                 # nu ~ g^2: twice the gradients' relative gap
SHARD_LOSS_REL = 1e-4
PARAM_STEPS = 2.0


def loss_fn(family, cfg):
    if family == "onerec":
        return lambda p, b: onerec.train_loss(p, b, cfg)
    return lambda p, b: tfm.train_loss(p, b, cfg)


def world1_step(family, cfg, params, batch):
    """The port's unsharded step: loss, gradients, params, mu, nu."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw_init, adamw_update
    params = tree_util.map_with_path(lambda _, t: t.clone(), params)
    loss, grads = tree_util.value_and_grad(loss_fn(family, cfg), params,
                                           batch)
    keep = tree_util.map_with_path(lambda _, t: t.clone(), grads)
    opt = adamw_init(params)
    params, opt, _ = adamw_update(params, grads, opt, steps.OPT_CFG)
    return {"loss": loss, "grads": keep, "params": params, "mu": opt["mu"],
            "nu": opt["nu"]}


def _rel_l2(got, ref) -> dict:
    """{path: rel. L2} of the >= 2-D leaves, and ``"1-D"`` for the 1-D
    leaves as one vector."""
    import numpy as np
    out, num, den = {}, 0.0, 0.0
    for path, r in ref.items():
        g = np.asarray(got[path], np.float64)
        r = np.asarray(r, np.float64)
        assert g.shape == r.shape, path
        err = np.linalg.norm(g - r)
        if r.ndim >= 2:
            out[path] = err / max(np.linalg.norm(r), 1e-30)
        else:
            num, den = num + err ** 2, den + np.linalg.norm(r) ** 2
    out["1-D"] = (num / max(den, 1e-60)) ** 0.5
    return out


def _flat(t):
    return {p: v.double().numpy() for p, v in tree_util.leaves_with_path(t)}


def check_step(res, ref):
    """One rank's step (``sharded_step``'s record) against a reference
    (numpy leaves by path)."""
    import numpy as np
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import cosine_schedule
    loss = float(res["loss"])
    assert abs(loss - ref["loss"]) <= SHARD_LOSS_REL * abs(ref["loss"]), (
        loss, ref["loss"])
    for name, bound in (("grads", GRAD_REL_L2), ("mu", GRAD_REL_L2),
                        ("nu", NU_REL_L2)):
        rel = _rel_l2(_flat(res[name]), ref[name])
        worst = max(rel, key=rel.get)
        assert rel[worst] <= bound, (name, worst, rel[worst])
    lr = float(cosine_schedule(steps.OPT_CFG)(
        torch.ones((), dtype=torch.int32)))
    for path, r in ref["params"].items():
        got = dict(tree_util.leaves_with_path(res["params"]))[path]
        dev = np.abs(got.double().numpy() - r).max()
        ulp = np.spacing(np.float32(np.abs(r).max()))
        assert dev <= PARAM_STEPS * lr + 4 * ulp, (path, dev, lr)


def numpy_ref(ref):
    return {"loss": float(ref["loss"]),
            **{k: _flat(ref[k]) for k in ("grads", "params", "mu", "nu")}}


def train_job(rank, world, cases):
    """Each case ``(name, family, cfg, params, batch)`` stepped on every
    mesh of ``TRAIN_MESHES``; OneRec-V2's (1, 4) step twice (a rerun)."""
    from repro_torch.launch import steps
    out = {}
    for name, family, cfg, params, batch in cases:
        if family == "onerec":
            fn = lambda p, b: onerec.train_loss(p, b, cfg)  # noqa: E731
            axes = steps._ONEREC_BATCH_AXES
        else:
            fn = lambda p, b: tfm.train_loss(p, b, cfg)  # noqa: E731
            axes = steps._TOKEN_AXES
        for (n_data, n_model), rules in TRAIN_MESHES:
            mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                            device_type="cpu")
            res = sharded_step(fn, params, batch, mesh,
                               sh.RULE_SETS[rules], axes)
            if family == "onerec" and (n_data, n_model) == (1, 4):
                res["rerun"] = sharded_step(fn, params, batch, mesh,
                                            sh.RULE_SETS[rules], axes)
            out[name, n_data, n_model, rules] = res
    out["bundle"] = bundle_step()
    out["transposes"] = transposes_job()
    return out


def transposes_job():
    """Each collective's backward on (2, 2) over ``data`` against its
    transpose worked by hand, under the step's convention (one loss,
    replicated: a sum over the ranks of each one's share): per case the
    gradient a rank gets and the one it should."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    g, d = mesh.get_group("data"), mesh.get_local_rank("data")
    base = torch.arange(8.0).reshape(4, 2)
    w = [torch.full((4, 2), 1.0) + torch.arange(8.0).reshape(4, 2) * k
         for k in (1.0, 2.0)]                    # w[d]: data rank d's
    w_rows = [w[k][2 * k:2 * k + 2] for k in (0, 1)]

    def total(share):
        return sh.psum(share, [g])

    out = {}
    x = (base + d).requires_grad_()
    total((sh.psum(x, [g]) * w[0]).sum()).backward()
    out["psum"] = (x.grad, w[0])
    x = base.clone().requires_grad_()
    total((sh.fan(x, [g]) * w[d]).sum()).backward()
    out["fan"] = (x.grad, w[0] + w[1])
    x = (base[2 * d:2 * d + 2] + d).requires_grad_()
    total((sh.gather(x, 0, g) * w[d]).sum()).backward()
    out["gather"] = (x.grad, (w[0] + w[1])[2 * d:2 * d + 2])
    x = (base + d).requires_grad_()
    total((sh.sum_scatter(x, 0, g) * w_rows[d]).sum()).backward()
    out["sum_scatter"] = (x.grad, torch.cat(w_rows))
    x = base.clone().requires_grad_()
    rep = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                             run_check=False)
    kept = sh.redistribute(rep, [Shard(0), Replicate()]).to_local()
    total((kept * w_rows[d]).sum()).backward()
    out["keep"] = (x.grad, torch.cat(w_rows))
    return out


def bundle_step():
    """The OneRec-V2 train bundle (reduced, smoke shape) laid out by
    ``steps.shard_args`` under ``TRAIN_RULES_FSDP`` on (2, 2) and stepped
    by its own ``fn``: the loss, the step counter, and whether every
    param moved."""
    from repro_torch.launch import steps
    b = steps.build_bundle("onerec-v2", "train_b512", reduced=True,
                           device="cpu",
                           shape_override=steps.SMOKE_SHAPES["onerec"][
                               "train"])
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    params, opt, batch = steps.shard_args(b, mesh, sh.TRAIN_RULES_FSDP)
    before = {p: t.to_local().clone()
              for p, t in tree_util.leaves_with_path(params)}
    with sh.use_mesh(mesh, sh.TRAIN_RULES_FSDP):
        loss, params, opt = b.fn(params, opt, batch)
    moved = all(not torch.equal(t.to_local(), before[p])
                for p, t in tree_util.leaves_with_path(params)
                if t.ndim >= 2)
    return {"loss": loss, "step": int(sh.local_shard(opt["step"])),
            "moved": moved, "grad_norm": b.fn.metrics["grad_norm"]}


# ---------------------------------------------------------------------------
# sequence parallelism (N9e.6)
# ---------------------------------------------------------------------------


SP_MESHES = ((1, 4), (2, 2))


def _batch_axes(family):
    from repro_torch.launch import steps
    return steps._ONEREC_BATCH_AXES if family == "onerec" \
        else steps._TOKEN_AXES


def sp_step(fn, params, batch, mesh, rules, axes):
    """``sharded_step`` with the collectives' tags it ran
    (``sharding.STATS``) and the placements of the residual stream at
    each layer boundary (the ``layer_out`` taps)."""
    from repro_torch.core.stats import capture_taps
    sh.STATS = {}
    try:
        with capture_taps() as taps:
            res = sharded_step(fn, params, batch, mesh, rules, axes)
        res["tags"] = sorted({tag for tag, _ in sh.STATS})
    finally:
        sh.STATS = None
    res["boundary"] = [str(list(t.placements)) for name, t in taps.items()
                       if name.startswith("layer_out")]
    return res


def sp_job(rank, world, cases, onerec_case):
    """Each case ``(name, family, cfg, params, batch, meshes)`` stepped
    under ``TRAIN_RULES_SP`` on each of its meshes, the bytes autograd
    saves a layer counted in its (1, 4) step (``tfm.count_saved``); the
    first case's (1, 4) step twice (a rerun); ``onerec_case`` stepped on
    (1, 4) under both rules (its T + 1 positions do not split four ways),
    the saved bytes of its ``TRAIN_RULES`` step counted; the transposes of
    ``sharding.unsplit`` and ``match``."""
    out = {}
    quad = mesh_mod.make_debug_mesh(1, 4, device_type="cpu")
    for i, (name, family, cfg, params, batch, meshes) in enumerate(cases):
        fn, axes = loss_fn(family, cfg), _batch_axes(family)
        for n_data, n_model in meshes:
            mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                            device_type="cpu")
            with tfm.count_saved() as saved:
                res = sp_step(fn, params, batch, mesh, sh.TRAIN_RULES_SP,
                              axes)
            if (n_data, n_model) == (1, 4):
                out[name, "saved"] = list(saved)
                if i == 0:
                    res["rerun"] = sharded_step(fn, params, batch, mesh,
                                                sh.TRAIN_RULES_SP, axes)
            out[name, n_data, n_model] = res
    name, family, cfg, params, batch = onerec_case
    for rules in ("train", "train_sp"):
        with tfm.count_saved() as saved:
            out[name, rules] = sp_step(loss_fn(family, cfg), params, batch,
                                       quad, sh.RULE_SETS[rules],
                                       _batch_axes(family))
        out[name, rules]["saved"] = list(saved)
    out["transposes"] = sp_transposes_job(quad)
    return out


def sp_transposes_job(mesh):
    """On (1, 4), x (2, 8) split by sequence over ``model``: ``unsplit``
    gathers it whole, each rank's share of the loss weighs it by ``w``
    times its rank + 1 after ``fan`` (so the cotangent of the whole is ten
    times ``w`` on every rank), and its backward keeps the rank's slice;
    ``match`` of a replicated y to x's layout, each rank's slice weighed
    by ``w``'s, gathers ``w`` back whole.  Each as (got, want); and the
    moves each refuses."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m, g = mesh.get_local_rank("model"), mesh.get_group("model")
    cols = slice(2 * m, 2 * m + 2)
    w = torch.arange(16.0).reshape(2, 8) + 1.0
    split, rows = [Shard(0), Shard(1)], [Shard(0), Replicate()]
    out = {}
    with sh.use_mesh(mesh, sh.TRAIN_RULES_SP):
        x = (torch.arange(16.0).reshape(2, 8)[:, cols]).requires_grad_()
        whole = sh.unsplit(DTensor.from_local(x, mesh, split,
                                              run_check=False),
                           ("batch", "seq"))
        share = (sh.fan(whole.to_local(), [g]) * w * (m + 1)).sum()
        sh.psum(share, [g]).backward()
        out["unsplit"] = (x.grad, 10.0 * w[:, cols])
        y = torch.ones(2, 8, requires_grad=True)
        like = DTensor.from_local(torch.zeros(2, 2), mesh, split,
                                  run_check=False)
        kept = sh.match(DTensor.from_local(y, mesh, rows, run_check=False),
                        like)
        sh.psum((kept.to_local() * w[:, cols]).sum(), [g]).backward()
        out["match"] = (y.grad, w)
        rep = DTensor.from_local(torch.zeros(2, 8), mesh, [Replicate()] * 2,
                                 run_check=False)
        refused = []
        for move in (lambda: sh.unsplit(rep, ("batch", "act_seq")),
                     lambda: sh.match(like, rep)):
            try:
                move()
                refused.append(None)
            except ValueError as e:
                refused.append(str(e))
        out["refused"] = refused
    return out


# ---------------------------------------------------------------------------
# row-sharded lookups and segment sums (N9e.5, N9e.10)
# ---------------------------------------------------------------------------


# the rules a mesh's score and retrieval calls run under: the JAX dry run's
# INFER_RULES beside TRAIN_RULES (the same batch, candidate and table
# layouts), and TRAIN_RULES_FSDP itself (the batch over both axes)
SERVE_RULES = {"train": "infer", "train_fsdp": "train_fsdp"}
GNN_AXES = {"feat": ("nodes", None), "coord": ("nodes", None),
            "edges": ("edges", None), "edge_mask": ("edges",),
            "node_mask": ("nodes",), "graph_ids": ("nodes",)}


def gnn_axes(level: str) -> dict:
    return dict(GNN_AXES, labels=(None,) if level == "graph"
                else ("nodes",))


def serve_on(fn, params, batch, mesh, rules):
    """``fn(params, batch)`` (a score or retrieval call) on ``mesh``: the
    output gathered whole, its placements, the functional collectives."""
    from repro_torch.launch import steps
    p = sh.lay_out_tree(params, steps.params_axes(params), mesh, rules)
    b = sh.lay_out_tree(batch, steps.batch_axes(
        batch, steps._RECSYS_BATCH_AXES), mesh, rules)
    guard = NoFunctionalCollectives()
    with guard, sh.use_mesh(mesh, rules):
        out = fn(p, b)
    return {"out": full(out), "placements": str(list(out.placements)),
            "functional": guard.seen}


def lookup_on(table, ids, mesh, rules):
    """The sharded lookup of ``ids`` (laid out as a batch's histories) in
    ``table`` (laid out as ``item_embed``), in f32 and bf16, whole."""
    from repro_torch.layers.embedding import gather_rows
    p = sh.lay_out_tree({"item_embed": {"table": table}},
                        {"item_embed": {"table": ("table_rows", None)}},
                        mesh, rules)["item_embed"]["table"]
    b = sh.lay_out_tree({"ids": ids}, {"ids": ("batch", None)}, mesh,
                        rules)["ids"]
    with sh.use_mesh(mesh, rules):
        return {"f32": full(gather_rows(p, b)),
                "bf16": full(gather_rows(p, b, torch.bfloat16)),
                "table": str(list(p.placements)),
                "ids": str(list(b.placements))}


RUNNER_STEPS, RUNNER_EVERY, RUNNER_FAULTS = 4, 2, {3: 1}


def runner_job(ckpt_dir: str):
    """Reduced DIN on (2, 2) under ``TRAIN_RULES`` through the runner
    (``launch.train.training_for`` with a mesh): ``RUNNER_STEPS`` steps, a
    checkpoint every ``RUNNER_EVERY``, faults ``RUNNER_FAULTS``, then a
    clean run; each run's local shards beside their offsets, restarts,
    losses and checkpoints, both under the functional-collective
    detector; a synchronous sharded save of the clean run's state (its
    detector's record too) and that state gathered (rank 0's; None
    elsewhere)."""
    from repro_torch.configs import registry
    from repro_torch.distributed import FaultTolerantRunner, RunnerConfig
    from repro_torch.launch import steps, train
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    cfg = registry.get_arch("din").reduced_config()
    out = {}
    for name, faults in (("faulted", RUNNER_FAULTS), ("clean", None)):
        init, step_fn, batch_fn, _ = train.training_for(
            "recsys", cfg, batch=16, seq=0, compress_grads=False,
            opt_cfg=steps.OPT_CFG, seed=0, device="cpu", mesh=mesh)
        d = os.path.join(ckpt_dir, name)
        runner = FaultTolerantRunner(
            step_fn, batch_fn, init, RunnerConfig(
                total_steps=RUNNER_STEPS, ckpt_every=RUNNER_EVERY,
                ckpt_dir=d, keep=3), fail_at=faults)
        guard = NoFunctionalCollectives()
        with guard:
            state, summary = runner.run()
        out[name] = {
            "local": tree_util.map_with_path(_local_with_ranges, state),
            "restarts": summary["restarts"], "dir": d,
            "losses": [float(m["loss"]) for m in summary["metrics"]],
            "ckpts": sorted(x for x in os.listdir(d)
                            if x.startswith("step_")),
            "functional": guard.seen}
    guard = NoFunctionalCollectives()
    with guard:
        out["sync_path"] = store.save_checkpoint(
            os.path.join(ckpt_dir, "sync"), RUNNER_STEPS, state)
    out["sync_functional"] = guard.seen
    out["gathered"] = store.gather_to_host(state)
    return out


# Edges a chunk of the node-level EGNN's step on (2, 2) in ``rows_job``:
# several chunks of each rank's own edges
MESH_EDGE_CHUNK = 8


def rows_job(rank, world, recsys_cases, egnn_cases, ckpt_dir=None):
    """Every recsys case ``(name, cfg, params, qparams, batch, one)`` and
    EGNN case ``(name, cfg, params, batch, level, n_graphs)`` on each mesh
    of ``TRAIN_MESHES``: a train step (``sharded_step``); for the recsys
    families also the scores (raw and PTQ'd towers) and one user's
    retrieval under ``SERVE_RULES``, and the history lookup; DIN's and the
    EGNN's (1, 4) step twice (a rerun); the node-level EGNN's (2, 2) step
    under ``TRAIN_RULES`` also in chunks of ``MESH_EDGE_CHUNK`` of the
    rank's edges (``"chunked"``); the collectives' transposes and
    ``at_use`` of the tables."""
    from repro_torch.launch import steps
    from repro_torch.models import gnn, recsys
    out = {}
    for name, cfg, params, qparams, batch, one in recsys_cases:
        serve_batch = {k: v for k, v in batch.items() if k != "labels"}
        for (n_data, n_model), rules in TRAIN_MESHES:
            mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                            device_type="cpu")
            train, serve = sh.RULE_SETS[rules], sh.RULE_SETS[
                SERVE_RULES[rules]]

            def loss_fn(p, b):
                return recsys.train_loss(p, b, cfg)
            res = {"train": sharded_step(loss_fn, params, batch, mesh, train,
                                         steps._RECSYS_BATCH_AXES)}
            if name == "din" and (n_data, n_model) == (1, 4):
                res["rerun"] = sharded_step(loss_fn, params, batch, mesh,
                                            train, steps._RECSYS_BATCH_AXES)
            res["score"] = serve_on(lambda p, b: recsys.score(p, b, cfg),
                                    params, serve_batch, mesh, serve)
            res["score_fp8"] = serve_on(
                lambda p, b: recsys.score(p, b, cfg), qparams, serve_batch,
                mesh, serve)
            res["retrieval"] = serve_on(
                lambda p, b: recsys.retrieval_scores(p, b, cfg), params, one,
                mesh, serve)
            res["lookup"] = lookup_on(params["item_embed"]["table"],
                                      batch["hist_ids"], mesh, train)
            out[name, n_data, n_model, rules] = res
    for name, cfg, params, batch, level, n_graphs in egnn_cases:
        for (n_data, n_model), rules in TRAIN_MESHES:
            mesh = mesh_mod.make_debug_mesh(n_data, n_model,
                                            device_type="cpu")

            def loss_fn(p, b):
                return gnn.train_loss(p, b, cfg, level=level,
                                      n_graphs=n_graphs)
            res = {"train": sharded_step(loss_fn, params, batch, mesh,
                                         sh.RULE_SETS[rules],
                                         gnn_axes(level))}
            if (n_data, n_model) == (1, 4):
                res["rerun"] = sharded_step(loss_fn, params, batch, mesh,
                                            sh.RULE_SETS[rules],
                                            gnn_axes(level))
            if (n_data, n_model, rules, level) == (2, 2, "train", "node"):
                res["chunked"] = sharded_step(
                    lambda p, b: gnn.train_loss(
                        p, b, cfg, edge_chunk=MESH_EDGE_CHUNK),
                    params, batch, mesh, sh.RULE_SETS[rules],
                    gnn_axes(level))
            out[name, n_data, n_model, rules] = res
    out["rows_transposes"] = rows_transposes_job()
    out["bags"] = bags_job()
    out["at_use"] = at_use_job(recsys_cases[0][2])
    out["bundles"] = rows_bundles()
    if ckpt_dir is not None:
        out["runner"] = runner_job(ckpt_dir)
    return out


def _ints(shape, seed, high=4):
    """Small integers as f32: every sum of them is exact in any order."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-high, high + 1, shape, generator=g).float()


def rows_transposes_job():
    """On (2, 2) under ``TRAIN_RULES`` (tables over both axes, the batch
    over ``data``; nodes and edges over both), each sharded op's input
    gradient against autograd's of the same computation on whole tensors
    (every rank's the same), on integer-valued data so that any order of
    the sums gives the same bits: per case (the rank's slice of it, the
    rank's whole-tensor slice)."""
    from repro_torch.layers.embedding import gather_rows, segment_sum
    from repro_torch.models import gnn, recsys
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    rules = sh.TRAIN_RULES
    g = torch.Generator().manual_seed(5)
    table, w = _ints((40, 6), 1), _ints((8, 5, 6), 2)
    ids = torch.randint(0, 40, (8, 5), generator=g, dtype=torch.int32)
    n_nodes, n_edges = 16, 24
    vals, v_w = _ints((n_edges, 3), 3), _ints((n_nodes, 3), 4)
    seg = torch.randint(0, n_nodes, (n_edges,), generator=g)
    nodes, e_w = _ints((n_nodes, 3), 6), _ints((n_edges, 3), 7)
    src = torch.randint(0, n_nodes, (n_edges,), generator=g)
    users, items = _ints((8, 3), 8), _ints((8, 3), 9)

    def lay(t, axes):
        return sh.lay_out_tree({"t": t}, {"t": axes}, mesh, rules)["t"]

    def slice_of(whole, like):
        for d in range(whole.ndim):
            off, n = sh.shard_range(mesh, like.placements, d,
                                    whole.shape[d])
            whole = whole.narrow(d, off, n)
        return whole

    def both(make, sharded, plain, axes):
        """(the sharded op's input gradient, the rank's slice of the
        plain op's): ``make()`` the whole inputs, the first the one
        differentiated, ``axes`` their logical axes."""
        xs = make()
        ds = [lay(x, a) for x, a in zip(xs, axes)]
        leaf = ds[0].detach().requires_grad_()
        with sh.use_mesh(mesh, rules):
            sharded(leaf, *ds[1:]).backward()
        whole = xs[0].clone().requires_grad_()
        plain(whole, *xs[1:]).backward()
        return leaf.grad.to_local(), slice_of(whole.grad, ds[0])

    out = {}
    out["lookup"] = both(
        lambda: (table, ids, w),
        lambda t, i, v: sh.total(gather_rows(t, i) * v),
        lambda t, i, v: (gather_rows(t, i) * v).sum(),
        [("table_rows", None), ("batch", None), ("batch", None, None)])
    out["segment_sum"] = both(
        lambda: (vals, seg, v_w),
        lambda x, s, v: sh.total(segment_sum(x, s, n_nodes, like=v) * v),
        lambda x, s, v: (segment_sum(x, s, n_nodes) * v).sum(),
        [("edges", None), ("edges",), ("nodes", None)])
    out["edge_rows"] = both(
        lambda: (nodes, src, e_w),
        lambda x, s, v: sh.total(sh.local_call(
            lambda i: gather_rows(gnn._node_rows(x, s), i), s, like=v) * v),
        lambda x, s, v: (gather_rows(x, s) * v).sum(),
        [("nodes", None), ("edges",), ("edges", None)])
    out["in_batch"] = both(
        lambda: (items, users),
        lambda i, u: sh.total(recsys._in_batch(lambda a, b: a @ b.T, u, i)),
        lambda i, u: (u @ i.T).sum(),
        [("batch", None), ("batch", None)])
    return out


def bags_job():
    """``embedding_bag`` (sum, mean, max) of ids split with the batch over
    ``data`` into bags that span both data shards, and ``multi_hot_bag``
    of (8, 5) ids with padding, from a row-sharded table of small integers
    (every sum exact) on (2, 2) under ``TRAIN_RULES``: per case (whole
    output, world 1's)."""
    from repro_torch.layers.embedding import embedding_bag, multi_hot_bag
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    g = torch.Generator().manual_seed(11)
    table = {"table": _ints((40, 6), 12)}
    ids = torch.randint(0, 40, (16,), generator=g, dtype=torch.int32)
    seg = torch.arange(16) % 5
    hot = torch.randint(0, 40, (8, 5), generator=g, dtype=torch.int32)
    hot[:, 3:] = 0
    laid = sh.lay_out_tree(
        {"t": table["table"], "ids": ids, "seg": seg, "hot": hot},
        {"t": ("table_rows", None), "ids": ("batch",), "seg": ("batch",),
         "hot": ("batch", None)}, mesh, sh.TRAIN_RULES)
    t = {"table": laid["t"]}
    out = {}
    with sh.use_mesh(mesh, sh.TRAIN_RULES):
        for mode in ("sum", "mean", "max"):
            out[f"bag_{mode}"] = (
                full(embedding_bag(t, laid["ids"], laid["seg"], n_bags=5,
                                   mode=mode)),
                embedding_bag(table, ids, seg, n_bags=5, mode=mode))
            out[f"multi_hot_{mode}"] = (
                full(multi_hot_bag(t, laid["hot"], mode=mode)),
                multi_hot_bag(table, hot, mode=mode))
    return out


def at_use_job(params):
    """A recsys tree laid out on (2, 2) under ``TRAIN_RULES_FSDP`` (whose
    ``embed_fsdp`` is ``(data, model)``): what ``at_use`` moves with
    autograd on, the tables' placements before and after it, whether
    their local shards are the stored ones, and what one lookup's
    backward moves (``sharding.STATS`` tags)."""
    from repro_torch.launch import steps
    from repro_torch.layers.embedding import gather_rows
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    rules = sh.TRAIN_RULES_FSDP
    p = sh.lay_out_tree(params, steps.params_axes(params), mesh, rules)
    ids = sh.lay_out_tree({"i": torch.arange(8, dtype=torch.int32)[:, None]
                           * 3}, {"i": ("batch", None)}, mesh, rules)["i"]
    table = p["item_embed"]["table"].detach().requires_grad_()
    sh.STATS = {}
    try:
        with sh.use_mesh(mesh, rules):
            used = sh.at_use_tree({"item_embed": {"table": table},
                                   "field_embed": p["field_embed"]})
            at_use = dict(sh.STATS)
            sh.total(gather_rows(used["item_embed"]["table"], ids)
                     ).backward()
        lookup = dict(sh.STATS)
    finally:
        sh.STATS = None
    return {"at_use": at_use, "lookup": lookup,
            "stored": str(list(table.placements)),
            "used": str(list(used["item_embed"]["table"].placements)),
            "same_local": torch.equal(
                used["item_embed"]["table"].to_local(), table.to_local()),
            "grad": str(list(table.grad.placements))}


def rows_bundles():
    """The DIN train bundle and the EGNN graph bundle (reduced, smoke
    shapes) laid out by ``steps.shard_args`` under ``TRAIN_RULES`` on
    (2, 2) and stepped by their own ``fn``: the loss, the step counter,
    and whether every >= 2-D param moved."""
    from repro_torch.launch import steps
    mesh = mesh_mod.make_debug_mesh(2, 2, device_type="cpu")
    out = {}
    for arch, shape, smoke in (("din", "train_batch", ("recsys", "train")),
                               ("egnn", "full_graph_sm", ("gnn", "graph"))):
        b = steps.build_bundle(arch, shape, reduced=True, device="cpu",
                               shape_override=steps.SMOKE_SHAPES[smoke[0]][
                                   smoke[1]])
        params, opt, batch = steps.shard_args(b, mesh, sh.TRAIN_RULES)
        before = {p: t.to_local().clone()
                  for p, t in tree_util.leaves_with_path(params)}
        with sh.use_mesh(mesh, sh.TRAIN_RULES):
            loss, params, opt = b.fn(params, opt, batch)
        moved = all(not torch.equal(t.to_local(), before[p])
                    for p, t in tree_util.leaves_with_path(params)
                    if t.ndim >= 2)
        out[arch] = {"loss": loss, "moved": moved,
                     "step": int(sh.local_shard(opt["step"]))}
    return out
