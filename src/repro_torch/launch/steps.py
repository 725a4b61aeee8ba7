"""Step construction for the ported (architecture x input-shape) cells.

``build_bundle(arch, shape)`` returns a :class:`StepBundle`: the step
function and its concrete arguments on one device (the card unless the
caller passes ``device="cpu"``), the JAX package's
``repro/launch/steps.py``: the five LMs and OneRec-V2 (``train``,
``prefill``, ``decode``), the four recsys architectures (``train``,
``score``, ``retrieval``) and the EGNN (``graph``, a training step).
Every bundle carries the logical axes of its arguments (``arg_axes``:
``params_axes``, ``batch_axes``, ``cache_axes``, the JAX package's
strings) and ``shard_args`` lays the arguments out on a mesh by them, as
``DTensor``s holding each rank's slice.  ``abstract=True`` builds the LM
and OneRec prefill and decode bundles on ``meta`` (the dry run's: shapes
and dtypes, no values); the other kinds wait for ROADMAP.md queue N
(train and graph N9e.3, recsys scoring N9e.5, ``ogb_products`` N9e.7).
The step functions run on the device of their inputs; under a mesh
(``distributed.sharding.use_mesh``) on the laid-out arguments they run
tensor and expert parallel.

Step signatures (uniform per kind):
  train:      step(params, opt_state, batch)          -> (loss, params, opt)
  prefill:    step(params, batch)                     -> (logits, cache)
  decode:     step(params, cache, batch, index)       -> (logits, cache)
  score:      step(params, batch)                     -> scores
  retrieval:  step(params, batch)                     -> scores
  graph:      step(params, opt_state, batch)          -> (loss, params, opt)

A training step is one ``tree.value_and_grad`` of the family's
``train_loss`` and one AdamW update with the JAX package's ``OPT_CFG``
(``optim.adamw_update``, in place: the params and the optimizer state
passed in are the ones returned).  Its params are f32, never PTQ'd.

Random parameters come from a ``torch.Generator`` seeded with ``seed`` on
the bundle's device, random inputs from another; with ``fp8`` the params
are PTQ'd with the paper's policy (an LM's layer by layer as they are made,
``models.transformer.init_transformer``'s ``transform``, so a full-width
LM never holds more than one raw layer on the card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.configs.base import (GNNConfig, OneRecConfig, RecsysConfig,
                                      ShapeSpec, TransformerConfig)
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.core.quant import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as sh
from repro_torch.models import gnn as gnn_model
from repro_torch.models import onerec as onerec_model
from repro_torch.models import recsys as recsys_model
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimizerConfig, adamw_init, adamw_update

OPT_CFG = OptimizerConfig()


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    arg_axes: Tuple[Any, ...] = ()     # logical-axes tree matching args
    donate: Tuple[int, ...] = ()       # args the step updates in place
    cfg: Any = None
    note: str = ""


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"queue N, item {item})")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` (on the CPU for ``meta``, whose random
    ops only make shapes)."""
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# Axes of the arguments, and their layout on a mesh
# ---------------------------------------------------------------------------


def params_axes(params: dict) -> dict:
    """Logical axes of every leaf of a param or optimizer tree, by its
    path (``sharding.infer_param_axes``); a ``QuantizedTensor``'s parts
    get those of their paths ``/0`` (data), ``/1`` (scale), ``/2``
    (act_scale), as the JAX pytree's children."""
    def leaf(path, w):
        if isinstance(w, QuantizedTensor):
            return dataclasses.replace(w, **{
                name: None if getattr(w, name) is None
                else sh.infer_param_axes(f"{path}/{i}",
                                         getattr(w, name).ndim)
                for i, name in enumerate(("data", "scale", "act_scale"))})
        return sh.infer_param_axes(path, w.ndim)
    return tree.map_with_path(leaf, params)


def batch_axes(batch: dict, mapping: dict) -> dict:
    """Axes of a flat batch dict by key name (unnamed keys replicated)."""
    return {k: mapping.get(k, (None,) * v.ndim) for k, v in batch.items()}


cache_axes = sh.cache_axes

# the JAX bundles' batch axes
_TOKEN_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq")}
_ONEREC_BATCH_AXES = dict(_TOKEN_AXES, profile=("batch", None))
_RECSYS_BATCH_AXES = {
    "hist_ids": ("batch", None),
    "target_ids": ("batch",),
    "field_ids": ("batch", None),
    "labels": ("batch",),
    "candidate_ids": ("candidates",),
}


def shard_args(bundle: StepBundle, mesh, rules: sh.AxisRules
               ) -> Tuple[Any, ...]:
    """The bundle's arguments laid out on ``mesh`` by ``arg_axes`` under
    ``rules`` (``shardings_for_tree``, then each rank's slice as a
    ``DTensor``, fp8 payloads K-major: ``sharding.lay_out``); arguments
    without axes (the decode index) pass as they are.  The dry run's
    ``shardings_for``, applied."""
    if len(bundle.arg_axes) != len(bundle.args):
        raise ValueError(f"{bundle.arch}/{bundle.shape}: no axes for its "
                         f"arguments")
    return tuple(sh.lay_out_tree(arg, axes, mesh, rules)
                 if isinstance(arg, dict) else arg
                 for arg, axes in zip(bundle.args, bundle.arg_axes))


def train_step(loss_fn: Callable[[dict, dict], torch.Tensor],
               opt_cfg: OptimizerConfig = OPT_CFG,
               grad_transform: Optional[Callable[[dict], dict]] = None
               ) -> Callable:
    """step(params, opt_state, batch) -> (loss, params, opt_state): the
    value and gradient of ``loss_fn(params, batch)``, then one AdamW
    update in place; ``grad_transform(grads) -> grads``, when given, runs
    between the two (gradient compression, ``launch/train.py``).
    ``step.metrics`` holds the last update's ``grad_norm`` and ``lr``
    (device tensors)."""
    def step(params, opt_state, batch):
        loss, grads = tree.value_and_grad(loss_fn, params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, step.metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return loss, params, opt_state
    step.metrics = {}
    return step


# ---------------------------------------------------------------------------
# LM transformer cells
# ---------------------------------------------------------------------------


def lm_bundle(arch: str, cfg: TransformerConfig, shape: ShapeSpec, *,
              fp8: bool, seed: int = 0, device=None,
              dtype=torch.float32) -> StepBundle:
    """A prefill or decode bundle of the LM ``cfg``: params of ``dtype``
    (PTQ'd with the paper's policy when ``fp8``; raw leaves stay
    ``dtype``, bf16 at full width on the card), ``global_batch`` x ``seq_len``
    prompt tokens (prefill; the step makes its shared cache of
    ``seq_len`` positions) or one token a row, an empty shared cache of
    ``seq_len`` positions and index ``seq_len - 1`` (decode); or a train
    bundle: f32 params (``fp8`` and ``dtype`` do not apply) and
    ``global_batch`` x ``seq_len`` tokens, their own labels."""
    dev = resolve_device(device)
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown LM shape kind {shape.kind}")
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        params = tfm.init_transformer(_generator(seed, dev), cfg,
                                      device=dev)
        tok = torch.randint(0, cfg.vocab_size, (b, s),
                            generator=_generator(seed + 1, dev), device=dev,
                            dtype=torch.int32)
        step = train_step(lambda p, batch: tfm.train_loss(p, batch, cfg))
        opt, batch = adamw_init(params), {"tokens": tok, "labels": tok}
        return StepBundle(arch, shape.name, "train", step,
                          (params, opt, batch),
                          (params_axes(params), params_axes(opt),
                           batch_axes(batch, _TOKEN_AXES)), cfg=cfg)
    serve_cfg = dataclasses.replace(cfg, remat=False)
    transform = (lambda path, t: quantize_params(t, PAPER_POLICY,
                                                 prefix=path)) if fp8 else None
    params = tfm.init_transformer(_generator(seed, dev), cfg, dtype=dtype,
                                  device=dev, transform=transform)
    tok_gen = _generator(seed + 1, dev)
    note = "fp8" if fp8 else "bf16"

    if shape.kind == "prefill":
        def step(params, batch):
            cache = sh.lay_out_cache(tfm.init_kv_cache(
                serve_cfg, b, s, per_slot=False,
                device=batch["tokens"].device), batch["tokens"])
            return tfm.prefill(params, batch["tokens"], serve_cfg, cache)

        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                            device=dev, dtype=torch.int32)
        batch = {"tokens": tok}
        return StepBundle(arch, shape.name, "prefill", step,
                          (params, batch), (params_axes(params),
                                            batch_axes(batch, _TOKEN_AXES)),
                          cfg=cfg, note=note)

    def step(params, cache, batch, index):
        return tfm.decode_step(params, batch["tokens"], serve_cfg, cache,
                               index)

    cache = tfm.init_kv_cache(serve_cfg, b, s, per_slot=False, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=tok_gen,
                        device=dev, dtype=torch.int32)
    batch = {"tokens": tok}
    return StepBundle(arch, shape.name, "decode", step,
                      (params, cache, batch, s - 1),
                      (params_axes(params), cache_axes(cache),
                       batch_axes(batch, _TOKEN_AXES), ()), donate=(1,),
                      cfg=cfg, note=note)


# ---------------------------------------------------------------------------
# Recsys cells
# ---------------------------------------------------------------------------


def _recsys_inputs(cfg: RecsysConfig, b: int, gen: torch.Generator, *,
                   n_candidates: int = 0) -> dict:
    """A batch of ``b`` users (uniform ids: histories, targets, fields) and
    ``n_candidates`` candidate items, drawn from ``gen`` on its device."""
    def ids(shape, high):
        return torch.randint(0, high, shape, generator=gen,
                             device=gen.device, dtype=torch.int32)

    batch = {"hist_ids": ids((b, cfg.seq_len), cfg.n_items),
             "target_ids": ids((b,), cfg.n_items),
             "field_ids": ids((b, cfg.n_sparse_fields), cfg.field_vocab)}
    if n_candidates:
        batch["candidate_ids"] = ids((n_candidates,), cfg.n_items)
    return batch


def recsys_bundle(arch: str, cfg: RecsysConfig, shape: ShapeSpec, *,
                  fp8: bool, seed: int = 0, device=None) -> StepBundle:
    """A train (``global_batch`` users with click labels), score
    (``global_batch`` users, one target each) or retrieval (one user
    against ``n_candidates`` items) bundle: f32 params (for scoring, the
    towers PTQ'd with the paper's policy when ``fp8``; the tables stay
    f32)."""
    dev = resolve_device(device)
    if shape.kind not in ("train", "score", "retrieval"):
        raise ValueError(f"unknown recsys shape kind {shape.kind}")
    params = recsys_model.init_recsys(_generator(seed, dev), cfg, device=dev)
    gen = _generator(seed + 1, dev)
    if shape.kind == "train":
        batch = _recsys_inputs(cfg, shape.global_batch, gen)
        batch["labels"] = (torch.rand((shape.global_batch,), generator=gen,
                                      device=dev) < 0.3).to(torch.float32)
        step = train_step(
            lambda p, b: recsys_model.train_loss(p, b, cfg))
        opt = adamw_init(params)
        return StepBundle(arch, shape.name, "train", step,
                          (params, opt, batch),
                          (params_axes(params), params_axes(opt),
                           batch_axes(batch, _RECSYS_BATCH_AXES)), cfg=cfg)
    if fp8:
        params = quantize_params(params, PAPER_POLICY)
    if shape.kind == "score":
        def step(params, batch):
            return recsys_model.score(params, batch, cfg)
        batch = _recsys_inputs(cfg, shape.global_batch, gen)
    else:
        def step(params, batch):
            return recsys_model.retrieval_scores(params, batch, cfg)
        batch = _recsys_inputs(cfg, shape.global_batch, gen,
                               n_candidates=shape.n_candidates)
    return StepBundle(arch, shape.name, shape.kind, step, (params, batch),
                      (params_axes(params),
                       batch_axes(batch, _RECSYS_BATCH_AXES)),
                      cfg=cfg, note="fp8" if fp8 else "bf16")


# ---------------------------------------------------------------------------
# OneRec cells (the paper's model)
# ---------------------------------------------------------------------------


def onerec_bundle(arch: str, cfg: OneRecConfig, shape: ShapeSpec, *,
                  fp8: bool, seed: int = 0, device=None) -> StepBundle:
    """A train (``seq_len`` tokens, a profile and ``seq_len + 1`` labels a
    row over [profile] + tokens), prefill (``seq_len`` history tokens and
    a profile a row, into a shared cache of ``context_len + 1`` positions)
    or decode (one token a row at index ``seq_len - 1`` of an empty shared
    cache) bundle."""
    dev = resolve_device(device)
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown OneRec shape kind {shape.kind}")
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        params = onerec_model.init_onerec(seed, cfg, device=dev)
        gen = _generator(seed + 1, dev)

        def ids(n):
            return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                                 device=dev, dtype=torch.int32)
        batch = {"tokens": ids(t),
                 "profile": torch.randn((b, onerec_model.PROFILE_DIM),
                                        generator=gen, device=dev),
                 "labels": ids(t + 1)}
        step = train_step(
            lambda p, bt: onerec_model.train_loss(p, bt, cfg))
        opt = adamw_init(params)
        return StepBundle(arch, shape.name, "train", step,
                          (params, opt, batch),
                          (params_axes(params), params_axes(opt),
                           batch_axes(batch, _ONEREC_BATCH_AXES)), cfg=cfg)
    # PTQ'd layer by layer as the layers are made: the same bits as the
    # whole tree's PTQ, and at most one raw layer on the device
    params = onerec_model.init_onerec(seed, cfg, device=dev, transform=(
        lambda path, t: quantize_params(t, PAPER_POLICY, prefix=path))
        if fp8 else None)
    serve_cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, remat=False))
    gen = _generator(seed + 1, dev)
    note = "fp8" if fp8 else "bf16"

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)

    if shape.kind == "prefill":
        def step(params, batch):
            cache = sh.lay_out_cache(onerec_model.init_cache(
                serve_cfg, b, device=batch["tokens"].device),
                batch["tokens"])
            return onerec_model.prefill(params, batch, serve_cfg, cache)

        batch = {"tokens": tokens(t),
                 "profile": torch.randn((b, onerec_model.PROFILE_DIM),
                                        generator=gen, device=dev)}
        return StepBundle(arch, shape.name, "prefill", step, (params, batch),
                          (params_axes(params),
                           batch_axes(batch, _ONEREC_BATCH_AXES)),
                          cfg=cfg, note=note)

    def step(params, cache, batch, index):
        return onerec_model.decode_step(params, batch["tokens"], serve_cfg,
                                        cache, index)

    cache = onerec_model.init_cache(serve_cfg, b, device=dev)
    batch = {"tokens": tokens(1)}
    return StepBundle(arch, shape.name, "decode", step,
                      (params, cache, batch, t - 1),
                      (params_axes(params), cache_axes(cache),
                       batch_axes(batch, _ONEREC_BATCH_AXES), ()),
                      donate=(1,), cfg=cfg, note=note)


# ---------------------------------------------------------------------------
# GNN cells (a training step each)
# ---------------------------------------------------------------------------


def _pad_graph(n: int, mult: int = 2048) -> int:
    """Node / edge counts padded as the JAX package pads them (to a
    multiple of 2048 from 2048 up, for its sharding); the padding entries
    are ordinary random edges and nodes, as there."""
    if n < mult:
        return n
    return ((n + mult - 1) // mult) * mult


def _gnn_cell_dims(shape: ShapeSpec) -> Tuple[int, int, int, str, int]:
    """(n_nodes, n_edges, d_feat, level, n_graphs) of a graph cell."""
    if shape.name == "minibatch_lg" or shape.fanout:
        seeds = shape.batch_nodes
        n1 = seeds * shape.fanout[0]
        n2 = n1 * shape.fanout[1]
        return (_pad_graph(seeds + n1 + n2), _pad_graph(n1 + n2),
                shape.d_feat, "node", 0)
    if shape.global_batch:                    # batched small graphs
        n = shape.n_nodes * shape.global_batch
        e = shape.n_edges * shape.global_batch
        return _pad_graph(n), _pad_graph(e), shape.d_feat, "graph", \
            shape.global_batch
    return (_pad_graph(shape.n_nodes), _pad_graph(shape.n_edges),
            shape.d_feat, "node", 0)


def gnn_bundle(arch: str, cfg: GNNConfig, shape: ShapeSpec, *,
               n_classes: int = 16, seed: int = 0,
               device=None) -> StepBundle:
    """The EGNN's training step on the cell's graph: random features,
    coordinates, edges and labels (node labels, or one a graph for the
    batched small graphs), every edge and node real."""
    if shape.name == "ogb_products":
        raise _not_ported(f"the graph step of {arch} on ogb_products "
                          f"(61.86 M edges: chunked or sharded segment "
                          f"sums)", "N9e.7")
    dev = resolve_device(device)
    n, e, d_feat, level, n_graphs = _gnn_cell_dims(shape)
    gen = _generator(seed + 1, dev)
    batch = {
        "feat": torch.randn((n, d_feat), generator=gen, device=dev),
        "coord": torch.randn((n, 3), generator=gen, device=dev),
        "edges": torch.randint(0, n, (e, 2), generator=gen, device=dev,
                               dtype=torch.int32),
        "edge_mask": torch.ones((e,), device=dev),
        "node_mask": torch.ones((n,), device=dev),
        "labels": torch.randint(0, n_classes,
                                (n_graphs if level == "graph" else n,),
                                generator=gen, device=dev,
                                dtype=torch.int32),
        "graph_ids": (torch.arange(n_graphs, dtype=torch.int32, device=dev
                                   ).repeat_interleave(n // max(n_graphs, 1))
                      if level == "graph" else
                      torch.zeros((n,), dtype=torch.int32, device=dev)),
    }
    params = gnn_model.init_egnn(_generator(seed, dev), cfg, d_feat,
                                 n_classes, device=dev)
    step = train_step(lambda p, b: gnn_model.train_loss(
        p, b, cfg, level=level, n_graphs=n_graphs))
    opt = adamw_init(params)
    baxes = batch_axes(batch, {
        "feat": ("nodes", None), "coord": ("nodes", None),
        "edges": ("edges", None), "edge_mask": ("edges",),
        "node_mask": ("nodes",),
        "labels": (None,) if level == "graph" else ("nodes",),
        "graph_ids": ("nodes",)})
    return StepBundle(arch, shape.name, "graph", step,
                      (params, opt, batch),
                      (params_axes(params), params_axes(opt), baxes),
                      cfg=cfg, note=level)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def build_bundle(arch: str, shape_name: str, *, reduced: bool = False,
                 fp8: Optional[bool] = None, abstract: bool = False,
                 shape_override: Optional[ShapeSpec] = None, seed: int = 0,
                 device=None) -> StepBundle:
    """The concrete bundle of cell ``arch`` x ``shape_name`` on ``device``
    (``reduced``: the arch's ``reduced_config()``; ``fp8`` None: PTQ'd, as
    the JAX package decides for the LM and OneRec families).  With
    ``abstract`` the bundle of an LM or OneRec prefill or decode cell on
    ``meta`` (shapes and dtypes, no values: the dry run's); the other
    kinds raise, naming the ROADMAP.md item they wait for."""
    mod = registry.get_arch(arch)
    cfg = mod.reduced_config() if reduced else mod.CONFIG
    shape = shape_override or mod.SHAPES[shape_name]
    if shape.skip:
        raise ValueError(f"cell {arch}/{shape_name} is N/A: {shape.skip}")
    if abstract:
        waits = abstract_waits(mod.FAMILY, shape)
        if waits:
            raise _not_ported(f"the abstract {shape.kind} bundle of "
                              f"{arch}/{shape.name}", waits)
        device = "meta"
    if mod.FAMILY == "gnn":
        return gnn_bundle(arch, cfg, shape,
                          n_classes=getattr(mod, "N_CLASSES", 16),
                          seed=seed, device=device)
    if fp8 is None:
        fp8 = getattr(cfg, "use_fp8", False) or mod.FAMILY in ("lm", "onerec")
    build = {"lm": lm_bundle, "onerec": onerec_bundle,
             "recsys": recsys_bundle}[mod.FAMILY]
    return build(arch, cfg, shape, fp8=fp8, seed=seed, device=device)


def abstract_waits(family: str, shape: ShapeSpec) -> Optional[str]:
    """The ROADMAP.md queue N item an abstract bundle of this cell waits
    for, or None where it is ported: training and the graph steps need
    FSDP (N9e.3), the recsys scoring steps row-sharded tables (N9e.5),
    ``ogb_products`` its sharded segment sums (N9e.7)."""
    if shape.name == "ogb_products":
        return "N9e.7"
    if shape.kind in ("train", "graph"):
        return "N9e.3"
    if family == "recsys":
        return "N9e.5"
    return None


# Reduced-shape cells for CPU smoke testing (the JAX package's, tiny dims)
SMOKE_SHAPES = {
    "lm": {
        "train": ShapeSpec("smoke_train", "train", seq_len=16,
                           global_batch=2),
        "prefill": ShapeSpec("smoke_prefill", "prefill", seq_len=16,
                             global_batch=2),
        "decode": ShapeSpec("smoke_decode", "decode", seq_len=32,
                            global_batch=2),
    },
    "recsys": {
        "train": ShapeSpec("smoke_train", "train", global_batch=8),
        "score": ShapeSpec("smoke_score", "score", global_batch=8),
        "retrieval": ShapeSpec("smoke_retrieval", "retrieval",
                               global_batch=1, n_candidates=64),
    },
    "gnn": {
        "graph": ShapeSpec("smoke_graph", "graph", n_nodes=40, n_edges=120,
                           d_feat=16),
        "molecule": ShapeSpec("smoke_molecule", "graph", n_nodes=10,
                              n_edges=20, global_batch=4, d_feat=16),
    },
    "onerec": {
        "train": ShapeSpec("smoke_train", "train", seq_len=27,
                           global_batch=2),
        "prefill": ShapeSpec("smoke_prefill", "prefill", seq_len=24,
                             global_batch=2),
        "decode": ShapeSpec("smoke_decode", "decode", seq_len=27,
                            global_batch=2),
    },
}


def smoke_bundles(arch: str, fp8: bool = False, device=None):
    """Concrete reduced-config bundles of every step kind of the arch."""
    mod = registry.get_arch(arch)
    return [build_bundle(arch, shape.name, reduced=True, fp8=fp8,
                         shape_override=shape, device=device)
            for shape in SMOKE_SHAPES[mod.FAMILY].values()]
