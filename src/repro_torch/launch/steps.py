"""Step construction for the ported (architecture x input-shape) cells.

``build_bundle(arch, shape)`` returns a :class:`StepBundle`: the step
function and its concrete arguments on one device (the card unless the
caller passes ``device="cpu"``), the JAX package's
``repro/launch/steps.py`` for the families and kinds the port covers:
the five LMs and OneRec-V2 (``prefill``, ``decode``) and the four recsys
architectures (``score``, ``retrieval``).  Abstract bundles (the JAX
dry-run's shapes, no allocation), the ``train`` kind and the GNN family's
``graph`` bundles (a training step) wait for ROADMAP.md queue N, item N9.
The step functions run on the device of their inputs.

Step signatures (uniform per kind):
  prefill:    step(params, batch)                     -> (logits, cache)
  decode:     step(params, cache, batch, index)       -> (logits, cache)
  score:      step(params, batch)                     -> scores
  retrieval:  step(params, batch)                     -> scores

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

from repro_torch.configs import registry
from repro_torch.configs.base import (OneRecConfig, RecsysConfig,
                                      ShapeSpec, TransformerConfig)
from repro_torch.core.policy import PAPER_POLICY
from repro_torch.core.ptq import quantize_params
from repro_torch.device import resolve_device
from repro_torch.models import onerec as onerec_model
from repro_torch.models import recsys as recsys_model
from repro_torch.models import transformer as tfm


@dataclasses.dataclass
class StepBundle:
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[Any, ...]
    cfg: Any = None
    note: str = ""


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md "
                               f"queue N, item {item})")


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


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
    ``seq_len`` positions and index ``seq_len - 1`` (decode)."""
    dev = resolve_device(device)
    if shape.kind == "train":
        raise _not_ported(f"the train step of {arch}", "N9")
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"unknown LM shape kind {shape.kind}")
    b, s = shape.global_batch, shape.seq_len
    serve_cfg = dataclasses.replace(cfg, remat=False)
    transform = (lambda path, t: quantize_params(t, PAPER_POLICY,
                                                 prefix=path)) if fp8 else None
    params = tfm.init_transformer(_generator(seed, dev), cfg, dtype=dtype,
                                  device=dev, transform=transform)
    tok_gen = _generator(seed + 1, dev)
    note = "fp8" if fp8 else "bf16"

    if shape.kind == "prefill":
        def step(params, batch):
            cache = tfm.init_kv_cache(serve_cfg, b, s, per_slot=False,
                                      device=batch["tokens"].device)
            return tfm.prefill(params, batch["tokens"], serve_cfg, cache)

        tok = torch.randint(0, cfg.vocab_size, (b, s), generator=tok_gen,
                            device=dev, dtype=torch.int32)
        return StepBundle(arch, shape.name, "prefill", step,
                          (params, {"tokens": tok}), cfg=cfg, note=note)

    def step(params, cache, batch, index):
        return tfm.decode_step(params, batch["tokens"], serve_cfg, cache,
                               index)

    cache = tfm.init_kv_cache(serve_cfg, b, s, per_slot=False, device=dev)
    tok = torch.randint(0, cfg.vocab_size, (b, 1), generator=tok_gen,
                        device=dev, dtype=torch.int32)
    return StepBundle(arch, shape.name, "decode", step,
                      (params, cache, {"tokens": tok}, s - 1), cfg=cfg,
                      note=note)


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
    """A score (``global_batch`` users, one target each) or retrieval (one
    user against ``n_candidates`` items) bundle: f32 params (the towers
    PTQ'd with the paper's policy when ``fp8``; the tables stay f32)."""
    dev = resolve_device(device)
    if shape.kind == "train":
        raise _not_ported(f"the train step of {arch}", "N9")
    if shape.kind not in ("score", "retrieval"):
        raise ValueError(f"unknown recsys shape kind {shape.kind}")
    params = recsys_model.init_recsys(_generator(seed, dev), cfg, device=dev)
    if fp8:
        params = quantize_params(params, PAPER_POLICY)
    gen = _generator(seed + 1, dev)
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
                      cfg=cfg, note="fp8" if fp8 else "bf16")


# ---------------------------------------------------------------------------
# OneRec cells (the paper's model)
# ---------------------------------------------------------------------------


def onerec_bundle(arch: str, cfg: OneRecConfig, shape: ShapeSpec, *,
                  fp8: bool, seed: int = 0, device=None) -> StepBundle:
    """A prefill (``seq_len`` history tokens and a profile a row, into a
    shared cache of ``context_len + 1`` positions) or decode (one token a
    row at index ``seq_len - 1`` of an empty shared cache) bundle."""
    dev = resolve_device(device)
    if shape.kind == "train":
        raise _not_ported(f"the train step of {arch}", "N9")
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"unknown OneRec shape kind {shape.kind}")
    b, t = shape.global_batch, shape.seq_len
    params = onerec_model.init_onerec(seed, cfg, device=dev)
    if fp8:
        params = quantize_params(params, PAPER_POLICY)
    serve_cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, remat=False))
    gen = _generator(seed + 1, dev)
    note = "fp8" if fp8 else "bf16"

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=gen,
                             device=dev, dtype=torch.int32)

    if shape.kind == "prefill":
        def step(params, batch):
            cache = onerec_model.init_cache(serve_cfg, b,
                                            device=batch["tokens"].device)
            return onerec_model.prefill(params, batch, serve_cfg, cache)

        batch = {"tokens": tokens(t),
                 "profile": torch.randn((b, onerec_model.PROFILE_DIM),
                                        generator=gen, device=dev)}
        return StepBundle(arch, shape.name, "prefill", step, (params, batch),
                          cfg=cfg, note=note)

    def step(params, cache, batch, index):
        return onerec_model.decode_step(params, batch["tokens"], serve_cfg,
                                        cache, index)

    cache = onerec_model.init_cache(serve_cfg, b, device=dev)
    return StepBundle(arch, shape.name, "decode", step,
                      (params, cache, {"tokens": tokens(1)}, t - 1),
                      cfg=cfg, note=note)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def build_bundle(arch: str, shape_name: str, *, reduced: bool = False,
                 fp8: Optional[bool] = None, abstract: bool = False,
                 shape_override: Optional[ShapeSpec] = None, seed: int = 0,
                 device=None) -> StepBundle:
    """The concrete bundle of cell ``arch`` x ``shape_name`` on ``device``
    (``reduced``: the arch's ``reduced_config()``; ``fp8`` None: PTQ'd, as
    the JAX package decides for the LM and OneRec families)."""
    if abstract:
        raise _not_ported("abstract bundles (the dry-run's)", "N9")
    mod = registry.get_arch(arch)
    cfg = mod.reduced_config() if reduced else mod.CONFIG
    shape = shape_override or mod.SHAPES[shape_name]
    if shape.skip:
        raise ValueError(f"cell {arch}/{shape_name} is N/A: {shape.skip}")
    if mod.FAMILY == "gnn":
        raise _not_ported(f"the graph (training) step of {arch}", "N9")
    if fp8 is None:
        fp8 = getattr(cfg, "use_fp8", False) or mod.FAMILY in ("lm", "onerec")
    build = {"lm": lm_bundle, "onerec": onerec_bundle,
             "recsys": recsys_bundle}[mod.FAMILY]
    return build(arch, cfg, shape, fp8=fp8, seed=seed, device=device)


# Reduced-shape cells for CPU smoke testing (the JAX package's, tiny dims):
# the ported kinds only (train and the GNN family's graph cells wait for N9)
SMOKE_SHAPES = {
    "lm": {
        "prefill": ShapeSpec("smoke_prefill", "prefill", seq_len=16,
                             global_batch=2),
        "decode": ShapeSpec("smoke_decode", "decode", seq_len=32,
                            global_batch=2),
    },
    "recsys": {
        "score": ShapeSpec("smoke_score", "score", global_batch=8),
        "retrieval": ShapeSpec("smoke_retrieval", "retrieval",
                               global_batch=1, n_candidates=64),
    },
    "onerec": {
        "prefill": ShapeSpec("smoke_prefill", "prefill", seq_len=24,
                             global_batch=2),
        "decode": ShapeSpec("smoke_decode", "decode", seq_len=27,
                            global_batch=2),
    },
}


def smoke_bundles(arch: str, fp8: bool = False, device=None):
    """Concrete reduced-config bundles of every ported step kind of the
    arch (none of the GNN family's yet: its graph step is a training step,
    N9)."""
    mod = registry.get_arch(arch)
    if mod.FAMILY == "gnn":
        raise _not_ported(f"the graph (training) step of {arch}", "N9")
    return [build_bundle(arch, shape.name, reduced=True, fp8=fp8,
                         shape_override=shape, device=device)
            for shape in SMOKE_SHAPES[mod.FAMILY].values()]
