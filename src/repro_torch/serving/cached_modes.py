"""The executor's model entry points in each cached mode, one step at a
time, on one device or under tensor parallelism.

``slot_inputs`` makes a batch of ragged requests with a page table a row;
``slot_steps`` resolves each step's host-side writes and reads with the
executor's own resolvers (``serving.executor``: ``page_scatter``,
``landing``, ``slot_landing``, ``suffix_landing``, ``page_gather``);
``slot_run`` drives ``onerec.prefill_into_slots`` (a fresh prefill into a
per-slot cache, scattered onto the heap's pages by ``scatter_rows``, then
the resume prefill into both) and ``onerec.decode_step_slots`` (the
per-slot pool with ``use_attention_kernel`` off and on, the paged heap
fused and unfused, a tree step) through them.  ``chip_smoke.py`` runs
these at full width on the card against world 1, and
``tests/test_torch_tp.py`` at reduced size against world 1 and the JAX
package.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.distributed import sharding as sh
from repro_torch.layers.attention import KVWrite
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm
from repro_torch.serving.executor import (landing, page_gather, page_scatter,
                                          scatter_rows, slot_landing,
                                          suffix_landing)
from repro_torch.serving.kv_cache import as_index
from repro_torch.serving.requests import build_requests

SLOT_STEPS = ("prefill", "resume_slot", "resume_paged", "decode_slot_off",
              "decode_slot_on", "decode_fused", "decode_unfused", "tree")


def slot_inputs(cfg, rows: int, *, prefix: int, page_size: int,
                branches: int, seed: int = 0) -> dict:
    """The cached modes' batch: the first ``rows`` of the ragged requests
    ``build_requests(cfg, 64, 32, seed, True)`` makes, right-padded; each
    row's history length and the prefix a resume prefill finds cached (its
    first ``prefix`` tokens, or all but its last item); a decode token and
    ``branches`` tree tokens a row (from ``seed``); each row's pages of
    the heap (shuffled), enough for the slot row and the branches' spans;
    the slot row's length (``context_len + 1``) and the executor's branch
    stride (``decode_len - 1``).  Lengths, prefixes and page tables are
    host arrays (``INDEX_DTYPE``), as the executor keeps them."""
    reqs = build_requests(cfg, max(64, rows), 32, seed, True)[:rows]
    lengths = as_index([len(r["tokens"]) for r in reqs])
    tokens = torch.zeros((rows, int(lengths.max())), dtype=torch.int32)
    for i, r in enumerate(reqs):
        tokens[i, :lengths[i]] = torch.from_numpy(r["tokens"])
    stride = cfg.decode_len - 1
    s_len = cfg.context_len + 1
    pages = -(-(s_len + branches * stride) // page_size)
    rng = np.random.default_rng(seed)
    g = torch.Generator().manual_seed(seed + 1)
    return {"tokens": tokens,
            "profile": torch.from_numpy(np.stack([r["profile"]
                                                  for r in reqs])),
            "lengths": lengths,
            "prefix": np.minimum(lengths - cfg.n_codebooks, prefix),
            "decode": torch.randint(0, cfg.vocab_size, (rows, 1 + branches),
                                    generator=g, dtype=torch.int32),
            "tables": as_index(rng.permutation(rows * pages).reshape(
                rows, pages)),
            "s_len": s_len, "page_size": page_size, "branches": branches,
            "stride": stride}


def _index(a) -> torch.Tensor:
    """Host index math as a gather / scatter operand (int64, the index
    dtype of PyTorch's indexing ops), as the executor stages it."""
    return torch.from_numpy(np.asarray(a, np.int64))


def _write(pair) -> KVWrite:
    """A resolver's (dst, src) as a ``KVWrite`` on the host."""
    return KVWrite(*map(_index, pair))


def _lengths(a) -> torch.Tensor:
    """Per-row lengths or starts as the entry points take them."""
    return torch.from_numpy(as_index(a))


def slot_steps(inp: dict, rows: slice) -> dict:
    """The host-resolved inputs of each step for the batch rows ``rows``
    of ``inp`` (``slot_inputs``; widths the whole batch's, so a part of
    the batch runs the shapes the whole does, and MoE capacity counts its
    tokens as a data shard of it would): the fresh prefill of the
    prefixes into a per-slot cache, its positions scattered onto the
    heap's pages, the resume prefill of the rest (per-slot and paged), one
    decode step (per-slot, paged) and one tree step on the heap, each
    with the writes and reads the executor's resolvers give."""
    ps, s_len = inp["page_size"], inp["s_len"]
    nbr, stride = inp["branches"], inp["stride"]
    lens, pre = inp["lengths"][rows], inp["prefix"][rows]
    tables = inp["tables"][rows]
    sentinel = inp["tables"].size           # no row's table holds it
    nb = len(lens)
    t_pre = int(inp["prefix"].max())
    t_suf = int((inp["lengths"] - inp["prefix"]).max())

    def paged(logical, valid) -> KVWrite:
        return _write(landing(page_scatter(tables, logical, valid, ps,
                                           sentinel), (sentinel + 1) * ps))

    tok = inp["tokens"][rows]
    n_suf = lens - pre
    suf = torch.zeros((nb, t_suf), dtype=torch.int32)
    for i in range(nb):
        suf[i, :n_suf[i]] = tok[i, pre[i]:pre[i] + n_suf[i]]
    j = np.arange(t_suf)[None, :]
    suffix = j < n_suf[:, None]
    starts = pre + 1
    idx = lens + 1
    tree_at = lens + 2
    filled = np.broadcast_to(np.arange(s_len)[None, :], (nb, s_len))
    branch = np.arange(nbr)[None, :]
    gather = _index(page_gather(tables, ps))
    dec = inp["decode"][rows]
    return {
        "pages": inp["tables"].size, "s_len": s_len, "page_size": ps,
        "prefill": {"tokens": tok[:, :t_pre], "profile": inp["profile"][rows],
                    "lengths": _lengths(pre)},
        "copy": paged(filled, filled < starts[:, None]),
        "resume": {"tokens": suf, "lengths": _lengths(n_suf),
                   "starts": _lengths(starts),
                   "slot": _write(suffix_landing(suffix, starts, s_len)),
                   "paged": paged(starts[:, None] + j, suffix),
                   "gather": gather},
        "decode": {"tokens": dec[:, :1], "lengths": _lengths(idx),
                   "slot": _write(slot_landing(idx, s_len)),
                   "paged": paged(idx, idx > 0),
                   "tables": _lengths(tables), "gather": gather},
        "tree": {"tokens": dec[:, 1:], "lengths": _lengths(tree_at),
                 "starts": _lengths(tree_at), "stride": stride,
                 "paged": paged(tree_at[:, None] + branch * stride,
                                np.ones((nb, nbr), bool)),
                 "tables": _lengths(tables)},
    }


def whole_leaf(leaf):
    """A cache leaf whole on this rank (a ``DTensor`` gathered with c10d
    calls)."""
    from torch.distributed.tensor import Replicate
    if not sh.is_dtensor(leaf):
        return leaf
    return sh.redistribute(leaf, [Replicate()] * leaf.device_mesh.ndim
                           ).to_local()


def _record(logits) -> dict:
    """Logits' (local shard, row range, last-dim range) -- a plain
    tensor's whole --, the rank's rows' logits over the whole vocabulary
    (gathered with c10d calls) and their items (its stable top 1)."""
    if not sh.is_dtensor(logits):
        return {"logits": (logits, (0, logits.shape[0]),
                           (0, logits.shape[-1])), "whole": logits,
                "items": onerec.stable_top_k(logits, 1)[1][..., 0]}
    mesh, places = logits.device_mesh, logits.placements
    whole = sh.constrain(logits, ("batch",) + (None,) * (logits.ndim - 1)
                         ).to_local()
    return {"logits": (logits.to_local(), sh.shard_range(
                mesh, places, 0, logits.shape[0]), sh.shard_range(
                mesh, places, logits.ndim - 1, logits.shape[-1])),
            "whole": whole, "items": onerec.stable_top_k(whole, 1)[1][..., 0]}


def slot_run(params, cfg, st: dict, dev, mesh=None, step=None) -> dict:
    """``slot_steps``' steps through ``onerec.prefill_into_slots`` and
    ``onerec.decode_step_slots`` on ``dev``: on one rank, or on
    ``mesh`` under ``INFER_RULES`` with ``params`` laid out there, the
    batch's tokens and profiles ``DTensor``s, the per-slot cache and the
    heap laid out by ``cache_axes`` (the host-resolved inputs plain, the
    whole batch's).  ``step(name, fn)`` runs each step (``fn()`` returns
    its logits; by default called once).  Each step's record (its logits
    local and whole, its items); both caches gathered whole at the end
    (on the CPU) and their bytes a rank (``heap_kv``: the heap without its
    positions); the caches' placements."""
    from repro_torch.launch import steps
    step = step or (lambda _, fn: fn())
    ctx = contextlib.nullcontext() if mesh is None \
        else sh.use_mesh(mesh, sh.INFER_RULES)

    def on(t):
        return t.to(dev) if torch.is_tensor(t) else \
            type(t)(*(x.to(dev) for x in t))

    def lay(batch):
        batch = {k: on(v) for k, v in batch.items()}
        if mesh is None:
            return batch
        return sh.lay_out_tree(batch, steps.batch_axes(
            batch, {"tokens": ("batch", "seq"),
                    "profile": ("batch", None)}))

    out, s_len, ps = {}, st["s_len"], st["page_size"]
    with ctx:
        pre = st["prefill"]
        b = lay({"tokens": pre["tokens"], "profile": pre["profile"]})
        cache = sh.lay_out_cache(tfm.init_kv_cache(
            cfg.transformer, len(pre["lengths"]), s_len, device=dev),
            b["tokens"])
        heap = sh.lay_out_cache(tfm.init_kv_page_pool(
            cfg.transformer, st["pages"], ps, device=dev), b["tokens"])
        lens = on(pre["lengths"])
        out["prefill"] = _record(step("prefill", lambda: (
            onerec.prefill_into_slots(params, b, cfg, cache, lens)[0])))
        # the executor's scatter of a fresh prefill onto its pages, from
        # the per-slot cache whole on every rank onto every rank's heap
        scatter_rows(tree_util.map_with_path(lambda _, t: sh.local_shard(t),
                                             heap),
                     tree_util.map_with_path(lambda _, t: whole_leaf(t),
                                             cache), on(st["copy"]))
        res = {k: on(v) for k, v in st["resume"].items() if k != "tokens"}
        b = lay({"tokens": st["resume"]["tokens"]})
        for name, pool, kw in (
                ("resume_slot", cache, dict(kv_write=res["slot"])),
                ("resume_paged", heap, dict(kv_write=res["paged"],
                                            page_gather=res["gather"]))):
            out[name] = _record(step(name, lambda pool=pool, kw=kw: (
                onerec.prefill_into_slots(params, b, cfg, pool,
                                          res["lengths"],
                                          starts=res["starts"], **kw)[0])))
        dec = {k: on(v) for k, v in st["decode"].items() if k != "tokens"}
        tok = lay({"tokens": st["decode"]["tokens"]})["tokens"]
        kernel = {k: dataclasses.replace(cfg, transformer=dataclasses.replace(
            cfg.transformer, use_attention_kernel=k)) for k in (False, True)}
        for name, c, pool, kw in (
                ("decode_slot_off", kernel[False], cache,
                 dict(kv_write=dec["slot"])),
                ("decode_slot_on", kernel[True], cache,
                 dict(kv_write=dec["slot"])),
                ("decode_fused", cfg, heap,
                 dict(kv_write=dec["paged"], page_tables=dec["tables"],
                      page_size=ps)),
                ("decode_unfused", cfg, heap,
                 dict(kv_write=dec["paged"], page_gather=dec["gather"]))):
            out[name] = _record(step(name, lambda c=c, pool=pool, kw=kw: (
                onerec.decode_step_slots(params, tok, c, pool,
                                         dec["lengths"], **kw)[0])))
        tr = {k: on(v) for k, v in st["tree"].items()
              if k not in ("tokens", "stride")}
        tok = lay({"tokens": st["tree"]["tokens"]})["tokens"]
        out["tree"] = _record(step("tree", lambda: (
            onerec.decode_step_slots(
                params, tok, cfg, heap, tr["lengths"], kv_write=tr["paged"],
                starts=tr["starts"], branch_stride=st["tree"]["stride"],
                page_tables=tr["tables"], page_size=ps)[0])))
        out["cache_bytes"] = {name: sum(
            sh.local_shard(t).numel() * sh.local_shard(t).element_size()
            for path, t in tree_util.leaves_with_path(c) if keep(path))
            for name, c, keep in (
                ("slots", cache, lambda _: True),
                ("heap", heap, lambda _: True),
                ("heap_kv", heap, lambda p: not p.endswith("pos")))}
        if dev.type == "cpu":
            out["cache"] = {p: whole_leaf(t).clone()
                            for p, t in tree_util.leaves_with_path(cache)}
            out["heap"] = {p: whole_leaf(t).clone()
                           for p, t in tree_util.leaves_with_path(heap)}
        out["placements"] = {
            name: str(list(t.placements)) for name, t in (
                ("slot_k", cache["stacks"]["0"]["p0"]["k"]),
                ("slot_pos", cache["stacks"]["0"]["p0"]["pos"]),
                ("heap_k", heap["stacks"]["0"]["p0"]["k"]))
            if sh.is_dtensor(t)}
    return out


def slot_cfg(cfg):
    """``cfg`` with an fp8 K/V cache (the serving path's ``--kv-fp8``)."""
    return dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, kv_cache_dtype="float8_e4m3fn"))
