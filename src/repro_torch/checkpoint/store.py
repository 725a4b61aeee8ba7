"""Checkpoints in the JAX package's format: atomic, hashed, async.

A checkpoint is a directory ``<dir>/step_<step:010d>`` holding
``arrays.npz`` (one entry ``leaf_<i:05d>`` a leaf) and ``manifest.json``
(the leaves' JAX ``keystr`` paths, numpy dtype names and shapes, a SHA-256
content hash and the step), as ``repro/checkpoint/store.py`` writes them:
either package reads the other's files, and the same tree hashes the same
in both.

The format, leaf by leaf:
  * leaves come in the JAX flatten order (each dict's keys sorted as
    strings); a ``QuantizedTensor`` contributes its children ``data``,
    ``scale`` and ``act_scale`` (when set) as ``[<flat index i>]``;
  * an npy-native dtype is stored as its array; bf16 and the fp8 formats
    as the flat ``uint8`` view of their bytes, decoded on load into the
    torch dtype of the manifest's name (no ``ml_dtypes``);
  * a payload is the logical array in row-major order: a K-major fp8
    weight (``quant.k_major``) is saved unpadded, as the JAX package holds
    it, and laid out K-major again on load (``tree.empty_like``).

Sharded trees (the JAX elastic re-shard path, ``distributed/elastic.py``):
  * ``load_checkpoint(..., shardings=tree)`` reads and checks every leaf
    whole on every rank (each rank reads the shared file; nothing is
    broadcast), keeps the rank's own slice of each and returns a tree of
    ``DTensor``s; the template may hold ``meta`` tensors (shapes, dtypes
    and layouts only), so no rank allocates the global tree.  A K-major
    payload's slice is laid out K-major again (``quant.k_major``);
  * ``save_checkpoint`` of a tree holding ``DTensor``s gathers each leaf
    on every rank (``full_tensor``), rank 0 writes, and every rank returns
    the path after a barrier: the same files and hash as one rank's save
    of the same values.  ``AsyncCheckpointer`` of DTensors waits for
    ROADMAP.md queue N, item N9e.

Durability contract (fault tolerance):
  * writes go to ``<dir>/tmp.<step>.<pid>`` and are atomically renamed,
  * the manifest hash is verified on load: torn or corrupt checkpoints are
    skipped by ``latest_checkpoint``,
  * ``AsyncCheckpointer`` copies the tree to host memory on the calling
    thread (the optimizer updates the state in place), serializes off it
    and joins on shutdown (a bounded queue of 1: back-pressure).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_util
from repro_torch.core import quant
from repro_torch.core.quant import QuantizedTensor

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``"bfloat16"``, ``"float32"``)."""
    return str(dtype).removeprefix("torch.")


def _exotic(name: str) -> bool:
    """A dtype npy cannot hold: stored as the flat uint8 view of its bytes."""
    return name == "bfloat16" or name.startswith("float8_")


def _torch_dtype(name: str) -> torch.dtype:
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    return dtype


_QT_CHILDREN = ("data", "scale", "act_scale")     # the JAX pytree children


def _leaves(tree, prefix: str = "", any_leaf: bool = False
            ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(keystr path, leaf) in the JAX flatten order; ``any_leaf`` takes
    any object as a leaf (a tree of shardings), else only tensors."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}[{key!r}]", any_leaf)
    elif isinstance(tree, QuantizedTensor):
        for i, name in enumerate(_QT_CHILDREN):
            part = getattr(tree, name)
            if part is not None:
                yield f"{prefix}[<flat index {i}>]", part
    elif torch.is_tensor(tree) or (any_leaf and tree is not None):
        yield prefix, tree
    elif tree is not None:
        raise TypeError(f"checkpoint leaf {prefix} is a {type(tree)}, "
                        f"not a tensor")


def _flatten(tree, any_leaf: bool = False
             ) -> Tuple[List[str], List[torch.Tensor]]:
    flat = list(_leaves(tree, any_leaf=any_leaf))
    return [p for p, _ in flat], [t for _, t in flat]


def _unflatten(template, leaves: Iterator[torch.Tensor]):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, QuantizedTensor):
        parts = {name: None if getattr(template, name) is None
                 else next(leaves) for name in _QT_CHILDREN}
        return dataclasses.replace(template, **parts)
    return None if template is None else next(leaves)


def _dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def _host(t: torch.Tensor, copy: bool) -> torch.Tensor:
    """``t`` as a contiguous CPU tensor in row-major order: a copy when
    ``copy`` or when it lies elsewhere or in another layout."""
    if t.device.type == "cpu" and t.is_contiguous() and not copy:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, device="cpu")
    return out.copy_(t)


def _bytes(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor, as a flat uint8 array."""
    return t.reshape(-1).view(torch.uint8).numpy()


def _content_hash(leaves: List[torch.Tensor]) -> str:
    h = hashlib.sha256()
    for t in leaves:
        h.update(_dtype_name(t.dtype).encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(memoryview(_bytes(t)))
    return h.hexdigest()


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_meta: Optional[Dict] = None,
                    timing: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the final checkpoint path.
    ``timing``, when given, receives the bytes written and the seconds of
    the copy to host memory, the npz write and the hash."""
    t0 = time.perf_counter()
    paths, leaves = _flatten(tree)
    if any(_dtensor(t) for t in leaves):
        return _save_sharded(directory, step, tree, extra_meta, timing)
    os.makedirs(directory, exist_ok=True)
    leaves = [_host(t, copy=False) for t in leaves]
    t1 = time.perf_counter()
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    views, dtypes = {}, {}
    for i, t in enumerate(leaves):
        k = f"leaf_{i:05d}"
        dtypes[k] = _dtype_name(t.dtype)
        views[k] = _bytes(t) if _exotic(dtypes[k]) else t.numpy()
    np.savez(os.path.join(tmp, ARRAYS), **views)
    t2 = time.perf_counter()
    manifest = {
        "step": step,
        "paths": paths,
        "dtypes": dtypes,
        "shapes": {f"leaf_{i:05d}": list(t.shape)
                   for i, t in enumerate(leaves)},
        "hash": _content_hash(leaves),
        "time": time.time(),
        "extra": extra_meta or {},
    }
    t3 = time.perf_counter()
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if timing is not None:
        timing.update(bytes=sum(t.numel() * t.element_size()
                                for t in leaves),
                      host_s=t1 - t0, write_s=t2 - t1, hash_s=t3 - t2)
    return final


def _save_sharded(directory: str, step: int, tree: Any,
                  extra_meta: Optional[Dict], timing: Optional[Dict]) -> str:
    """Every rank gathers each ``DTensor`` leaf whole (a collective, leaf
    by leaf); rank 0 writes the gathered tree; all meet at a barrier."""
    import torch.distributed as dist
    gathered = _unflatten(tree, iter(
        _host(t.full_tensor() if _dtensor(t) else t, copy=False)
        for t in _flatten(tree)[1]))
    final = os.path.join(directory, f"step_{step:010d}")
    if dist.get_rank() == 0:
        final = save_checkpoint(directory, step, gathered, extra_meta,
                                timing)
    dist.barrier()
    return final


def _load_arrays(path: str) -> Tuple[Dict, List[torch.Tensor]]:
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    leaves = []
    with np.load(os.path.join(path, ARRAYS)) as data:
        for i in range(len(manifest["paths"])):
            k = f"leaf_{i:05d}"
            a = data[k]
            want = manifest["dtypes"][k]
            if str(a.dtype) != want:            # stored as a uint8 view
                t = torch.from_numpy(a).view(_torch_dtype(want)).reshape(
                    manifest["shapes"][k])
            else:
                t = torch.from_numpy(a)
            leaves.append(t)
    return manifest, leaves


def verify_checkpoint(path: str) -> bool:
    try:
        manifest, leaves = _load_arrays(path)
        return _content_hash(leaves) == manifest["hash"]
    except Exception:
        return False


def load_checkpoint(path: str, template: Any, *, shardings: Any = None,
                    verify: bool = True, in_place: bool = False
                    ) -> Tuple[Any, Dict]:
    """Restore into the structure of ``template``, a tree of tensors (and
    ``QuantizedTensor``s; their granularity, block and tag come from it)
    whose leaves match the checkpoint's in path, shape and dtype.  Each
    leaf lands on its template leaf's device in its layout; with
    ``in_place`` it is copied into the template's own tensors, which are
    returned.

    ``shardings``, a tree of ``distributed.sharding.NamedSharding`` of the
    template's structure (``distributed.elastic.shardings_for_tree``),
    makes each leaf a ``DTensor`` on its mesh holding the rank's slice
    (module docstring); the template's leaves may be ``meta`` tensors."""
    manifest, leaves = _load_arrays(path)
    if verify and _content_hash(leaves) != manifest["hash"]:
        raise IOError(f"checkpoint {path} failed integrity verification")
    paths, targets = _flatten(template)
    if len(targets) != len(leaves):
        raise ValueError(
            f"checkpoint has {len(leaves)} leaves, template expects "
            f"{len(targets)}")
    for p, want, t, src in zip(paths, manifest["paths"], targets, leaves):
        if p != want or t.shape != src.shape or t.dtype != src.dtype:
            raise ValueError(
                f"checkpoint leaf {want} {_dtype_name(src.dtype)}"
                f"{tuple(src.shape)} does not match the template's {p} "
                f"{_dtype_name(t.dtype)}{tuple(t.shape)}")
    if shardings is not None:
        if in_place:
            raise ValueError("a sharded restore makes new tensors: "
                             "in_place does not apply")
        spec_paths, specs = _flatten(shardings, any_leaf=True)
        if spec_paths != paths:
            raise ValueError("shardings do not match the template's tree")
        out = [_shard(src, t, sh)
               for src, t, sh in zip(leaves, targets, specs)]
        return _unflatten(template, iter(out)), manifest
    out = [(t if in_place else tree_util.empty_like(t)).copy_(src)
           for t, src in zip(targets, leaves)]
    if in_place:
        return template, manifest
    return _unflatten(template, iter(out)), manifest


def _k_major(t: torch.Tensor) -> bool:
    return t.ndim >= 2 and t.stride(-2) == 1 and t.stride(-1) != 1


def _shard(src: torch.Tensor, template: torch.Tensor, sharding):
    """The rank's slice of the global leaf ``src`` as a ``DTensor`` on
    ``sharding.mesh`` (on its device, in the template's layout)."""
    from torch.distributed.tensor import DTensor, Shard
    mesh = sharding.mesh
    places = sharding.placements
    coord = mesh.get_coordinate()
    local = src
    for dim in range(src.ndim):
        idx, count = 0, 1
        for i, pl in enumerate(places):      # mesh order: the first major
            if isinstance(pl, Shard) and pl.dim == dim:
                idx = idx * mesh.size(i) + coord[i]
                count *= mesh.size(i)
        if count > 1:
            n = src.shape[dim] // count
            local = local.narrow(dim, idx * n, n)
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    if _k_major(template):
        local = quant.k_major(local.to(dev))
    else:
        local = torch.empty(local.shape, dtype=local.dtype,
                            device=dev).copy_(local)
    return DTensor.from_local(local, mesh, places, run_check=False,
                              shape=src.shape, stride=template.stride())


def latest_checkpoint(directory: str) -> Optional[str]:
    """Newest VALID checkpoint (corrupt/torn ones are skipped)."""
    if not os.path.isdir(directory):
        return None
    steps = sorted((d for d in os.listdir(directory)
                    if d.startswith("step_")), reverse=True)
    for d in steps:
        path = os.path.join(directory, d)
        if verify_checkpoint(path):
            return path
    return None


def gc_checkpoints(directory: str, keep: int = 3) -> None:
    steps = sorted(d for d in os.listdir(directory) if d.startswith("step_"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def host_copy(tree: Any) -> Any:
    """A copy of ``tree`` in host memory (contiguous, row-major), taken
    now: later in-place updates of the tree do not reach it."""
    return _unflatten(tree, iter(_host(t, copy=True)
                                 for t in _flatten(tree)[1]))


class AsyncCheckpointer:
    """Off-thread checkpoint writer with back-pressure and retention GC.
    ``timings`` holds, for each checkpoint written, ``save_checkpoint``'s
    timing, the seconds of ``save``'s copy to host memory (``d2h_s``) and
    all the seconds ``save`` held the calling thread (``block_s``, the
    copy and any wait for the queue)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.timings: List[Dict[str, float]] = []
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, tree, meta, timing = item
                save_checkpoint(self.directory, step, tree, meta, timing)
                gc_checkpoints(self.directory, self.keep)
                self.timings.append(timing)
            except BaseException as e:  # surfaced on next save/close
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        if self._err:
            raise self._err
        # copy to host BEFORE queueing: the train step updates the state's
        # tensors in place (on the CPU too, where no transfer would copy)
        t0 = time.perf_counter()
        host_tree = host_copy(tree)
        timing = {"step": step, "d2h_s": time.perf_counter() - t0}
        self._q.put((step, host_tree, meta, timing))
        timing["block_s"] = time.perf_counter() - t0

    def wait(self):
        """Block until every queued checkpoint is written (or failed)."""
        self._q.join()

    def close(self):
        self._q.put(None)
        self._thread.join()
        if self._err:
            raise self._err
