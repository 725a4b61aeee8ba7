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

Sharded trees (the JAX elastic re-shard path, ``distributed/elastic.py``,
and the sharded runner's state; every collective a c10d call on host
tensors, none through DTensor's redistribution):
  * ``save_checkpoint`` of a tree holding ``DTensor``s: every rank copies
    its local shards to host memory and each leaf's global value is
    gathered to rank 0 (``gather_to_host``: ``dist.gather`` of the
    shards' bytes over the default group, rank 0 placing each rank's
    block by its mesh coordinate); rank 0 writes, and every rank returns
    the path after a barrier (which also raises rank 0's error on every
    rank).  The format is the one above, one global ``arrays.npz`` and
    manifest, as the JAX package writes a sharded tree (each leaf's
    global value): the same entries, bytes and hash as one rank's save of
    the same values, the zip's and the manifest's write times apart;
  * ``AsyncCheckpointer.save`` of such a tree: every rank takes part in
    the gather on the calling thread, and rank 0 alone queues the host
    tree for its writer (host memory holds one global tree, not one a
    rank); ``wait`` and ``close`` end at a barrier, where an error of
    rank 0's writer raises on every rank;
  * ``load_checkpoint(..., in_place=True)`` into a template of
    ``DTensor``s: each rank reads and checks every leaf whole (each
    reads the shared file; nothing is broadcast) and copies its slice of
    it into its own local shard (a K-major payload keeps its layout);
  * ``load_checkpoint(..., shardings=tree)`` returns a new tree of
    ``DTensor``s holding each rank's slice; the template may hold
    ``meta`` tensors (shapes, dtypes and layouts only), so no rank
    allocates the global tree.  A K-major payload's slice is laid out
    K-major again (``quant.k_major``).

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


def _agree(err: Optional[BaseException]) -> None:
    """A barrier of every rank that raises on each of them when rank 0
    holds ``err`` (its write failed), so no rank waits on another."""
    import torch.distributed as dist
    flag = torch.tensor([0 if err is None else 1], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    if err is not None:
        raise err
    if flag.item():
        raise RuntimeError("rank 0 failed to write a checkpoint")


def _mesh_coord(mesh, rank: int) -> List[int]:
    hit = (mesh.mesh == rank).nonzero()
    if hit.shape[0] != 1:
        raise ValueError(f"rank {rank} is not on the mesh {mesh}")
    return hit[0].tolist()


def _gather_leaf(t: torch.Tensor) -> Optional[torch.Tensor]:
    """Rank 0: the global value of ``t`` on the host, a fresh tensor in
    row-major order (a ``DTensor``'s blocks gathered from every rank,
    each placed by its mesh coordinate); the other ranks: None."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import shard_range
    rank = dist.get_rank()
    if not _dtensor(t):
        return _host(t, copy=True) if rank == 0 else None
    mesh, places, world = t.device_mesh, t.placements, dist.get_world_size()
    if mesh.mesh.numel() != world:
        raise ValueError(f"a sharded save needs a mesh over all {world} "
                         f"ranks, not {mesh}")
    local = _host(t.to_local(), copy=False)
    buf = local.reshape(-1).view(torch.uint8)
    if rank != 0:
        dist.gather(buf, None, dst=0)
        return None
    bufs = [torch.empty_like(buf) for _ in range(world)]
    dist.gather(buf, bufs, dst=0)
    out = torch.empty(t.shape, dtype=t.dtype)
    for r, b in enumerate(bufs):
        coord = _mesh_coord(mesh, r)
        block = tuple(slice(off, off + n) for off, n in (
            shard_range(mesh, places, d, t.shape[d], coord=coord)
            for d in range(t.ndim)))
        out[block] = b.view(t.dtype).reshape(local.shape)
    return out


def gather_to_host(tree: Any) -> Optional[Any]:
    """(Every rank, a collective leaf by leaf.)  Rank 0: ``tree`` with
    each leaf's global value as a fresh host tensor; the other ranks:
    None.  Only c10d calls on host tensors move the data (gloo's refuse
    nothing there; a DTensor redistribution of CUDA shards would run
    functional collectives)."""
    import torch.distributed as dist
    leaves = [_gather_leaf(t) for t in _flatten(tree)[1]]
    return _unflatten(tree, iter(leaves)) if dist.get_rank() == 0 else None


def _save_sharded(directory: str, step: int, tree: Any,
                  extra_meta: Optional[Dict], timing: Optional[Dict]) -> str:
    """``gather_to_host``; rank 0 writes the gathered tree; all meet at a
    barrier.  ``timing``'s ``host_s`` (rank 0) includes the gather."""
    t0 = time.perf_counter()
    host = gather_to_host(tree)
    gathered = time.perf_counter() - t0
    final = os.path.join(directory, f"step_{step:010d}")
    err = None
    if host is not None:
        try:
            final = save_checkpoint(directory, step, host, extra_meta,
                                    timing)
            if timing is not None:
                timing["host_s"] += gathered
        except BaseException as e:  # noqa: BLE001 -- raised on every rank
            err = e
    _agree(err)
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
            raise ValueError("a restore onto shardings makes new tensors: "
                             "in_place does not apply")
        spec_paths, specs = _flatten(shardings, any_leaf=True)
        if spec_paths != paths:
            raise ValueError("shardings do not match the template's tree")
        out = [_shard(src, t, sh)
               for src, t, sh in zip(leaves, targets, specs)]
        return _unflatten(template, iter(out)), manifest
    if in_place:
        for t, src in zip(targets, leaves):
            _copy_in(t, src)
        return template, manifest
    out = [tree_util.empty_like(t).copy_(src)
           for t, src in zip(targets, leaves)]
    return _unflatten(template, iter(out)), manifest


def _copy_in(t: torch.Tensor, src: torch.Tensor) -> None:
    """The global leaf ``src`` into the template's ``t``: a ``DTensor``'s
    local shard gets the rank's slice, in its own layout."""
    if not _dtensor(t):
        t.copy_(src)
        return
    from repro_torch.distributed.sharding import shard_range
    for d in range(src.ndim):
        off, n = shard_range(t.device_mesh, t.placements, d, src.shape[d])
        src = src.narrow(d, off, n)
    t.to_local().copy_(src)


def _shard(src: torch.Tensor, template: torch.Tensor, sharding):
    """The rank's slice of the global leaf ``src`` as a ``DTensor`` on
    ``sharding.mesh`` (on its device, in the template's layout)."""
    from repro_torch.distributed.sharding import lay_out
    mesh = sharding.mesh
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return lay_out(src, sharding, layout=template, device=dev)


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
    timing, the seconds of ``save``'s copy to host memory (``d2h_s``; of
    a sharded tree the gather to rank 0) and all the seconds ``save`` held
    the calling thread (``block_s``, the copy and any wait for the queue).

    A tree holding ``DTensor``s makes it collective (module docstring):
    from its first such save, every rank calls ``save``, ``wait`` and
    ``close`` alike; rank 0 writes, and its ``timings`` are the
    checkpoints'."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self.timings: List[Dict[str, float]] = []
        self.sharded = False
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

    def _raise(self):
        """The writer's error, raised here (on every rank when sharded)."""
        if self.sharded:
            _agree(self._err)
        elif self._err:
            raise self._err

    def save(self, step: int, tree: Any, meta: Optional[Dict] = None):
        self.sharded = self.sharded or any(
            _dtensor(t) for t in _flatten(tree)[1])
        self._raise()
        # copy to host BEFORE queueing: the train step updates the state's
        # tensors in place (on the CPU too, where no transfer would copy)
        t0 = time.perf_counter()
        host_tree = gather_to_host(tree) if self.sharded \
            else host_copy(tree)
        timing = {"step": step, "d2h_s": time.perf_counter() - t0}
        if host_tree is not None:
            self._q.put((step, host_tree, meta, timing))
        timing["block_s"] = time.perf_counter() - t0

    def wait(self):
        """Block until every queued checkpoint is written (or failed); a
        barrier of every rank when sharded."""
        self._q.join()
        if self.sharded:
            self._raise()

    def close(self):
        self._q.put(None)
        self._thread.join()
        self._raise()
