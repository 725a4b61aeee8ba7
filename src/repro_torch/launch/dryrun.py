"""Multi-pod dry run of the port: every (arch x shape x mesh) cell laid out
on the production mesh of 256 or 512 ranks and run once, with each rank's
work counted (the JAX package's ``repro/launch/dryrun.py``).

Where the JAX program lowers and compiles each cell for 512 fake host
devices and reads XLA's cost and memory analyses and the HLO text, this
one runs the step eagerly, in one process, as rank 0 of the ``"fake"``
process group (collectives that move nothing) on ``meta`` tensors (shapes
and dtypes, no values): the bundle is built abstract
(``steps.build_bundle(abstract=True)``), laid out by its ``arg_axes``
(``steps.shard_args``) and called under ``use_mesh``, with the rules the
JAX dry run picks by the cell's kind (``TRAIN_RULES`` for ``train`` and
``graph``, else ``INFER_RULES``); a train step runs with autograd on, its
backward and AdamW update included.  A dispatch mode counts what the rank
does:

  * ``flops_per_chip``: the operations of the ops on the rank's local
    tensors (``torch.utils.flop_counter``'s formulas at local shapes; an
    op on DTensors is counted at its local shapes too, never at the global
    ones), plus those the kernels report on ``meta``
    (``analysis.tally``);
  * ``bytes_per_chip``: each op's inputs read and outputs written once
    (views excluded), and the kernels' own, on local tensors;
  * ``collectives``: the JAX record's schema (``collective_bytes``), per
    rank and by each collective's output: an all-gather counts the
    gathered bytes, an all-reduce the reduced tensor, a reduce-scatter
    (the backward of a weight gather, run as an all-reduce and a slice:
    ``sharding.reduce_scatter``) its slice.  Eager code has no loops for
    XLA to roll, so ``while_trip_counts`` is ``[]``;
  * ``memory_analysis``: the local bytes of the laid-out arguments and of
    the outputs (XLA's temp, alias and code sizes have no counterpart:
    null).

``lower_s`` is the time to build and lay out the bundle, ``compile_s``
the time of the run.  A cell its shape marks N/A is ``"skipped"``.  The
exit code is 1 only when a cell is ``"error"``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch onerec-v2 \\
      --shape prefill_b32 --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
Outputs one JSON per cell under --out (default results/dryrun_torch).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import tree as tree_util
from repro_torch.configs import registry
from repro_torch.core.quant import QuantizedTensor
from repro_torch.distributed import sharding as sh
from repro_torch.analysis import tally
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d and functional collective ops -> (kind, which argument holds the
# bytes of the collective's output)
_COLLECTIVE_OPS = {
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d._allgather_base_": ("all-gather", 0),
    "c10d.allgather_": ("all-gather", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 0),
    "c10d.reduce_scatter_": ("reduce-scatter", 0),
    "c10d.alltoall_base_": ("all-to-all", 0),
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
}


_PRODUCTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
             torch.ops.aten.baddbmm)


def _nbytes(x) -> int:
    leaves, _ = tree_flatten(x)
    parts = [sh.local_shard(t) for t in leaves if isinstance(t, torch.Tensor)]
    return sum(t.numel() * t.element_size() for t in parts)


class RankCounter(TorchDispatchMode):
    """Counts the operations, bytes and collectives of one rank's ops
    (module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.bytes_by: Dict[str, int] = {k: 0 for k in COLLECTIVES}
        self.count_by: Dict[str, int] = {k: 0 for k in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        if name in _COLLECTIVE_OPS:
            kind, where = _COLLECTIVE_OPS[name]
            held = out if where == "out" else args[where]
            nbytes = _nbytes(held)
            if sh.AS_KIND is not None and kind == "all-reduce":
                kind, nbytes = sh.AS_KIND
            self.bytes_by[kind] += nbytes
            self.count_by[kind] += 1
            return out
        local_args, spec = tree_flatten((args, kwargs))
        local_args = [sh.local_shard(a) for a in local_args]
        largs, lkwargs = torch.utils._pytree.tree_unflatten(local_args, spec)
        lout = torch.utils._pytree.tree_map(sh.local_shard, out)
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            if func.overloadpacket in _PRODUCTS:    # their out_dtype forms
                largs = [a for a in largs if isinstance(a, torch.Tensor)]
            self.flops += int(formula(*largs, **lkwargs, out_val=lout))
        if not func.is_view:
            self.bytes += _nbytes((largs, lkwargs)) + _nbytes(lout)
        return out

    def collectives(self) -> Dict[str, Any]:
        """The JAX dry run's ``collective_bytes`` record."""
        def key(prefix, k):
            return f"{prefix}_{k.replace('-', '_')}"
        out = {key("bytes", k): v for k, v in self.bytes_by.items()}
        out.update({key("count", k): v for k, v in self.count_by.items()})
        out["bytes_total"] = sum(self.bytes_by.values())
        out["bytes_total_unscaled"] = out["bytes_total"]
        out["while_trip_counts"] = []
        return out


def _tree_local_bytes(args) -> int:
    total = 0
    for arg in args:
        if not isinstance(arg, dict):
            continue
        for _, leaf in tree_util.leaves_with_path(arg):
            parts = ([leaf.data, leaf.scale, leaf.act_scale]
                     if isinstance(leaf, QuantizedTensor) else [leaf])
            total += _nbytes([p for p in parts if p is not None])
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             fp8=None, force: bool = False) -> dict:
    """One cell on the production mesh (the process group must be the
    ``"fake"`` one of its world size); writes and returns its record."""
    mesh_name = "multi" if multi_pod else "single"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_name}"
                                     f".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            return json.load(f)
    mod = registry.get_arch(arch)
    shape = mod.SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "kind": shape.kind, "status": "ok"}
    if shape.skip:
        record.update(status="skipped", reason=shape.skip)
    else:
        record.update(_run(arch, shape_name, multi_pod, fp8))
    tag = record["status"].upper() if record["status"] != "ok" else "OK "
    extra = (f"build={record['lower_s']:.1f}s run={record['compile_s']:.1f}s"
             f" flops/chip={record['flops_per_chip']:.3e} "
             f"coll={record['collectives']['bytes_total']:.3e}B"
             if record["status"] == "ok" else
             record.get("error") or record.get("reason", ""))
    print(f"[dryrun] {arch:>20s} {shape_name:>14s} {mesh_name:>6s} {tag} "
          f"{extra}", flush=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def _run(arch: str, shape_name: str, multi_pod: bool, fp8) -> dict:
    t0 = time.time()
    try:
        bundle = steps.build_bundle(arch, shape_name, abstract=True, fp8=fp8)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        train = bundle.kind in ("train", "graph")
        rules = sh.TRAIN_RULES if train else sh.INFER_RULES
        args = steps.shard_args(bundle, mesh, rules)
        t_build = time.time() - t0
        counter = RankCounter()
        with sh.use_mesh(mesh, rules), tally.counting() as kern, \
                torch.set_grad_enabled(train), counter:
            out = bundle.fn(*args)
        t_run = time.time() - t0 - t_build
    except Exception as e:  # noqa: BLE001 -- the record says what failed
        return dict(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-4000:])
    flops = counter.flops + kern["flops"]
    nbytes = counter.bytes + kern["bytes"]
    return dict(
        n_devices=mesh.size(), note=bundle.note,
        rules="train" if train else "infer",
        lower_s=round(t_build, 2), compile_s=round(t_run, 2),
        flops_per_chip=float(flops), bytes_per_chip=float(nbytes),
        cost_analysis={"flops": float(flops),
                       "bytes accessed": float(nbytes),
                       "kernel flops": float(kern["flops"]),
                       "kernel bytes": float(kern["bytes"]),
                       **{f"kernel calls {k}": float(v)
                          for k, v in kern["calls"].items()}},
        memory_analysis={
            "argument_size_in_bytes": _tree_local_bytes(args),
            "output_size_in_bytes": _nbytes(out),
            "temp_size_in_bytes": None, "alias_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
            "note": "local shards of the laid-out arguments and outputs; "
                    "eager code has no XLA buffer assignment"},
        collectives=counter.collectives())


def _cells(args) -> List[Tuple[str, str]]:
    if args.list or args.all or args.arch is None:
        return [(arch, shape) for arch, mod in registry.ARCHS.items()
                for shape in mod.SHAPES
                if not args.arch or arch == args.arch]
    shapes = [args.shape] if args.shape else \
        list(registry.get_arch(args.arch).SHAPES)
    return [(args.arch, s) for s in shapes]


def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--fp8", dest="fp8", action="store_true", default=None)
    ap.add_argument("--no-fp8", dest="fp8", action="store_false")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)

    cells = _cells(args)
    if args.list:
        for c in cells:
            print(*c)
        return
    import torch.distributed as dist
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    n_fail = 0
    t0 = time.time()
    try:
        for multi in meshes:
            _fake_group(512 if multi else 256)
            for arch, shape in cells:
                rec = run_cell(arch, shape, multi, args.out, fp8=args.fp8,
                               force=args.force)
                n_fail += rec["status"] == "error"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    print(f"[dryrun] done in {time.time() - t0:.1f} s; {n_fail} failures",
          flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
