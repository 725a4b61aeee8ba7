"""The port's dry run (``repro_torch.launch.dryrun``, ROADMAP.md queue N,
item N9e.2): one cell end to end in a subprocess (the ``"fake"`` process
group of 256 ranks, ``meta`` tensors), its ``flops_per_chip`` against the
rank's products reckoned by hand from the layout; the collective counter
on a known redistribution, in JAX's ``collective_bytes`` schema; the cell
list against the JAX dry run's; the cells that wait for later items."""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import onerec_v2
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# repro/launch/dryrun.py::collective_bytes's keys
SCHEMA = ({f"{p}_{k}" for p in ("bytes", "count") for k in (
    "all_reduce", "all_gather", "reduce_scatter", "all_to_all",
    "collective_permute")}
    | {"bytes_total", "bytes_total_unscaled", "while_trip_counts"})


def _env():
    return dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")


def _onerec_prefill_flops() -> float:
    """A rank's products at OneRec-V2's prefill_b32 on the (16, 16) mesh
    under INFER_RULES: 2 of 32 rows (data), 385 positions; one query head
    of 16 and 32 of k/v's 512 columns (model; k/v gathered after); o_proj
    over its 128-deep slice of K; the router replicated; one expert of 16
    padded at capacity 200 (770 tokens x top-2 x 1.5 / 12 experts, to a
    multiple of 8); the profile projection; the head's 516 of 8256
    columns at the last position."""
    cfg = onerec_v2.CONFIG.transformer
    rows, t, d = 2, 385, cfg.d_model
    m = rows * t
    layer = (2 * m * d * 128 + 2 * 2 * m * d * 32       # q; k, v
             + rows * 4 * t * t * 128                    # scores and PV
             + 2 * m * 128 * d                           # o_proj
             + 2 * m * d * 16                            # router
             + 3 * 2 * 200 * d * cfg.d_expert)           # one expert
    return (cfg.n_layers * layer + 2 * rows * 64 * d
            + 2 * rows * d * (cfg.vocab_size // 16))


@pytest.mark.slow
def test_dryrun_cell_subprocess(tmp_path):
    """One cell on the 256-rank mesh, end to end (the JAX package's
    ``test_dryrun_cell_subprocess`` is marked slow: so is this)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "onerec-v2", "--shape", "prefill_b32", "--mesh", "single",
         "--force", "--out", str(tmp_path)],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr
    rec = json.loads((tmp_path / "onerec-v2__prefill_b32__single.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    want = _onerec_prefill_flops()
    assert abs(rec["flops_per_chip"] - want) <= 0.01 * want, (
        rec["flops_per_chip"], want)
    assert set(rec["collectives"]) == SCHEMA
    assert rec["collectives"]["count_all_reduce"] > 0
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0


@pytest.fixture
def fake_mesh():
    """A (4, 4) mesh on the ``"fake"`` process group in this process,
    torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=16)
    try:
        yield init_device_mesh("cpu", (4, 4),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_collectives_counted_as_jax_counts_them(fake_mesh):
    """A gather over ``model`` counts the gathered bytes (the collective's
    output), an all-reduce the reduced tensor; the functional collectives
    by their outputs too."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    local = torch.empty((2, 3), device="meta")
    x = DTensor.from_local(local, fake_mesh, [Shard(0), Shard(1)],
                           run_check=False)
    counter = dryrun.RankCounter()
    with counter:
        y = sh.redistribute(x, [Shard(0), Replicate()])
        sh.all_reduce(torch.empty(5, device="meta"),
                      fake_mesh.get_group("model"))
        funcol.all_reduce(torch.empty(7, device="meta"), "sum",
                          fake_mesh.get_group("data"))
    assert tuple(y.to_local().shape) == (2, 12)
    rec = counter.collectives()
    assert set(rec) == SCHEMA
    assert rec["bytes_all_gather"] == 2 * 12 * 4
    assert rec["count_all_gather"] == 1
    assert rec["bytes_all_reduce"] == (5 + 7) * 4
    assert rec["count_all_reduce"] == 2
    assert rec["bytes_total"] == 2 * 12 * 4 + 12 * 4
    assert rec["while_trip_counts"] == []


def test_list_names_the_jax_cells():
    ours = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--list"],
        env=_env(), capture_output=True, text=True, timeout=120, cwd=ROOT)
    theirs = subprocess.run(
        [sys.executable, "-m", "repro.launch.dryrun", "--list"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert ours.returncode == 0 and theirs.returncode == 0, theirs.stderr
    assert ours.stdout.split("\n") == theirs.stdout.split("\n")
    assert len(ours.stdout.split()) == 2 * 43       # 40 + OneRec-V2's 3


@pytest.mark.parametrize("arch,shape,status,item", [
    ("onerec-v2", "train_b512", "not_ported", "N9e.3"),
    ("llama3-8b", "train_4k", "not_ported", "N9e.3"),
    ("din", "serve_p99", "not_ported", "N9e.5"),
    ("two-tower-retrieval", "retrieval_cand", "not_ported", "N9e.5"),
    ("egnn", "molecule", "not_ported", "N9e.3"),
    ("egnn", "ogb_products", "not_ported", "N9e.7"),
    ("llama3-8b", "long_500k", "skipped", None)])
def test_waiting_and_skipped_cells(tmp_path, arch, shape, status, item):
    rec = dryrun.run_cell(arch, shape, False, str(tmp_path))
    assert rec["status"] == status
    assert rec.get("item") == item
    if item:
        assert f"item {item}" in rec["reason"]
    on_disk = json.loads((tmp_path / f"{arch}__{shape}__single.json")
                         .read_text())
    assert on_disk == rec
