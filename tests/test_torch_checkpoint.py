"""The port's checkpoint store against the JAX package's (ROADMAP.md queue
N, item N9c): the same files, read both ways.

* Round trips through the port of every leaf kind a train state or a
  deployment tree holds: f32, bf16, int32, uint32, fp8 and 0-d leaves,
  ``QuantizedTensor``s with and without ``act_scale``, a padded K-major
  payload (K = 180) laid out again as ``quant.k_major`` lays it out.
* The same tree written by both packages: equal manifest paths, dtypes,
  shapes and hash; each package's ``load_checkpoint`` / ``verify_checkpoint``
  reads the other's file bit for bit.
* JAX-PTQ'd reduced OneRec-V2 params load into the port's PTQ tree of the
  same raw params, bit for bit.
* ``AsyncCheckpointer`` copies before it queues, and its writer's errors
  surface; the store runs with ``ml_dtypes`` blocked.
"""

import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import torch_params
from repro.checkpoint import store as jax_store
from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
from repro_torch import tree as tree_util
from repro_torch.checkpoint import store
from repro_torch.core import quant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ML = {torch.bfloat16: (torch.int16, ml_dtypes.bfloat16),
       torch.float8_e4m3fn: (torch.uint8, ml_dtypes.float8_e4m3fn)}


def _leaf(kind: str, rng):
    def normal(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if kind == "f32":
        return normal(3, 5)
    if kind == "bf16":
        return normal(4, 2).to(torch.bfloat16)
    if kind == "int32":
        return torch.from_numpy(rng.integers(-9, 9, (6,), dtype=np.int32))
    if kind == "uint32":
        return torch.from_numpy(rng.integers(0, 2 ** 32, (2, 3),
                                             dtype=np.uint32))
    if kind == "fp8":
        return (normal(5, 3) * 40).to(torch.float8_e4m3fn)
    if kind == "scalar":
        return torch.tensor(7, dtype=torch.int32)
    if kind == "qt_k180":        # padded K-major payload, no act_scale
        return quant.quantize_per_channel(normal(2, 180, 24))
    if kind == "qt_act":         # 128-block payload with a static act scale
        q = quant.quantize_blockwise(normal(256, 128))
        q.act_scale = torch.full((1, 1), 0.5)
        return q
    raise ValueError(kind)


KINDS = ("f32", "bf16", "int32", "uint32", "fp8", "scalar", "qt_k180",
         "qt_act")


def _tree(rng):
    """Every kind once, under keys whose sort order is not their
    insertion order (``'10'`` before ``'2'``, as JAX flattens)."""
    leaves = {k: _leaf(k, rng) for k in KINDS}
    return {"params": {"10": {k: leaves[k] for k in KINDS[:4]},
                       "2": {k: leaves[k] for k in KINDS[4:]}},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same(a, b):
    """Bit-equal trees of tensors and QuantizedTensors (values, dtypes,
    shapes; the payloads' memory layout too)."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, quant.QuantizedTensor):
        assert (a.granularity, a.block, a.tag) == (b.granularity, b.block,
                                                   b.tag)
        for name in ("data", "scale", "act_scale"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.stride() == b.stride()
        assert torch.equal(_bits(a), _bits(b))


def _np(t):
    if t.dtype in _ML:
        raw, ml = _ML[t.dtype]
        return t.contiguous().view(raw).numpy().view(ml)
    return t.contiguous().numpy()


def _jax_tree(t):
    """The port's tree as the JAX package holds it (ml_dtypes arrays,
    JAX ``QuantizedTensor``s, row-major payloads)."""
    if isinstance(t, dict):
        return {k: _jax_tree(v) for k, v in t.items()}
    if isinstance(t, quant.QuantizedTensor):
        return JaxQuantizedTensor(
            jnp.asarray(_np(t.data)), jnp.asarray(_np(t.scale)),
            t.granularity, t.block,
            None if t.act_scale is None else jnp.asarray(_np(t.act_scale)),
            t.tag)
    return jnp.asarray(_np(t))


def _jax_bits(a):
    a = np.asarray(a)
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(tmp_path, kind):
    """A leaf of each kind saved and loaded by the port: a fresh tree laid
    out like the template (the K-major payload padded to 16 bytes with a
    zero tail), bit-equal; ``in_place`` fills the template's tensors."""
    rng = np.random.default_rng(KINDS.index(kind))
    tree = {"leaf": _leaf(kind, rng), "step": torch.tensor(1)}
    path = store.save_checkpoint(str(tmp_path), 5, tree)
    assert store.verify_checkpoint(path)
    out, manifest = store.load_checkpoint(path, tree)
    assert manifest["step"] == 5
    _same(out, tree)
    leaf = out["leaf"]
    data = leaf.data if isinstance(leaf, quant.QuantizedTensor) else leaf
    assert data.untyped_storage().data_ptr() != \
        (tree["leaf"].data if isinstance(leaf, quant.QuantizedTensor)
         else tree["leaf"]).untyped_storage().data_ptr()
    if kind == "qt_k180":                  # K-major, rows of 192 bytes
        assert data.stride() == (24 * 192, 1, 192)
        base = data.transpose(-1, -2)
        pad = torch.as_strided(base, (2, 24, 12), (24 * 192, 192, 1), 180)
        assert not pad.view(torch.uint8).any()
    blank = store.load_checkpoint(path, tree)[0]
    for t in store._flatten(blank)[1]:
        t.zero_() if t.dtype != torch.float8_e4m3fn else \
            t.view(torch.uint8).zero_()
    got, _ = store.load_checkpoint(path, blank, in_place=True)
    assert got is blank
    _same(got, tree)


def test_same_files_as_jax(tmp_path):
    """One tree written by both packages: equal paths (JAX ``keystr``s,
    ``QuantizedTensor`` children as ``[<flat index i>]``), dtypes, shapes
    and content hash; each package's ``verify_checkpoint`` accepts the
    other's file and its ``load_checkpoint`` reads it bit for bit."""
    tree = _tree(np.random.default_rng(0))
    jtree = _jax_tree(tree)
    ours = store.save_checkpoint(str(tmp_path / "port"), 1, tree)
    theirs = jax_store.save_checkpoint(str(tmp_path / "jax"), 1, jtree)
    manifests = []
    for path in (ours, theirs):
        with open(os.path.join(path, store.MANIFEST)) as f:
            manifests.append(json.load(f))
    for key in ("paths", "dtypes", "shapes", "hash", "step"):
        assert manifests[0][key] == manifests[1][key], key
    assert "['params']['2']['qt_act'][<flat index 2>]" in manifests[0][
        "paths"]
    assert "['params']['2']['qt_k180'][<flat index 2>]" not in manifests[0][
        "paths"]
    assert manifests[0]["paths"][0] == "['opt']['step']"

    assert jax_store.verify_checkpoint(ours)
    assert store.verify_checkpoint(theirs)
    back, _ = jax_store.load_checkpoint(ours, jax.eval_shape(lambda: jtree))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_jax_bits(a), _jax_bits(b))
    out, _ = store.load_checkpoint(theirs, tree)
    _same(out, tree)


def test_jax_ptq_params_load_into_the_port(tmp_path):
    """The paper's FP8 deployment checkpoint crosses: reduced OneRec-V2
    params PTQ'd by the JAX package (paper policy) load into the port's
    PTQ tree of the same raw params, bit for bit, payloads K-major."""
    from repro.configs import registry as jax_registry
    from repro.core.policy import PAPER_POLICY as JAX_POLICY
    from repro.core.ptq import quantize_params as jax_quantize
    from repro.models import onerec as jax_onerec
    from repro_torch.core.policy import PAPER_POLICY
    from repro_torch.core.ptq import quantize_params
    cfg = jax_registry.get_arch("onerec-v2").reduced_config()
    raw = jax_onerec.init_onerec(jax.random.PRNGKey(0), cfg)
    path = jax_store.save_checkpoint(str(tmp_path), 7,
                                     jax_quantize(raw, JAX_POLICY))
    ours = quantize_params(torch_params(raw), PAPER_POLICY)
    n_quantized = sum(isinstance(leaf, quant.QuantizedTensor)
                      for _, leaf in tree_util.leaves_with_path(ours))
    assert n_quantized >= 6
    loaded, manifest = store.load_checkpoint(path, ours)
    assert manifest["step"] == 7
    _same(loaded, ours)


def test_async_checkpointer_writes_the_values_at_save(tmp_path,
                                                      monkeypatch):
    """``save`` copies a CPU tree before it returns: an in-place update
    right after it (as AdamW's) does not reach the file, however late the
    writer runs."""
    go = threading.Event()
    save = store.save_checkpoint

    def late(*args, **kwargs):
        go.wait(10)
        return save(*args, **kwargs)

    monkeypatch.setattr(store, "save_checkpoint", late)
    tree = {"w": torch.arange(6, dtype=torch.float32),
            "q": quant.quantize_per_channel(torch.ones(180, 8))}
    ckpt = store.AsyncCheckpointer(str(tmp_path), keep=2)
    ckpt.save(1, tree)
    before = {"w": tree["w"].clone(),
              "q": quant.quantize_per_channel(torch.ones(180, 8))}
    tree["w"].add_(100.0)
    tree["q"].data.view(torch.uint8).zero_()
    go.set()
    ckpt.close()
    out, _ = store.load_checkpoint(store.latest_checkpoint(str(tmp_path)),
                                   tree)
    _same(out, before)
    assert ckpt.timings and ckpt.timings[0]["bytes"] > 0


def test_async_checkpointer_under_thread_switching(tmp_path):
    """A tree updated in place between 25 saves, the interpreter switching
    threads as often as it can: every checkpoint holds its save's values,
    and the writer has ended after ``close``."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ckpt = store.AsyncCheckpointer(str(tmp_path), keep=100)
        w = torch.zeros(4096)
        for i in range(25):
            w.add_(1.0)
            ckpt.save(i, {"w": w})
        ckpt.close()
    finally:
        sys.setswitchinterval(interval)
    assert not ckpt._thread.is_alive() and len(ckpt.timings) == 25
    for i in range(25):
        out, _ = store.load_checkpoint(
            os.path.join(str(tmp_path), f"step_{i:010d}"), {"w": w})
        assert torch.equal(out["w"], torch.full((4096,), float(i + 1)))


def test_writer_errors_surface(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(store, "save_checkpoint", broken)
    ckpt = store.AsyncCheckpointer(str(tmp_path))
    ckpt.save(1, {"x": torch.zeros(2)})
    ckpt.wait()
    with pytest.raises(OSError, match="disk full"):
        ckpt.save(2, {"x": torch.zeros(2)})
    with pytest.raises(OSError, match="disk full"):
        ckpt.close()


def test_torn_checkpoints_and_foreign_dtypes(tmp_path):
    """A checkpoint without its manifest, one whose hash does not match and
    one holding a dtype torch lacks (``float8_e4m3``, IEEE) are skipped by
    ``latest_checkpoint``; loading the last names its dtype.  A template
    that does not match raises."""
    d = str(tmp_path)
    good = store.save_checkpoint(d, 1, {"x": torch.ones(4)})
    foreign = jax_store.save_checkpoint(
        d, 2, {"x": jnp.ones(4, dtype=ml_dtypes.float8_e4m3)})
    torn = store.save_checkpoint(d, 3, {"x": torch.ones(4)})
    os.remove(os.path.join(torn, store.MANIFEST))
    bad = store.save_checkpoint(d, 4, {"x": torch.ones(4)})
    with open(os.path.join(bad, store.MANIFEST)) as f:
        manifest = json.load(f)
    manifest["hash"] = "0" * 64
    with open(os.path.join(bad, store.MANIFEST), "w") as f:
        json.dump(manifest, f)
    assert store.latest_checkpoint(d) == good
    with pytest.raises(TypeError, match="float8_e4m3"):
        store.load_checkpoint(foreign, {"x": torch.ones(4)})
    with pytest.raises(IOError, match="integrity"):
        store.load_checkpoint(bad, {"x": torch.ones(4)})
    with pytest.raises(ValueError, match="leaves"):
        store.load_checkpoint(good, {"x": torch.ones(4), "y": torch.ones(1)})
    with pytest.raises(ValueError, match="does not match"):
        store.load_checkpoint(good, {"x": torch.ones(5)})


NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
import torch
from repro_torch.checkpoint import store
from repro_torch.core import quant
tree = {"b": torch.randn(3, 5).bfloat16(),
        "f8": torch.randn(7).to(torch.float8_e4m3fn),
        "q": quant.quantize_per_channel(torch.randn(180, 16))}
path = store.save_checkpoint(sys.argv[1], 3, tree)
assert store.verify_checkpoint(path)
out, _ = store.load_checkpoint(path, tree)
u8 = lambda t: t.contiguous().view(torch.uint8)
assert torch.equal(u8(out["b"]), u8(tree["b"]))
assert torch.equal(u8(out["f8"]), u8(tree["f8"]))
assert torch.equal(u8(out["q"].data), u8(tree["q"].data))
assert out["q"].data.stride() == tree["q"].data.stride()
assert "ml_dtypes" not in sys.modules or sys.modules["ml_dtypes"] is None
print("ok")
"""


def test_store_runs_without_ml_dtypes(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", NO_ML_DTYPES,
                          str(tmp_path)], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
