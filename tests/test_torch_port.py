"""The port's ground rules, checked on the CPU: its configs and policy are
the JAX package's field for field, PTQ and KV quantization are bit-identical,
it imports neither JAX nor the JAX package, and its entry points refuse to
fall back to the CPU quietly."""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import torch_params
from repro.configs import onerec_v2 as jax_onerec_v2
from repro.core import policy as jax_policy
from repro.core import quant as jax_quant
from repro.core.ptq import quantize_params as jax_quantize_params
from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
from repro.models import onerec as jax_onerec
from repro_torch.configs import onerec_v2
from repro_torch.core import policy, quant
from repro_torch.core.ptq import quantize_params
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.tree import leaves_with_path
from repro_torch.weights import tensor_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name", ["CONFIG", "reduced_config"])
def test_configs_equal_field_for_field(name):
    ours = getattr(onerec_v2, name)
    theirs = getattr(jax_onerec_v2, name)
    ours = ours() if callable(ours) else ours
    theirs = theirs() if callable(theirs) else theirs
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.context_len == theirs.context_len
    assert ours.vocab_size == theirs.vocab_size


def test_policy_is_a_verbatim_copy():
    with open(os.path.join(ROOT, "src/repro/core/policy.py")) as a, \
            open(os.path.join(ROOT, "src/repro_torch/core/policy.py")) as b:
        assert a.read() == b.read()


@pytest.fixture(scope="module")
def reduced_params():
    cfg = jax_onerec_v2.reduced_config()
    return jax_onerec.init_onerec(jax.random.PRNGKey(3), cfg)


def test_classify_agrees_on_every_param_path(reduced_params):
    ours = torch_params(reduced_params)
    paths = [p for p, _ in leaves_with_path(ours)]
    assert any(p.endswith("moe/experts/gate") for p in paths)
    for pol_name in ("PAPER_POLICY", "BASELINE_POLICY"):
        jp, tp = getattr(jax_policy, pol_name), getattr(policy, pol_name)
        for path, leaf in leaves_with_path(ours):
            shape = tuple(leaf.shape)
            assert tp.classify(path, len(shape), shape) == \
                jp.classify(path, len(shape), shape), path


def _jax_leaves(tree, prefix=""):
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _jax_leaves(v, p)
        else:
            yield p, v


def _bytes(a):
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("aligned", [False, True], ids=["reduced", "aligned"])
def test_ptq_bit_identical(reduced_params, aligned):
    """Payloads and scales of every quantized leaf match JAX bit for bit,
    per-channel leaves and (on 128-aligned expert shapes) block leaves."""
    params = reduced_params
    if aligned:
        rng = np.random.default_rng(0)
        params = {"stacks": {"0": {"p0": {"moe": {"experts": {
            "gate": jnp.asarray(rng.normal(size=(2, 3, 256, 128)) * 0.05,
                                jnp.float32)}}, "attn": {"q_proj": {
                "kernel": jnp.asarray(rng.normal(size=(2, 128, 256)),
                                      jnp.float32)}}}}}}
    theirs = dict(_jax_leaves(jax_quantize_params(params),))
    ours = dict(leaves_with_path(quantize_params(torch_params(params))))
    assert theirs.keys() == ours.keys()
    n_quant = 0
    for path, t in theirs.items():
        o = ours[path]
        if isinstance(t, JaxQuantizedTensor):
            n_quant += 1
            assert isinstance(o, quant.QuantizedTensor), path
            assert o.granularity == t.granularity and o.tag == t.tag == path
            np.testing.assert_array_equal(
                o.data.view(torch.uint8).numpy(), _bytes(t.data))
            np.testing.assert_array_equal(o.scale.numpy(),
                                          np.asarray(t.scale))
        else:
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    assert n_quant >= 2
    if aligned:
        assert ours["stacks/0/p0/moe/experts/gate"].granularity == "block"


@pytest.mark.parametrize("aligned", [False, True], ids=["reduced", "aligned"])
def test_ptq_lays_per_channel_payloads_k_major(reduced_params, aligned):
    """Every per-channel fp8 leaf is the transpose view of a contiguous
    ``(..., out, in)`` array (the layout kernel ``fp8_gemm`` reads), keeps
    its ``(..., in, out)`` shape, and holds the JAX PTQ's bytes; its layer
    slices (``QuantizedTensor.__getitem__``) stay K-major."""
    params = reduced_params
    if aligned:
        rng = np.random.default_rng(1)
        params = {"stacks": {"0": {"p0": {"attn": {"o_proj": {
            "kernel": jnp.asarray(rng.normal(size=(3, 256, 128)),
                                  jnp.float32)}}}}}}
    theirs = dict(_jax_leaves(jax_quantize_params(params)))
    n_channel = 0
    for path, o in leaves_with_path(quantize_params(torch_params(params))):
        if not isinstance(o, quant.QuantizedTensor) \
                or o.granularity != "per_channel":
            continue
        n_channel += 1
        t = theirs[path]
        assert tuple(o.data.shape) == tuple(t.data.shape), path
        assert o.data.stride(-2) == 1, (path, o.data.stride())
        assert o.data.mT.is_contiguous(), path
        np.testing.assert_array_equal(o.data.view(torch.uint8).numpy(),
                                      _bytes(t.data))
        layer = o[o.data.shape[0] - 1]
        assert layer.data.stride(-2) == 1 and layer.data.mT.is_contiguous()
    assert n_channel >= 1


@pytest.mark.parametrize("stack", [(3,), (2, 3)], ids=["experts", "layers"])
def test_ptq_lays_block_payloads_k_major(stack):
    """Every 128-block fp8 leaf is the transpose view of a contiguous
    ``(..., out, in)`` array (the layout kernel ``fp8_grouped_gemm``
    reads), keeps its ``(..., in, out)`` shape, and holds the JAX PTQ's
    bytes and scales; its layer slices stay K-major and pass the grouped
    kernel's layout check."""
    from repro_torch.kernels.fp8_grouped_gemm import ops as grouped_ops
    rng = np.random.default_rng(4)
    params = {"stacks": {"0": {"p0": {"moe": {"experts": {
        name: jnp.asarray(rng.normal(size=stack + shape) * 0.05, jnp.float32)
        for name, shape in (("gate", (256, 384)), ("up", (256, 384)),
                            ("down", (384, 256)))}}}}}}
    theirs = dict(_jax_leaves(jax_quantize_params(params)))
    n_block = 0
    for path, o in leaves_with_path(quantize_params(torch_params(params))):
        assert isinstance(o, quant.QuantizedTensor), path
        assert o.granularity == "block", path
        n_block += 1
        t = theirs[path]
        assert tuple(o.data.shape) == tuple(t.data.shape), path
        assert o.data.stride(-2) == 1, (path, o.data.stride())
        assert o.data.mT.is_contiguous(), path
        np.testing.assert_array_equal(o.data.view(torch.uint8).numpy(),
                                      _bytes(t.data))
        np.testing.assert_array_equal(o.scale.numpy(), np.asarray(t.scale))
        layer = o[o.data.shape[0] - 1] if len(stack) == 2 else o
        assert layer.data.stride(-2) == 1 and layer.data.mT.is_contiguous()
        e, k, n = layer.data.shape
        grouped_ops.check_layout(torch.zeros(e, 8, k, dtype=torch.bfloat16),
                                 layer.data, layer.scale, torch.bfloat16)
    assert n_block == 3


@pytest.mark.parametrize("which", ["reduced", "paged_test", "aligned"])
def test_fp8_gemm_kernel_takes_every_per_channel_leaf(which):
    """The CUDA ``fp8_gemm`` wrapper's checks (pure Python, so they run
    here) accept every layer slice of every per-channel leaf of the small
    configs after PTQ: K % 16 == 0 and K-major strides.  The full-width
    config's contraction dims (d_model, heads x head_dim) meet K % 16 too."""
    from _torch_parity import aligned_cfg, paged_test_cfg
    from repro_torch.kernels.fp8_gemm import ops as gemm_ops
    from repro_torch.models.onerec import init_onerec
    cfg = {"reduced": onerec_v2.reduced_config, "paged_test": paged_test_cfg,
           "aligned": aligned_cfg}[which]()
    params = quantize_params(init_onerec(0, cfg, device="cpu"))
    n_checked = 0
    for path, w in leaves_with_path(params):
        if not isinstance(w, quant.QuantizedTensor) \
                or w.granularity != "per_channel":
            continue
        for i in range(w.data.shape[0]):
            wi = w[i].data if w.data.ndim == 4 else w[i].data[None]
            e, k, n = wi.shape
            x = torch.zeros(e, 1, k, dtype=torch.bfloat16)
            gemm_ops.check_layout(x, wi, torch.zeros(e, n), torch.bfloat16)
            n_checked += 1
    assert n_checked >= 8
    full = onerec_v2.CONFIG.transformer
    assert full.d_model % 16 == 0 and (full.n_heads * full.head_dim) % 16 == 0


@pytest.mark.parametrize("shape", [(4, 7, 2, 16), (3, 5, 4, 128)])
def test_quantize_kv_bit_identical(shape):
    rng = np.random.default_rng(1)
    x = (rng.normal(size=shape) * rng.uniform(0.01, 30, size=shape[:-1]
                                              + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0                       # an all-zero row hits the eps floor
    xj = jnp.asarray(x, jnp.bfloat16)
    dj, sj = jax_quant.quantize_kv(xj)
    dt, st = quant.quantize_kv(tensor_from_numpy(np.asarray(xj)))
    np.testing.assert_array_equal(dt.view(torch.uint8).numpy(), _bytes(dj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    back_j = jax_quant.dequantize_kv(dj, sj)
    back_t = quant.dequantize_kv(dt, st)
    np.testing.assert_array_equal(back_t.view(torch.int16).numpy(),
                                  np.asarray(back_j).view(np.int16))


def test_quantizers_bit_identical():
    """Per-token and 1 x 128 activation quantization, including values that
    saturate the e4m3 range after the scale division."""
    rng = np.random.default_rng(2)
    x = rng.standard_t(2, size=(6, 256)).astype(np.float32) * 10
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    for jfn, tfn in ((jax_quant.quantize_per_token, quant.quantize_per_token),
                     (lambda a: jax_quant.quantize_blockwise(a, act=True),
                      lambda a: quant.quantize_blockwise(a, act=True))):
        qj, qt = jfn(xj), tfn(xt)
        np.testing.assert_array_equal(qt.data.view(torch.uint8).numpy(),
                                      _bytes(qj.data))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax"), \
                f"{path} imports {mod}"


def test_engine_refuses_a_quiet_cpu_fallback(monkeypatch):
    """Without ``device="cpu"`` the engine (and the param init) raise where
    CUDA is absent; with it they run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = onerec_v2.reduced_config()
    from repro_torch.models.onerec import init_onerec
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_onerec(0, cfg)
    params = init_onerec(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine(params, cfg, EngineConfig(batch_size=2))
    engine = ServingEngine(params, cfg, EngineConfig(batch_size=2),
                           device="cpu")
    assert engine.device.type == "cpu"


@pytest.mark.parametrize("setting", [
    dict(n_dense_layers=1), dict(use_qk_norm=True),
    dict(sliding_window=8)])
def test_unported_engine_settings_name_their_roadmap_item(setting):
    """Since the LM zoo (ROADMAP.md N7a) the engine takes a OneRec backbone
    with a leading dense layer or QK-norm, token-identical to the JAX
    engine (paged, fp8 weights and K/V, op by op); a sliding window it
    refuses with the JAX engine's ``ValueError`` (paged and per-slot
    caches need full attention), in both layouts."""
    from _torch_parity import assert_same_runs, jax_cfg, paged_test_cfg
    from _torch_parity import policy_requests, serve_both
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro.serving import ServingEngine as JaxServingEngine
    cfg = paged_test_cfg()
    cfg = dataclasses.replace(cfg, transformer=dataclasses.replace(
        cfg.transformer, **setting))
    jax_params = jax_onerec.init_onerec(jax.random.PRNGKey(5), jax_cfg(cfg))
    if "sliding_window" in setting:
        for paged in (True, False):
            kw = dict(paged=paged, fused_decode=False, batch_size=2)
            with pytest.raises(ValueError, match="require full attention"):
                JaxServingEngine(jax_params, jax_cfg(cfg),
                                 JaxEngineConfig(**kw))
            with pytest.raises(ValueError, match="require full attention"):
                ServingEngine(torch_params(jax_params), cfg, EngineConfig(
                    **dict(kw, fused_decode="off")), device="cpu")
        return
    runs = serve_both(jax_params, cfg, policy_requests(cfg, 4, seed=11),
                      batch_size=4, kv_dtype="float8_e4m3fn", page_size=8)
    assert_same_runs(runs)
    assert runs[0][3]["decode_steps"] > 0
