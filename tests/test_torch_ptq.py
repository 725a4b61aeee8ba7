"""The port's PTQ framework against the JAX package's, on the CPU: the int8
quantizers and products (bit for bit), the static-scale path of
``fp8_linear``, the block-scaled dense product, ``quantize_params`` with its
report, ``dequantize_params``, and static activation calibration.  The same
inputs, made from numpy seeds, go through both packages; the JAX side runs
op by op (``jax.disable_jit``) where it runs a model.

Tolerances: quantized payloads, scales and int8 products bit-identical (the
int32 sums are exact); fp8 products within 1 bf16 ulp of the largest output
(f32 summation order); the block-scaled dense product within relative L2
1e-2 of JAX's XLA fold (the fold rounds its operands to bf16; the port
computes the Pallas kernel's function, as the experts do); calibrated
scales within relative 1e-2 (the JAX forward's roundings differ from the
port's in the last bits of activations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import hnp, hypothesis, st
from _torch_parity import aligned_cfg, jax_cfg, torch_params
from repro.configs import onerec_v2 as jax_onerec_v2
from repro.core import policy as jax_policy
from repro.core import ptq as jax_ptq
from repro.core import quant as jax_quant
from repro.models import onerec as jax_onerec
from repro_torch.configs import onerec_v2
from repro_torch.core import policy, ptq, quant
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.layers.moe import _grouped_matmul
from repro_torch.models import onerec
from repro_torch.tree import leaves_with_path

ULP = 2.0 ** -7


def _bytes(a):
    return np.asarray(a).view(np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# INT8 quantizers and products
# ---------------------------------------------------------------------------


def _int8_pair(x):
    """(JAX, port) of the three int8 quantizers on ``x`` (2-D or more)."""
    xj, xt = jnp.asarray(x), _t(x)
    scale = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-12) / 127.0
    return [
        (jax_quant.quantize_per_channel_int8(xj),
         quant.quantize_per_channel_int8(xt)),
        (jax_quant.quantize_per_token_int8(xj),
         quant.quantize_per_token_int8(xt)),
        (jax_quant.QuantizedTensor(jax_quant.cast_to_int8(
            xj, jnp.asarray(scale, jnp.float32)), jnp.asarray(scale)),
         quant.QuantizedTensor(quant.cast_to_int8(
             xt, torch.from_numpy(scale.astype(np.float32))),
             torch.from_numpy(scale)))]


def _assert_int8_identical(x):
    for theirs, ours in _int8_pair(x):
        np.testing.assert_array_equal(ours.data.contiguous().numpy(),
                                      np.asarray(theirs.data))
        np.testing.assert_array_equal(ours.scale.numpy().astype(np.float32),
                                      np.asarray(theirs.scale, np.float32))


@pytest.mark.parametrize("shape", [(6, 256), (3, 4, 96), (2, 128, 64)])
def test_int8_quantizers_bit_identical(shape):
    """Payloads (round half to even, then clip) and scales equal JAX's,
    with values that saturate and values that round at exactly .5."""
    rng = np.random.default_rng(1)
    x = (rng.standard_t(2, size=shape) * 10).astype(np.float32)
    x.reshape(-1)[:8] = [0.5, 1.5, -2.5, 127.5, -0.5, 3.5, 0.0, -127.5]
    _assert_int8_identical(x)


def test_int8_weights_are_k_major():
    """The int8 payload is laid out K-major, the layout ``torch._int_mm``
    reads, with the row-major cast's values."""
    w = np.random.default_rng(2).normal(size=(2, 96, 40)).astype(np.float32)
    q = quant.quantize_per_channel_int8(_t(w))
    assert q.data.stride(-2) == 1
    np.testing.assert_array_equal(
        q.data.numpy(),
        np.asarray(jax_quant.quantize_per_channel_int8(jnp.asarray(w)).data))


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(
    x=hnp.arrays(np.float32, hnp.array_shapes(min_dims=2, max_dims=3,
                                              min_side=1, max_side=24),
                 elements=st.floats(-1e4, 1e4, width=32)),
    mag=st.sampled_from([1e-6, 1e-2, 1.0, 1e3]))
def test_int8_quantizers_bit_identical_property(x, mag):
    """Any shape and magnitude whose amax is at least the scale floor (the
    JAX package's known red ``test_per_token_scale_invariance_pow2`` is an
    amax under it)."""
    x = (x * mag).astype(np.float32)
    hypothesis.assume(np.abs(x).max(-1).min() >= quant._EPS)
    hypothesis.assume(np.abs(x).max(-2).min() >= quant._EPS)
    _assert_int8_identical(x)


@pytest.mark.parametrize("lead", [(5,), (2, 3)])
def test_int8_linear_equals_jax(lead):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(*lead, 64)).astype(np.float32)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    theirs = jax_quant.int8_linear(
        xj, jax_quant.quantize_per_channel_int8(jnp.asarray(w)))
    ours = quant.int8_linear(xt, quant.quantize_per_channel_int8(_t(w)))
    assert ours.dtype == torch.bfloat16 and ours.shape == (*lead, 48)
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                  np.asarray(theirs).view(np.int16))


def test_int8_grouped_product_equals_jax():
    """int8 experts through the grouped per-channel product (the MoE's
    ``_grouped_matmul``), exact int32 sums on both sides."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 10, 64)).astype(np.float32)
    w = rng.normal(size=(3, 64, 40)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    theirs = jax_quant.fp8_grouped_linear(
        xj, jax_quant.quantize_per_channel_int8(jnp.asarray(w)))
    ours = _grouped_matmul(_t(x).to(torch.bfloat16),
                           quant.quantize_per_channel_int8(_t(w)))
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                  np.asarray(theirs).view(np.int16))


# ---------------------------------------------------------------------------
# Static activation scales and the block-scaled dense product
# ---------------------------------------------------------------------------


def _static_case(seed=5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 7, 96)) * 3).astype(np.float32)
    w = rng.normal(size=(96, 64)).astype(np.float32) * 0.1
    # a scale under the input's amax / 448: some values clip
    s = np.float32(np.abs(x).max() / 300.0)
    return x, w, s


def test_static_cast_bit_identical():
    x, _, s = _static_case()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    theirs = jax_quant.cast_to_fp8(xb, jnp.full((1, 1), s, jnp.float32))
    ours = quant.cast_to_fp8(_t(x).to(torch.bfloat16),
                             torch.full((1, 1), float(s)))
    np.testing.assert_array_equal(ours.view(torch.uint8).numpy(),
                                  _bytes(theirs))


@pytest.mark.parametrize("carried", [True, False],
                         ids=["on-the-weight", "argument"])
def test_fp8_linear_static_matches_jax(carried):
    """The static path, the scale carried on the weight or passed: within
    1 bf16 ulp of the largest output of JAX's, and not the dynamic path's
    result."""
    x, w, s = _static_case()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wj = jax_quant.quantize_per_channel(jnp.asarray(w))
    wt = quant.quantize_per_channel(_t(w))
    sj = jnp.full((1, 1), s, jnp.float32)
    st_ = torch.full((1, 1), float(s))
    if carried:
        wj = dataclasses.replace(wj, act_scale=sj)
        wt = dataclasses.replace(wt, act_scale=st_)
        kw_j, kw_t = {}, {}
    else:
        kw_j, kw_t = dict(act_scale=sj), dict(act_scale=st_)
    theirs = np.asarray(jax_quant.fp8_linear(xb, wj, **kw_j), np.float32)
    ours = quant.fp8_linear(_t(x).to(torch.bfloat16), wt, **kw_t).float()
    assert ours.shape == (4, 7, 64)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                               atol=ULP * np.abs(theirs).max())
    dynamic = quant.fp8_linear(_t(x).to(torch.bfloat16),
                               quant.quantize_per_channel(_t(w))).float()
    assert not torch.equal(dynamic, ours)


def test_fp8_gemm_plain_static_mode_is_fp8_linears_math():
    """Kernel ``fp8_gemm``'s plain static mode computes the static path's
    arithmetic: ``(cast(x, s) @ w) * s * sw`` in f32, rounded once."""
    x, w, s = _static_case()
    xt = _t(x).to(torch.bfloat16).reshape(1, 28, 96)
    wq = quant.quantize_per_channel(_t(w))
    sw = wq.scale.reshape(1, 64)
    st_ = torch.full((1, 1), float(s))
    out = gemm_ops.fp8_gemm(xt, wq.data.unsqueeze(0), sw, act_scale=st_)
    xd = quant.cast_to_fp8(xt, st_).float()
    ref = ((xd @ wq.data.float()) * st_ * sw).to(torch.bfloat16)
    assert torch.equal(out, ref)


def test_fp8_block_matmul_matches_jax_fold():
    """A dense weight with 128 x 128 block scales: the port computes the
    Pallas kernel's function (per-block partials scaled in f32), within
    relative L2 1e-2 of JAX's bf16 fold, the experts' tolerance."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 5, 256)).astype(np.float32)
    w = (rng.normal(size=(256, 384)) * 0.05).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    theirs = np.asarray(jax_quant.fp8_block_matmul(
        xb, jax_quant.quantize_blockwise(jnp.asarray(w))), np.float32)
    wq = quant.quantize_blockwise(_t(w))
    ours = quant.matmul_any(_t(x).to(torch.bfloat16), wq).float().numpy()
    assert ours.shape == (3, 5, 384)
    rel = np.linalg.norm(ours - theirs) / np.linalg.norm(theirs)
    assert rel < 1e-2, rel


def test_matmul_any_dispatch():
    """block -> fp8_block_matmul, int8 -> int8_linear, else fp8_linear."""
    rng = np.random.default_rng(7)
    x = _t(rng.normal(size=(4, 128)).astype(np.float32)).to(torch.bfloat16)
    w = _t((rng.normal(size=(128, 128)) * 0.1).astype(np.float32))
    for q, fn in ((quant.quantize_blockwise(w), quant.fp8_block_matmul),
                  (quant.quantize_per_channel_int8(w), quant.int8_linear),
                  (quant.quantize_per_channel(w), quant.fp8_linear)):
        assert torch.equal(quant.matmul_any(x, q), fn(x, q))


# ---------------------------------------------------------------------------
# quantize_params, its report, dequantize_params
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aligned_params():
    return jax_onerec.init_onerec(jax.random.PRNGKey(2),
                                  jax_cfg(aligned_cfg()))


_POLICIES = {
    "paper": lambda m: m.PAPER_POLICY,
    "int8": lambda m: m.PAPER_POLICY.replace(fmt="int8"),
    "mixed": lambda m: (m.PAPER_POLICY
                        .override("*lm_head*", "linear")
                        .override("*/attn/q_proj/kernel", "skip")
                        .override("*/attn/o_proj/kernel", "block")
                        .override("*/attn/k_proj/kernel", "int8")),
}


@pytest.mark.parametrize("name", list(_POLICIES))
def test_ptq_report_matches_jax(aligned_params, name):
    """Entries (path, kind applied, shape, granularity, deciding pattern,
    bytes) equal JAX's, rel_err within 1e-5; payloads and scales
    bit-identical; every leaf tagged with its path."""
    jq, jrep = jax_ptq.quantize_params(
        aligned_params, _POLICIES[name](jax_policy), with_report=True,
        compute_errors=True)
    tq, trep = ptq.quantize_params(
        torch_params(aligned_params), _POLICIES[name](policy),
        with_report=True, compute_errors=True)
    assert len(trep.entries) == len(jrep.entries) > 0
    for a, b in zip(trep.entries, jrep.entries):
        for key in ("path", "kind", "shape", "granularity", "pattern",
                    "bytes_before", "bytes_after"):
            assert a[key] == b[key], (key, a, b)
        assert abs(a["rel_err"] - b["rel_err"]) <= 1e-5, (a, b)
    assert trep.summary().split("rel_err")[0] == \
        jrep.summary().split("rel_err")[0]
    kinds = {e["kind"] for e in trep.entries}
    assert kinds == {"paper": {"linear", "block"}, "int8": {"int8"},
                     "mixed": {"linear", "block", "int8"}}[name]
    jleaves = dict(jax.tree_util.tree_leaves_with_path(
        jq, is_leaf=lambda v: isinstance(v, jax_quant.QuantizedTensor)))
    jleaves = {jax_ptq._path_str(p): v for p, v in jleaves.items()}
    for path, leaf in leaves_with_path(tq):
        if isinstance(leaf, quant.QuantizedTensor):
            other = jleaves[path]
            assert leaf.tag == other.tag == path
            np.testing.assert_array_equal(
                leaf.data.contiguous().view(torch.uint8).numpy(),
                _bytes(other.data))
            np.testing.assert_array_equal(leaf.scale.numpy(),
                                          np.asarray(other.scale))


@pytest.mark.parametrize("name", ["paper", "mixed"])
def test_dequantize_params_matches_jax(aligned_params, name):
    jq = jax_ptq.quantize_params(aligned_params, _POLICIES[name](jax_policy))
    tq = ptq.quantize_params(torch_params(aligned_params),
                             _POLICIES[name](policy))
    theirs = {jax_ptq._path_str(p): v for p, v in
              jax.tree_util.tree_leaves_with_path(
                  jax_ptq.dequantize_params(jq))}
    ours = dict(leaves_with_path(ptq.dequantize_params(tq)))
    assert theirs.keys() == ours.keys()
    for path, t in theirs.items():
        np.testing.assert_array_equal(ours[path].float().numpy(),
                                      np.asarray(t, np.float32), path)


def test_quantized_tensor_slices_and_bytes():
    """A layer slice keeps the tag and slices the static scale; ``nbytes``
    counts payload, scale and static scale as JAX's does."""
    w = np.random.default_rng(8).normal(size=(3, 32, 16)).astype(np.float32)
    q = quant.quantize_per_channel(_t(w))
    q.tag = "stack/attn/q_proj/kernel"
    q = dataclasses.replace(q, act_scale=torch.arange(3.0).reshape(3, 1, 1))
    qj = dataclasses.replace(jax_quant.quantize_per_channel(jnp.asarray(w)),
                             act_scale=jnp.zeros((3, 1, 1)))
    assert q.nbytes() == qj.nbytes() == 3 * 32 * 16 + 4 * 3 * 16 + 4 * 3
    s = q[2]
    assert s.tag == q.tag and s.data.shape == (32, 16)
    assert s.act_scale.shape == (1, 1) and float(s.act_scale) == 2.0


# ---------------------------------------------------------------------------
# Static activation calibration
# ---------------------------------------------------------------------------


def _calibration_inputs(cfg, seed=9):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size - 64, size=(3, 12)).astype(
        np.int32)
    profile = rng.normal(size=(3, onerec.PROFILE_DIM)).astype(np.float32)
    return tokens, profile


@pytest.fixture(scope="module")
def calibrated():
    """The reduced config's scales, calibrated by each package over the
    same batch under the paper's policy."""
    cfg = onerec_v2.reduced_config()
    jcfg = jax_onerec_v2.reduced_config()
    params = jax_onerec.init_onerec(jax.random.PRNGKey(4), jcfg)
    tokens, profile = _calibration_inputs(cfg)
    jq = jax_ptq.quantize_params(params, jax_policy.PAPER_POLICY)
    with jax.disable_jit():
        theirs = jax_ptq.calibrate_static_act_scales(
            lambda q, b: jax_onerec.forward(q, b, jcfg, unroll_layers=True),
            jq, [{"tokens": jnp.asarray(tokens),
                  "profile": jnp.asarray(profile)}])
    tq = ptq.quantize_params(torch_params(params), policy.PAPER_POLICY)
    ours = ptq.calibrate_static_act_scales(
        lambda q, b: onerec.forward(q, b, cfg), tq,
        [{"tokens": _t(tokens), "profile": _t(profile)}])
    return tq, theirs, ours


def test_calibrated_scales_match_jax(calibrated):
    """One key per stacked leaf (every layer folds into its path), the
    same keys as JAX's, values within relative 1e-2."""
    _, theirs, ours = calibrated
    assert ours.keys() == theirs.keys()
    assert {k.rsplit("/", 2)[-2] for k in ours} == {
        "q_proj", "k_proj", "v_proj", "o_proj"}
    for k in ours:
        assert abs(ours[k] - theirs[k]) <= 1e-2 * theirs[k], k


def test_apply_static_act_scales_only_on_per_channel_fp8(calibrated):
    """Scales attach to per-channel fp8 leaves with a calibrated path,
    shaped ``(*data.shape[:-2], 1, 1)``; int8, block and raw leaves stay as
    they were."""
    tq, _, ours = calibrated
    mixed = ptq.quantize_params(
        ptq.dequantize_params(tq, torch.float32),
        policy.PAPER_POLICY.override("*/attn/k_proj/kernel", "int8"))
    applied = ptq.apply_static_act_scales(mixed, ours)
    n = 0
    for path, leaf in leaves_with_path(applied):
        if not isinstance(leaf, quant.QuantizedTensor):
            continue
        if leaf.granularity == "per_channel" and \
                leaf.data.dtype != torch.int8 and path in ours:
            n += 1
            assert leaf.act_scale.shape == (*leaf.data.shape[:-2], 1, 1)
            assert torch.all(leaf.act_scale == torch.tensor(ours[path]))
        else:
            assert leaf.act_scale is None, path
    assert n == 3                       # q, v, o; k is int8


def test_capture_records_only_inside_its_context(calibrated):
    tq = calibrated[0]
    leaf = dict(leaves_with_path(tq))[
        next(p for p, v in leaves_with_path(tq)
             if isinstance(v, quant.QuantizedTensor)
             and p.endswith("q_proj/kernel"))]
    x = torch.full((2, leaf.data.shape[-2]), -3.0, dtype=torch.bfloat16)
    quant.fp8_linear(x, leaf[0])
    with quant.capture_act_amax() as cap:
        quant.fp8_linear(x, leaf[0])
        quant.fp8_linear(x / 2, leaf[1])
    assert cap == {leaf.tag: 3.0}
    assert quant._ACT_AMAX is None


def test_ema_activation_calibration_matches_jax():
    """``calibrate_activation_scales``: the EMA of each tap's amax over the
    batches (momentum 0.9), then its scale, as the JAX package computes
    them from the same taps."""
    rng = np.random.default_rng(10)
    batches = [{"a": rng.normal(size=(4, 16)) * s, "b": rng.normal(size=8)}
               for s in (1.0, 3.0, 0.5)]

    def jax_apply(_, batch):
        return None, {k: jnp.asarray(v, jnp.float32) for k, v in
                      batch.items()}

    def port_apply(_, batch):
        return None, {k: torch.tensor(v, dtype=torch.float32) for k, v in
                      batch.items()}

    theirs = jax_ptq.calibrate_activation_scales(jax_apply, None, batches)
    ours = ptq.calibrate_activation_scales(port_apply, None, batches)
    assert ours.keys() == theirs.keys() == {"a", "b"}
    for k in ours:
        np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                   rtol=1e-6)
