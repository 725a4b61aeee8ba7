"""Tensor parallelism of the port (ROADMAP.md queue N, item N9e.1) against
one rank and against the JAX package: gloo ranks on the CPU, spawned once
(one world-4 job runs ``(1, 4)`` and ``(2, 2)``; the rank bodies are in
``tests/_torch_dist.py``), params laid out by the JAX rules
(``INFER_RULES``) through ``steps.params_axes`` and ``sharding.lay_out``.

* Kernel ``fp8_gemm``'s given-scale mode (plain version): a K-slice cast
  with the whole rows' scales is the slice of the whole rows' payload bit
  for bit, and on the whole K the given mode is the per-token mode.
* ``matmul_any`` on DTensors: column-parallel bit-identical to the
  unsharded product's columns, row-parallel within 1 bf16 ulp (the f32
  partials of the ranks summed in another order), an uncovered layout
  raises; fp8 payloads stay K-major when laid out.  The
  vocabulary-parallel ``gather_rows`` bit-identical.
* Layer 0's ``apply_attention`` with GQA on local heads (reduced
  OneRec-V2: 4 query heads, 2 KV heads, one query head a rank on (1, 4)),
  a shared fill and a decode on a cache laid out over ``kv_seq``: within
  1e-5 of the largest output of one rank's, and the gathered cache equal
  to one rank's.
* The slice: reduced OneRec-V2 with FP8 PTQ (JAX init, bridged) served
  tensor and expert parallel -- prefill into a sequence-sharded cache, a
  decode step, ``generate_items`` -- within 1e-5 of the largest |logit|
  of the port's world 1 and of the JAX package's unsharded ``prefill`` /
  ``decode_step`` under ``jax.disable_jit`` (the reduced config's parity
  tolerance, ``tests/test_torch_model.py``: f32 summation order), equal
  items; on (2, 2) against one rank's run of the data shard's rows alone
  (MoE capacity counts a shard's tokens).  A reduced dense LM (llama3-8b:
  8 query heads, 2 KV heads, the dense MLP gate/up column- and down
  row-parallel) against the port's world 1 at the same tolerance.  A
  rerun bit-identical, and no functional collective on the path.
* ``params_axes`` / ``cache_axes`` / ``batch_axes`` of every registry
  arch's bundles equal to the JAX package's ``arg_axes``.
"""

import functools

import jax
import numpy as np
import pytest
import torch

import _torch_dist as td
from _torch_parity import jax_cfg, onerec_batch, onerec_params
from repro.configs import registry as jax_registry
from repro.core.ptq import quantize_params as jax_quantize_params
from repro.launch import steps as jax_steps
from repro.models import onerec as jax_onerec
from repro_torch import tree as tree_util
from repro_torch.configs import llama3_8b, onerec_v2, registry
from repro_torch.core import quant
from repro_torch.core.ptq import quantize_params
from repro_torch.kernels.fp8_gemm import ops as gemm_ops
from repro_torch.launch import steps
from repro_torch.layers.embedding import gather_rows
from repro_torch.models import onerec
from repro_torch.models import transformer as tfm

CFG = onerec_v2.reduced_config()
LM_CFG = llama3_8b.reduced_config()
B = 4
REL = 1e-5          # of the largest |output|: f32 summation order
MESHES = [(1, 4), (2, 2)]
IDS = ["1x4", "2x2"]


def _bf16_ulps(a, b):
    a, b = a.float(), b.float()
    mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
    ulp = torch.ldexp(torch.ones_like(mag), torch.frexp(mag)[1] - 8)
    return ((a - b).abs() / ulp).max().item()


def _close(got, want, rel=REL):
    got, want = torch.as_tensor(got).float(), torch.as_tensor(want).float()
    assert got.shape == want.shape
    dev = (got - want).abs().max().item()
    assert dev <= rel * want.abs().max().item(), dev


@functools.lru_cache(maxsize=None)
def _inputs():
    """The bridged PTQ'd OneRec params (port and JAX), a batch, a decode
    token a row, the LM's params and tokens, the layouts' operands and
    layer 0's attention inputs."""
    jraw, traw = onerec_params()
    batch_np = onerec_batch(CFG, B)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    rng = np.random.default_rng(5)
    dec = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, 1))
                           .astype(np.int32))
    lm_params = tfm.init_transformer(
        torch.Generator().manual_seed(0), LM_CFG,
        transform=lambda p, t: quantize_params(t, prefix=p))
    lm_tok = torch.from_numpy(rng.integers(0, LM_CFG.vocab_size, (B, 12))
                              .astype(np.int32))
    lm_dec = torch.from_numpy(rng.integers(0, LM_CFG.vocab_size, (B, 1))
                              .astype(np.int32))
    x = torch.from_numpy(rng.normal(size=(24, 64)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32) / 8)
    table = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 256, (3, 5)))
    layouts = (x, quant.quantize_per_channel(w), w, table, ids)
    lp = tree_util.index(quantize_params(traw)["backbone"]["stacks"]["0"][
        "p0"]["attn"], 0)
    spec = tfm.attn_spec_for(CFG.transformer, tfm.LayerKind("full", "moe"))
    d = CFG.transformer.d_model
    attn = (lp, spec, torch.from_numpy(rng.normal(size=(2, 12, d)).astype(
        np.float32)).to(torch.bfloat16), torch.from_numpy(rng.normal(
            size=(2, 1, d)).astype(np.float32)).to(torch.bfloat16))
    return (jraw, quantize_params(traw), batch, dec, lm_params, lm_tok,
            lm_dec, layouts, attn)


INDEX = CFG.history_len * CFG.n_codebooks + 1     # after [profile] + tokens


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    (_, params, batch, dec, lm_params, lm_tok, lm_dec, layouts,
     attn) = _inputs()
    return td.run(4, td.tp_job, (params, batch, dec, INDEX, lm_params,
                                 lm_tok, lm_dec, layouts, attn),
                  str(tmp_path_factory.mktemp("tp")))


@functools.lru_cache(maxsize=None)
def _world1(n_data: int, d: int):
    """One rank's OneRec outputs on data shard ``d`` of ``n_data``: the
    port's and the JAX package's (op by op)."""
    jraw, params, batch, dec, *_ = _inputs()
    rows = slice(d * B // n_data, (d + 1) * B // n_data)
    part = {k: v[rows] for k, v in batch.items()}
    cache = onerec.init_cache(CFG, rows.stop - rows.start)
    logits, cache = onerec.prefill(params, part, CFG, cache)
    step, _ = onerec.decode_step(params, dec[rows], CFG, cache, INDEX)
    port = {"prefill": logits, "decode": step,
            "items": onerec.generate_items(params, part, CFG)}
    jcfg = jax_cfg(CFG)
    jparams = jax_quantize_params(jraw)
    with jax.disable_jit():
        jcache = jax_onerec.init_cache(jcfg, rows.stop - rows.start)
        jlog, jcache = jax_onerec.prefill(
            jparams, {k: np.asarray(v) for k, v in part.items()}, jcfg,
            jcache)
        jstep, _ = jax_onerec.decode_step(jparams, np.asarray(dec[rows]),
                                          jcfg, jcache, np.int32(INDEX))
    return port, {"prefill": np.asarray(jlog), "decode": np.asarray(jstep)}


def _part(want, local):
    """The slice of one rank's ``want`` that a local shard holds."""
    got, (r0, rn), (c0, cn) = local
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want))
    if want.shape[0] != got.shape[0]:
        want = want[r0:r0 + rn]
    if want.shape[-1] != got.shape[-1]:
        want = want[..., c0:c0 + cn]
    return got, want


def test_given_scale_plain_is_the_payloads_slice():
    rng = np.random.default_rng(1)
    k = 96
    x = torch.from_numpy(rng.normal(size=(1, 7, 4 * k)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = quant.quantize_per_channel(torch.from_numpy(
        rng.normal(size=(4 * k, 40)).astype(np.float32) / 16))
    sw = w.scale.reshape(1, -1).contiguous()
    rows = quant.amax_to_scale(x.float().abs().amax(-1))       # (1, M)
    whole = quant.cast_to_fp8(x, rows[..., None])
    for r in range(4):
        part = quant.cast_to_fp8(x[..., r * k:(r + 1) * k], rows[..., None])
        assert torch.equal(part.view(torch.uint8),
                           whole[..., r * k:(r + 1) * k].view(torch.uint8))
    wd = w.data.unsqueeze(0)
    for dtype in (torch.bfloat16, torch.float32):
        assert torch.equal(
            gemm_ops.fp8_gemm(x, wd, sw, out_dtype=dtype, row_scale=rows),
            gemm_ops.fp8_gemm(x, wd, sw, out_dtype=dtype))
    with pytest.raises(ValueError, match="static scale or given row"):
        gemm_ops.check_layout(x, wd, sw, torch.float32,
                              act_scale=rows[0, :1], row_scale=rows)


@pytest.mark.parametrize("what", ["prefill", "decode", "items"])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_onerec_tp_matches_world1_and_jax(ranks, mesh, what):
    n_data, n_model = mesh
    for rank, out in enumerate(ranks):
        res = out[mesh]["onerec"]
        port, jax_ref = _world1(n_data, rank // n_model)
        got, want = _part(port[what], res[what])
        if what == "items":
            assert torch.equal(got, want), rank
            continue
        _close(got, want)
        _close(*_part(jax_ref[what], res[what]))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_dense_lm_tp_matches_world1(ranks, mesh):
    n_data, n_model = mesh
    *_, lm_params, lm_tok, lm_dec, _, _ = _inputs()
    for rank, out in enumerate(ranks):
        rows = slice((rank // n_model) * B // n_data,
                     (rank // n_model + 1) * B // n_data)
        tok = lm_tok[rows]
        cache = tfm.init_kv_cache(LM_CFG, tok.shape[0], tok.shape[1] + 1,
                                  per_slot=False)
        logits, cache = tfm.prefill(lm_params, tok, LM_CFG, cache)
        step, _ = tfm.decode_step(lm_params, lm_dec[rows], LM_CFG, cache,
                                  tok.shape[1])
        res = out[mesh]["lm"]
        _close(*_part(logits, res["prefill"]))
        _close(*_part(step, res["decode"]))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_product_layouts_and_lookup(ranks, mesh):
    x, wq, w, table, ids = _inputs()[7]
    for out in ranks:
        res = out[mesh]["layouts"]
        for name, weight in (("fp8", wq), ("raw", w)):
            want = quant.matmul_any(x, weight)
            got, part = _part(want, res[f"column_{name}"])
            assert torch.equal(got, part)
            got, part = _part(want, res[f"row_{name}"])
            assert _bf16_ulps(got, part) <= 1.0
            assert "no tensor-parallel product" in res[f"uncovered_{name}"]
        assert res["k_major_fp8"] == [True, True]
        got, part = _part(gather_rows(table, ids), res["rows"])
        assert torch.equal(got, part)


def test_attention_on_local_heads_and_a_sequence_sharded_cache(ranks):
    from repro_torch.layers import attention
    lp, spec, x_pre, x_dec = _inputs()[8]
    cache = attention.init_cache(x_pre.shape[0], x_pre.shape[1] + 4, spec,
                                 per_slot=False)
    pre, _ = attention.apply_attention(lp, x_pre, spec, cache=cache,
                                       fill_cache=True)
    dec, _ = attention.apply_attention(lp, x_dec, spec, cache=cache,
                                       cache_index=x_pre.shape[1])
    for out in ranks:
        res = out[(1, 4)]["attention"]
        assert "Shard(dim=1)" in res["kv_cache_placements"]
        _close(res["prefill"], pre)
        _close(res["decode"], dec)
        for name, leaf in cache.items():
            assert torch.equal(res["cache"][name], leaf), name


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_reruns_identical_and_no_functional_collectives(ranks, mesh):
    for out in ranks:
        res = out[mesh]
        assert res["functional"] == []
        for what in ("prefill", "decode", "items"):
            assert torch.equal(res["rerun"][what][0],
                               res["onerec"][what][0])


def _jax_axes(axes):
    """{path: axes} of a JAX ``arg_axes`` tree (tuples of names leaves)."""
    leaves = jax.tree_util.tree_flatten_with_path(
        axes, is_leaf=lambda x: isinstance(x, tuple) and all(
            isinstance(e, (str, type(None))) for e in x))[0]
    return {jax_steps._path_str(p): tuple(a) for p, a in leaves}


def _port_axes(axes):
    out = {}
    for i, arg in enumerate(axes):
        if not isinstance(arg, dict):        # the decode index: ()
            out[f"{i}/"] = tuple(arg)
            continue
        for path, leaf in td.jax_leaves(arg):
            out[f"{i}/{path}"] = tuple(leaf)
    return out


@pytest.mark.parametrize("arch", list(registry.ARCHS))
def test_arg_axes_match_jax(arch):
    """Every smoke bundle of the arch (the port's on ``meta``, the JAX
    package's abstract): the same logical axes for every argument leaf."""
    fam = registry.get_arch(arch).FAMILY
    for shape in steps.SMOKE_SHAPES[fam].values():
        ours = steps.build_bundle(arch, shape.name, reduced=True,
                                  shape_override=shape, device="meta")
        theirs = jax_steps.build_bundle(arch, shape.name, reduced=True,
                                        abstract=True, shape_override=shape)
        assert jax_registry.get_arch(arch).FAMILY == fam
        assert ours.donate == tuple(theirs.donate)
        want = {f"{i}/{p}": a for i, ax in enumerate(theirs.arg_axes)
                for p, a in _jax_axes(ax).items()}
        assert _port_axes(ours.arg_axes) == want, (arch, shape.name)
