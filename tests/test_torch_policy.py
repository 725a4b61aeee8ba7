"""The port's engine deploying a tuned ``quant_policy`` against the JAX
engine, on the CPU: a ``QuantPolicy`` and a policy artifact path (with and
without calibrated static activation scales) give TOKEN-IDENTICAL
completions in both KV layouts, a bad ``quant_policy`` raises as the JAX
engine does, and the launcher deploys an artifact with ``--quant-policy``
(ported from ``tests/test_autotune.py``'s engine tests).

The config is ``tests/test_paged_kv.py``'s, MoE capacity lifted so batch
composition cannot perturb outputs; fp8 K/V.  The JAX engine runs op by op
(``jax.disable_jit``), as in the port's other engine parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import jax_cfg, paged_test_cfg, torch_params
from repro.core import policy as jax_policy
from repro.core import ptq as jax_ptq
from repro.core.quant import QuantizedTensor as JaxQuantizedTensor
from repro.models import onerec as jax_onerec
from repro.serving import EngineConfig as JaxEngineConfig
from repro.serving import ServingEngine as JaxServingEngine
from repro.serving.requests import make_request
from repro_torch.core import policy
from repro_torch.core.quant import QuantizedTensor
from repro_torch.serving import EngineConfig, ServingEngine
from repro_torch.tree import leaves_with_path

PAGE = 8
# fp8 everywhere the paper quantizes, the logits head in fp8 too, the k
# projections in int8 and the v projections left in high precision: every
# kind of decision an artifact carries
OVERRIDES = (("*/attn/v_proj/kernel", "skip"),
             ("*/attn/k_proj/kernel", "int8"),
             ("*lm_head*", "linear"))


def _policy(module, static=False):
    pol = module.PAPER_POLICY.replace(static_acts=static)
    for pattern, decision in reversed(OVERRIDES):
        pol = pol.override(pattern, decision)
    return pol


@pytest.fixture(scope="module")
def setup():
    cfg = paged_test_cfg()
    jcfg = jax_cfg(cfg)
    params = jax_onerec.init_onerec(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(31)
    reqs = []
    for _ in range(6):
        n_items = int(rng.integers(2, cfg.history_len + 1))
        reqs.append(make_request(
            rng.integers(0, 192, size=n_items * cfg.n_codebooks),
            rng.normal(size=jax_onerec.PROFILE_DIM)))
    return cfg, jcfg, params, reqs


def _serve(setup, paged, jax_policy_arg, port_policy_arg):
    """The same requests through both engines; returns (JAX items, port
    items, the port engine)."""
    cfg, jcfg, params, reqs = setup
    base = dict(batch_size=4, n_slots=3, kv_dtype="float8_e4m3fn",
                page_size=PAGE, paged=paged)
    jax_engine = JaxServingEngine(params, jcfg, JaxEngineConfig(
        fused_decode=False, quant_policy=jax_policy_arg, **base))
    with jax.disable_jit():
        ref, _ = jax_engine.serve_requests(reqs)
    engine = ServingEngine(torch_params(params), cfg, EngineConfig(
        fused_decode="auto" if paged else "off", quant_policy=port_policy_arg,
        **base), device="cpu")
    out, stats = engine.serve_requests(reqs)
    assert stats["n_requests"] == len(reqs)
    return ref, out, engine


def _assert_same(ref, out):
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
@pytest.mark.parametrize("form", ["policy", "artifact"])
def test_quant_policy_token_identical_to_jax(setup, tmp_path, paged, form):
    """The policy in code (each package's ``QuantPolicy``) or as an
    artifact path read by both engines: the same completions, and the
    port's executor holds the policy and its int8 / fp8 / raw leaves."""
    if form == "policy":
        args = _policy(jax_policy), _policy(policy)
    else:
        path = str(tmp_path / "quant_policy.json")
        policy.save_policy_artifact(path, _policy(policy),
                                    config="onerec-paged-test")
        args = path, path
    ref, out, engine = _serve(setup, paged, *args)
    _assert_same(ref, out)
    assert engine.executor.quant_policy == _policy(policy)
    leaves = dict(leaves_with_path(engine.executor.params))
    k = next(v for p, v in leaves.items() if p.endswith("k_proj/kernel"))
    v = next(v for p, v in leaves.items() if p.endswith("v_proj/kernel"))
    head = leaves["backbone/lm_head/kernel"]
    assert isinstance(k, QuantizedTensor) and str(k.data.dtype) == \
        "torch.int8"
    assert not isinstance(v, QuantizedTensor)
    assert isinstance(head, QuantizedTensor) and head.act_scale is None


@pytest.fixture(scope="module")
def jax_scales(setup):
    """Static scales calibrated by the JAX package (its forward, op by op,
    over the requests' histories cut to the shortest), so both engines
    attach the same values."""
    cfg, jcfg, params, reqs = setup
    t = min(len(r["tokens"]) for r in reqs)
    batch = {"tokens": jnp.asarray(np.stack([r["tokens"][:t]
                                             for r in reqs])),
             "profile": jnp.asarray(np.stack([r["profile"] for r in reqs]))}
    qparams = jax_ptq.quantize_params(params, _policy(jax_policy, True))
    with jax.disable_jit():
        scales = jax_ptq.calibrate_static_act_scales(
            lambda q, b: jax_onerec.forward(q, b, jcfg, unroll_layers=True),
            qparams, [batch])
    assert scales
    return scales


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_static_scales_artifact_token_identical_to_jax(setup, jax_scales,
                                                       tmp_path, paged):
    """An artifact written by the JAX package with its calibrated static
    scales: both engines attach them (the port's to its per-channel fp8
    leaves only, one value a layer) and give the same completions."""
    path = str(tmp_path / "quant_policy_static.json")
    jax_policy.save_policy_artifact(path, _policy(jax_policy, True),
                                    config="onerec-paged-test",
                                    act_scales=jax_scales)
    ref, out, engine = _serve(setup, paged, path, path)
    _assert_same(ref, out)
    attached = {p: leaf for p, leaf in leaves_with_path(engine.executor.params)
                if isinstance(leaf, QuantizedTensor)
                and leaf.act_scale is not None}
    # q and o projections (k is int8, v raw) and the logits head
    assert set(attached) == set(jax_scales) and len(attached) == 3
    for path_, leaf in attached.items():
        assert leaf.granularity == "per_channel"
        assert leaf.act_scale.shape == (*leaf.data.shape[:-2], 1, 1)
        assert float(leaf.act_scale.reshape(-1)[0]) == \
            np.float32(jax_scales[path_])


def test_bad_quant_policy_raises_as_jax_does(setup):
    cfg, jcfg, params, _ = setup
    with pytest.raises(ValueError, match="quant_policy must be"):
        JaxServingEngine(params, jcfg, JaxEngineConfig(batch_size=4,
                                                       quant_policy=123))
    with pytest.raises(ValueError, match="quant_policy must be"):
        ServingEngine(torch_params(params), cfg, EngineConfig(
            batch_size=4, quant_policy=123), device="cpu")


def test_launcher_deploys_a_policy_artifact(tmp_path, capsys):
    """``--quant-policy PATH`` on the port's launcher (CPU, reduced
    config): the artifact's policy is the executor's, and the launcher
    prints its ``[serve] quant policy:`` line."""
    from repro_torch.launch import serve
    path = str(tmp_path / "quant_policy.json")
    policy.save_policy_artifact(path, _policy(policy, True),
                                config="onerec-v2")
    outs, stats = serve.main(["--reduced", "--requests", "4", "--batch", "4",
                              "--kv-fp8", "--paged", "--quant-policy", path,
                              "--device", "cpu"])
    assert len(outs) == 4
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("[serve] quant policy:")]
    assert line == [f"[serve] quant policy: {path} (3 overrides, "
                    f"static_acts=True)"]


def test_jax_quantized_tensor_has_the_ported_fields():
    """The port's ``QuantizedTensor`` carries the JAX one's fields, in its
    order."""
    import dataclasses
    assert [f.name for f in dataclasses.fields(QuantizedTensor)] == \
        [f.name for f in dataclasses.fields(JaxQuantizedTensor)]
