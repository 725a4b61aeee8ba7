"""The MoE LMs of the zoo (qwen2-moe-a2.7b: shared experts and their
sigmoid gate, top-4; deepseek-moe-16b: a leading dense layer, a shared
expert, top-3) at their ``reduced_config()``, the port against the JAX
package on the CPU: the raw-weight forward, PTQ bit for bit (experts,
shared experts and the dense layer), and ``build_bundle``'s prefill and
decode steps greedy over a shared cache with ``use_attention_kernel`` off
and on.  The JAX side runs op by op; the bodies and their tolerances are
in ``_torch_parity.py``."""

import pytest

from _torch_parity import check_bundle_decode, check_ptq, check_raw_forward

ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_forward_matches_jax(arch):
    check_raw_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_is_bit_identical(arch):
    kinds = check_ptq(arch)
    assert {"attn/q_proj", "moe/experts", "moe/shared/gate",
            "moe/shared/down"} <= kinds
    if arch == "deepseek-moe-16b":
        assert "mlp/gate" in kinds          # the leading dense layer


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-softmax", "batch_attention"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_prefill_and_greedy_decode_match_jax(arch, use_kernel):
    check_bundle_decode(arch, use_kernel)
