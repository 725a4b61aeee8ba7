"""The dense LMs of the zoo (llama3-8b, gemma3-1b, deepseek-coder-33b) at
their ``reduced_config()``, the port against the JAX package on the CPU:
the raw-weight forward, PTQ bit for bit, and ``build_bundle``'s prefill
and decode steps greedy over a shared cache with ``use_attention_kernel``
off and on (gemma3's window rings wrap in the prompt and every decode
step: window 8, prompt 16).  The JAX side runs op by op; the bodies and
their tolerances are in ``_torch_parity.py``."""

import pytest

from _torch_parity import check_bundle_decode, check_ptq, check_raw_forward

ARCHS = ["llama3-8b", "gemma3-1b", "deepseek-coder-33b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_raw_forward_matches_jax(arch):
    check_raw_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_ptq_is_bit_identical(arch):
    kinds = check_ptq(arch)
    assert {"attn/q_proj", "mlp/gate", "mlp/down"} <= kinds


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain-softmax", "batch_attention"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_prefill_and_greedy_decode_match_jax(arch, use_kernel):
    check_bundle_decode(arch, use_kernel)
