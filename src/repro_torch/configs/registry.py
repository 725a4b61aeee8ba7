"""Architecture registry: ``get_arch(<id>)`` resolution.  The five LMs and
OneRec-V2 are ported; the recsys and GNN architectures of the JAX registry
raise ``NotImplementedError`` until ROADMAP.md queue N, item N7b ports
them."""

from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, deepseek_moe_16b,
                                 gemma3_1b, llama3_8b, onerec_v2,
                                 qwen2_moe_a27b)

ARCHS = {
    "llama3-8b": llama3_8b,
    "gemma3-1b": gemma3_1b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "onerec-v2": onerec_v2,
}

# the JAX registry's recsys and GNN architectures, not ported yet
NOT_PORTED = ("egnn", "two-tower-retrieval", "mind", "din", "dien")


def get_arch(name: str):
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"arch {name!r} (recsys / GNN) is not ported yet (ROADMAP.md "
            f"queue N, item N7b)")
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return list(ARCHS)
