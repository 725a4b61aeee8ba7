"""Architecture registry: ``get_arch(<id>)`` resolution, the JAX
registry's eleven architectures."""

from __future__ import annotations

from repro_torch.configs import (deepseek_coder_33b, deepseek_moe_16b, dien,
                                 din, egnn, gemma3_1b, llama3_8b, mind,
                                 onerec_v2, qwen2_moe_a27b,
                                 two_tower_retrieval)

ARCHS = {
    "llama3-8b": llama3_8b,
    "gemma3-1b": gemma3_1b,
    "deepseek-coder-33b": deepseek_coder_33b,
    "qwen2-moe-a2.7b": qwen2_moe_a27b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "egnn": egnn,
    "two-tower-retrieval": two_tower_retrieval,
    "mind": mind,
    "din": din,
    "dien": dien,
    "onerec-v2": onerec_v2,
}


def get_arch(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs():
    return list(ARCHS)
