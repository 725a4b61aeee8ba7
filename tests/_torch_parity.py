"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
the small configs both packages run, and the params bridge JAX -> numpy ->
``repro_torch``."""

import dataclasses

import jax
import numpy as np

from repro.configs.base import OneRecConfig as JaxOneRecConfig
from repro.configs.base import TransformerConfig as JaxTransformerConfig
from repro_torch.configs.base import OneRecConfig, TransformerConfig
from repro_torch.weights import params_from_numpy


def to_numpy(tree):
    """JAX param pytree (nested dicts) -> nested dict of numpy arrays."""
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def torch_params(jax_params, device="cpu"):
    return params_from_numpy(to_numpy(jax_params), device)


def jax_cfg(cfg: OneRecConfig) -> JaxOneRecConfig:
    """The JAX package's config with the same fields as a port config."""
    tfm = JaxTransformerConfig(**dataclasses.asdict(cfg.transformer))
    fields = dataclasses.asdict(cfg)
    fields["transformer"] = tfm
    return JaxOneRecConfig(**fields)


def paged_test_cfg() -> OneRecConfig:
    """``tests/test_paged_kv.py::_cfg``: capacity lifted so MoE batch
    composition cannot perturb outputs."""
    return OneRecConfig(
        name="onerec-paged-test",
        history_len=8,
        transformer=TransformerConfig(
            name="onerec-paged-test-backbone",
            n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, moe=True, n_experts=4, top_k=2,
            d_expert=64, capacity_factor=64.0, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)


def aligned_cfg() -> OneRecConfig:
    """A small 128-aligned config: experts meet the block-size check, so
    the block-scaled fp8 grouped GEMM runs end to end (reduced_config's
    64-wide experts fall back to per-channel scales)."""
    return OneRecConfig(
        name="onerec-aligned-test",
        history_len=4,
        transformer=TransformerConfig(
            name="onerec-aligned-test-backbone",
            n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
            d_ff=256, vocab_size=256, moe=True, n_experts=3, top_k=2,
            d_expert=256, capacity_factor=1.5, ep_degree=4,
            max_seq_len=64, remat=False),
        serve_batch=4, beam_width=4)
