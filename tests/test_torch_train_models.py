"""Gradient parity of the MoE LM (with the load-balance loss) and the EGNN
against the JAX package: ``jax.value_and_grad`` op by op against
``tree.value_and_grad`` on the CPU from the same weights, held by
``_torch_parity.check_grads`` (see ``test_torch_train.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (check_grads, egnn_batches, egnn_params,
                           jax_lm_cfg, jax_value_and_grad, torch_params)
from repro_torch import tree
from repro_torch.configs import registry


def test_moe_lm_gradients_with_aux_loss_match_jax():
    """qwen2-moe reduced with the load-balance loss on: the auxiliary
    term's value and its router gradient against the JAX package's."""
    from repro.models import transformer as jax_tfm
    from repro_torch.models import transformer as tfm
    cfg = dataclasses.replace(
        registry.get_arch("qwen2-moe-a2.7b").reduced_config(),
        aux_loss_weight=0.05)
    jcfg = jax_lm_cfg(cfg)
    raw = jax_tfm.init_transformer(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    theirs = jax_value_and_grad(jax_tfm.train_loss, raw,
                                {"tokens": jnp.asarray(tok),
                                 "labels": jnp.asarray(tok)}, jcfg)
    tb = {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)}
    tp = torch_params(raw)
    ours = tree.value_and_grad(tfm.train_loss, tp, tb, cfg)
    rel = check_grads(ours, theirs)
    # the auxiliary term is really in both: the loss without it differs
    plain = tfm.train_loss(tp, tb, dataclasses.replace(cfg,
                                                       aux_loss_weight=0.0))
    assert abs(float(plain) - float(ours[0])) > 1e-4
    routers = [p for p in rel if p.endswith("router/kernel")]
    assert routers


@pytest.mark.parametrize("level", ["node", "graph"])
def test_egnn_gradients_match_jax(level):
    from repro.models import gnn as jax_gnn
    from repro_torch.models import gnn
    cfg = registry.get_arch("egnn").reduced_config()
    batch = egnn_batches()[level]
    raw, _ = egnn_params("reduced", batch["feat"].shape[1])
    n_graphs = len(batch["labels"]) if level == "graph" else 0
    theirs = jax_value_and_grad(jax_gnn.train_loss, raw,
                                {k: jnp.asarray(v)
                                 for k, v in batch.items()}, cfg,
                                level=level, n_graphs=n_graphs)
    ours = tree.value_and_grad(gnn.train_loss, torch_params(raw),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg,
                               level=level, n_graphs=n_graphs)
    check_grads(ours, theirs)
