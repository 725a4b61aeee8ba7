"""Gradient parity of the four recsys architectures (one a family:
two-tower, MIND, DIN, DIEN; reduced) against the JAX package:
``jax.value_and_grad`` op by op against ``tree.value_and_grad`` on the CPU
from the same weights and a ``SyntheticInteractions`` batch, held by
``_torch_parity.check_grads`` (see ``test_torch_train.py``)."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from _torch_parity import (check_grads, jax_value_and_grad, recsys_batch,
                           recsys_cfg, recsys_params, torch_params)
from repro_torch import tree

RECSYS = ("two-tower-retrieval", "mind", "din", "dien")


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_gradients_match_jax(arch):
    from repro.configs.base import RecsysConfig as JaxRecsysConfig
    from repro.models import recsys as jax_recsys
    from repro_torch.models import recsys
    cfg = recsys_cfg(arch, "reduced")
    jcfg = JaxRecsysConfig(**dataclasses.asdict(cfg))
    raw, _, _, _ = recsys_params(arch, "reduced")
    batch, _ = recsys_batch(cfg)
    theirs = jax_value_and_grad(jax_recsys.train_loss, raw,
                                {k: jnp.asarray(v)
                                 for k, v in batch.items()}, jcfg)
    ours = tree.value_and_grad(recsys.train_loss, torch_params(raw),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()}, cfg)
    check_grads(ours, theirs)
