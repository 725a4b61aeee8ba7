"""Checkpoints in the JAX package's format (``repro/checkpoint``)."""

from repro_torch.checkpoint.store import (  # noqa: F401
    AsyncCheckpointer,
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
