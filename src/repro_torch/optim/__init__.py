"""AdamW, its cosine schedule and global-norm clipping (the JAX package's
``repro/optim``)."""

from repro_torch.optim.adamw import (  # noqa: F401
    OptimizerConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
)
