"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU; without a
card they raise instead of quietly running the plain versions.  On the card
the float32 products stay full float32 (no TF32) and bf16 products reduce in
float32, so the router and ``lm_head`` logits that the JAX package computes
as float32 from bf16 operands are not rounded differently here.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) to "
                "run the plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work, so phase timings stay honest (the
    JAX executor's ``block_until_ready``).  A no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
