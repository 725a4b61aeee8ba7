"""Weight bridge: the JAX package's raw params (or its whole train state),
handed over as a nested dict of numpy arrays, become the port's tree with
the same paths, dtypes and values.  Quantization then runs in the port
(``core.ptq``), so the parity tests check PTQ itself bit for bit.  A
checkpoint (``checkpoint/store.py``, the JAX format) is the other bridge,
in both directions."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

# numpy has no bf16/fp8 dtypes of its own; ml_dtypes' arrays carry these
# names and cross as raw bytes
_VIEW_DTYPES = {"bfloat16": (np.int16, torch.bfloat16),
                "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
                "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    if a.dtype.name in _VIEW_DTYPES:
        raw, dtype = _VIEW_DTYPES[a.dtype.name]
        return torch.from_numpy(a.view(raw)).view(dtype).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}


def train_state_from_numpy(state: Dict[str, Any], device=None
                           ) -> Dict[str, Any]:
    """The JAX package's train state (``repro/launch/train.py``: ``{"params",
    "opt": {"mu", "nu", "step"}, ["ef"]}`` as nested numpy arrays) -> the
    port's (``launch/train.py``): the same paths, dtypes and values, the
    step a 0-d int32 tensor."""
    if not {"params", "opt"} <= set(state) <= {"params", "opt", "ef"} \
            or set(state["opt"]) != {"mu", "nu", "step"}:
        raise ValueError(f"not a train state: keys {sorted(state)}")
    step = np.asarray(state["opt"]["step"])
    if step.shape != () or step.dtype != np.int32:
        raise ValueError(f"opt/step is {step.dtype}{step.shape}, not a 0-d "
                         f"int32")
    return params_from_numpy(state, device)
