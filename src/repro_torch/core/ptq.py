"""Post-training quantization pass over the port's param tree.

``quantize_params`` replaces every policy-matched leaf with a
``QuantizedTensor`` of ``(fp8 data, f32 scale)``, exactly as
``repro.core.ptq.quantize_params`` does: block-matched leaves get
``128 x 128`` block scales, linear-matched leaves per-channel scales over
the contraction axis.  Payloads and scales are bit-identical to the JAX
package's.  The int8 scheme waits for a later slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree
from repro_torch.core import quant
from repro_torch.core.policy import PAPER_POLICY, QuantPolicy


def quantize_params(params: Dict[str, Any],
                    policy: QuantPolicy = PAPER_POLICY) -> Dict[str, Any]:
    if policy.fmt == "int8":
        raise NotImplementedError("int8 PTQ is not ported yet (ROADMAP.md "
                                  "queue N, item N5)")
    fmt = quant.E4M3 if policy.fmt == "e4m3" else quant.E5M2

    def _maybe_quantize(path: str, leaf):
        if not torch.is_tensor(leaf) or not leaf.is_floating_point():
            return leaf
        kind, _ = policy.match(path, leaf.ndim, tuple(leaf.shape))
        if kind is None:
            return leaf
        if kind == "int8":
            raise NotImplementedError(f"{path}: int8 is not ported yet "
                                      f"(ROADMAP.md queue N, item N5)")
        if kind == "block":
            q = quant.quantize_blockwise(leaf, block=policy.block, fmt=fmt)
        else:
            q = quant.quantize_per_channel(leaf, contract_axis=-2, fmt=fmt)
        q.tag = path
        return q

    return tree.map_with_path(_maybe_quantize, params)
