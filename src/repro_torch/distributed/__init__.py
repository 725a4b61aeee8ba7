"""The JAX package's ``repro/distributed``: the logical-axis sharding
rules, FP8 gradient compression with error feedback (and its reduction
over a mesh axis), elastic restore and the fault-tolerant runner; and
the half of distribution that XLA's SPMD partitioner does for the JAX
package: laying trees out as ``DTensor``s (``lay_out_tree``,
``cache_axes``: a per-slot cache split on its rows over ``(pod, data)``
and on its positions over ``model``, its ``pos`` whole over ``data``,
the paged heap replicated), moving their data with the c10d collectives
alone (``redistribute``, which ``constrain`` runs), and running plain
code on a rank's shards (``local_call``), and, for training, collectives
with a backward (``psum``, ``fan``, ``gather``, ``sum_scatter``; under
``TRAIN_RULES_SP`` ``unsplit``, which gathers the residual stream's
sequence shards where a layer takes its rows whole, and ``match``, which
slices a layer's output back) and weights stored sharded over ``data``
and gathered where they are used (``at_use``), but the embedding tables,
whose row shards are where their lookups run
(``layers.embedding.gather_rows`` and ``segment_sum`` over a mesh), and
the runner's checkpoints of a sharded state (gathered to rank 0 with c10d
calls, one global checkpoint in the JAX format, restored in place on
every rank).  ROADMAP.md queue N's distribution items, N9e.1-10, are all
ported: the port runs under a mesh every path the JAX package runs under
one (the flash-decoding combine over a ``kv_seq``-split cache is queue
B's B-P12, a ``perf_opt`` item)."""

from repro_torch.distributed.compression import (  # noqa: F401
    compressed_psum,
    ef_compress,
    ef_init,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FaultTolerantRunner,
    RunnerConfig,
)
from repro_torch.distributed.sharding import (  # noqa: F401
    AxisRules,
    INFER_RULES,
    TRAIN_RULES,
    TRAIN_RULES_SP,
    cache_axes,
    constrain,
    current_mesh,
    lay_out_tree,
    local_call,
    logical_to_spec,
    match,
    param_sharding,
    redistribute,
    unsplit,
    use_mesh,
)
