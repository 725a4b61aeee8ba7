"""The JAX package's ``repro/distributed``: the logical-axis sharding
rules, FP8 gradient compression with error feedback (and its reduction
over a mesh axis), elastic restore and the fault-tolerant runner; and
the half of distribution that XLA's SPMD partitioner does for the JAX
package, as far as ported: laying trees out as ``DTensor``s
(``lay_out_tree``, ``cache_axes``), moving their data with the c10d
collectives alone (``redistribute``, which ``constrain`` runs), and
running plain code on a rank's shards (``local_call``), and, for
training, collectives with a backward (``psum``, ``fan``, ``gather``,
``sum_scatter``) and weights stored sharded over ``data`` and gathered
where they are used (``at_use``), but the embedding tables, whose row
shards are where their lookups run (``layers.embedding.gather_rows`` and
``segment_sum`` over a mesh), and the runner's checkpoints of a sharded
state (gathered to rank 0 with c10d calls, one global checkpoint in the
JAX format, restored in place on every rank).  Tensor parallelism of the
transformer stack, the dry run, the sharded train step, the row-sharded
recsys tables, the EGNN's sharded graph steps, sharded checkpoints and
``ogb_products`` are ROADMAP.md queue N, items N9e.1-5, N9e.7 and N9e.10;
sequence parallelism and the paged pool under tensor parallelism are
N9e.6 and N9e.9 (the flash-decoding combine is queue B's B-P12)."""

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
    cache_axes,
    constrain,
    current_mesh,
    lay_out_tree,
    local_call,
    logical_to_spec,
    param_sharding,
    redistribute,
    use_mesh,
)
