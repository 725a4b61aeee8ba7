"""The JAX package's ``repro/distributed``: the logical-axis sharding
rules, FP8 gradient compression with error feedback (and its reduction
over a mesh axis), elastic restore and the fault-tolerant runner; and
the half of distribution that XLA's SPMD partitioner does for the JAX
package, as far as ported: laying trees out as ``DTensor``s
(``lay_out_tree``, ``cache_axes``), moving their data with the c10d
collectives alone (``redistribute``, which ``constrain`` runs), and
running plain code on a rank's shards (``local_call``).  Tensor
parallelism of the transformer stack and the dry run are ROADMAP.md
queue N, items N9e.1-2; FSDP training, sharded checkpoints, row-sharded
recsys tables, sequence parallelism, ``ogb_products``, a flash-decoding
combine over a sequence-sharded cache and the paged pool under tensor
parallelism are N9e.3-9."""

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
