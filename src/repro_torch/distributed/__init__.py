"""The JAX package's ``repro/distributed``: the logical-axis sharding
rules, FP8 gradient compression with error feedback (and its reduction
over a mesh axis), elastic restore and the fault-tolerant runner."""

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
    constrain,
    current_mesh,
    logical_to_spec,
    param_sharding,
    use_mesh,
)
