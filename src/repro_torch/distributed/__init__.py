"""The JAX package's ``repro/distributed``, as far as it is ported: FP8
gradient compression with error feedback and the fault-tolerant runner.
Sharding, ``compressed_psum`` and elastic restore wait for ROADMAP.md
queue N, item N9d."""

from repro_torch.distributed.compression import (  # noqa: F401
    ef_compress,
    ef_init,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    FaultTolerantRunner,
    RunnerConfig,
)
