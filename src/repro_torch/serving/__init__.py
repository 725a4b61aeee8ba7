"""The port's serving subsystem: the engine's open-system lifecycle
(``engine.py``), the continuous scheduler and its policy seam
(``scheduler.py``), the device phases over the paged or contiguous KV pool
(``executor.py``) and the host-side pools and prefix store
(``kv_cache.py``), as in ``repro/serving``."""

from repro_torch.serving.engine import (AdmissionFull,  # noqa: F401
                                        EngineConfig, RequestCancelled,
                                        RequestHandle, ServingEngine,
                                        run_open_loop)
from repro_torch.serving.executor import PhaseExecutor  # noqa: F401
from repro_torch.serving.kv_cache import (PrefixEntry,  # noqa: F401
                                          PrefixStore, SlotPool, SlotState,
                                          prefix_hash_chain)
from repro_torch.serving.requests import (build_requests,  # noqa: F401
                                          make_request, requests_from_arrays)
from repro_torch.serving.scheduler import (Completion,  # noqa: F401
                                           ContinuousScheduler, Request,
                                           SchedulingPolicy)
