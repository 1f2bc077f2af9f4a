"""RAPID-Serve core: scheduler/executor split serving engine + policies.

Serving API v2 (see README "Serving API v2"): ``Engine`` drives a pure
``Scheduler`` policy and an ``Executor`` pricing backend on the injected
event loop and emits a typed request-lifecycle event stream.
"""
from repro_torch.core.engines import (  # noqa: F401
    BaseEngine, DisaggEngine, Engine, HybridEngine, RapidEngine,
    drive, kv_pool_blocks, make_engine,
)
from repro_torch.core.events import (  # noqa: F401
    CancelledEvent, EventStream, FinishedEvent, PhaseEvent, RejectedEvent,
    TokenEvent,
)
from repro_torch.core.executor import (  # noqa: F401
    Executor, KernelExecutor, PerfModelExecutor, StepOutputs,
)
from repro_torch.core.preemption import (  # noqa: F401
    DEFAULT_PREEMPTION, PreemptionPolicy,
)
from repro_torch.core.request import Request, State  # noqa: F401
from repro_torch.core.resource_manager import (  # noqa: F401
    AdaptiveResourceManager, Allocation, DecodeProfile,
    build_decode_profile,
)
from repro_torch.core.scheduler import (  # noqa: F401
    SCHEDULERS, DisaggScheduler, HybridScheduler, RapidScheduler,
    SchedView, Scheduler, StepPlan, Wake, make_scheduler,
)
