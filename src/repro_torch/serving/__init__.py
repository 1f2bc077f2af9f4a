"""The serving substrate the port runs: the virtual-clock event loop and
its real-time counterpart, the cluster layer (replicas, routers, fleets,
admission, autoscaling), fault injection, multi-class workloads, the
online gateway with its workers and HTTP server, the request metrics and
the synthetic traces.  Copies of the reference's ``serving`` modules; the
gateway takes how a worker's engine is built as an argument, so a worker
can run a ``KernelExecutor`` on the card (``launch/serve.py --serve
http``)."""
# the engines import serving.metrics, which imports core: load core first,
# so that importing this package first works as importing core first does
import repro_torch.core  # noqa: F401
from repro_torch.serving.admission import (  # noqa: F401
    AdmissionController, AdmissionPolicy,
)
from repro_torch.serving.clock import RealTimeClock  # noqa: F401
from repro_torch.serving.cluster import (  # noqa: F401
    ROUTERS, BucketedRouter, Cluster, ProjectionPolicy, RebalancePolicy,
    Replica, ReplicaSpec, ScalePolicy, make_router, parse_mix, run_fleet,
)
from repro_torch.serving.faults import (  # noqa: F401
    Fault, FaultInjector, FaultPlan, RetryPolicy, line_corruptor,
)
from repro_torch.serving.gateway import (  # noqa: F401
    Gateway, GatewayPolicy, RequestChannel, WorkerRegistry,
)
from repro_torch.serving.http import (  # noqa: F401
    GatewayHTTPServer, run_http,
)
from repro_torch.serving.metrics import (  # noqa: F401
    RequestRecord, StreamMetrics, fleet_summarize, per_class_summaries,
    records_from_events, rejections_by_reason, summarize,
)
from repro_torch.serving.sim import EventLoop  # noqa: F401
from repro_torch.serving.traces import (  # noqa: F401
    TRACES, TraceSpec, generate_trace,
)
from repro_torch.serving.worker import ReplicaWorker, WorkerState  # noqa: F401
from repro_torch.serving.workloads import (  # noqa: F401
    DEFAULT_MIX, WORKLOAD_CLASSES, WorkloadClass, class_slos,
    diurnal_rate, flash_crowd_rate, generate_multiclass_trace,
    nhpp_arrivals,
)
