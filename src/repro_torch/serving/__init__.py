"""The serving substrate the port runs: the virtual-clock event loop, the
request metrics and the synthetic traces.  The reference's cluster,
gateway, HTTP and workload modules are not copied yet."""
# the engines import serving.metrics, which imports core: load core first,
# so that importing this package first works as importing core first does
import repro_torch.core  # noqa: F401
from repro_torch.serving.metrics import (  # noqa: F401
    RequestRecord, StreamMetrics, records_from_events, rejections_by_reason,
    summarize,
)
from repro_torch.serving.sim import EventLoop  # noqa: F401
from repro_torch.serving.traces import (  # noqa: F401
    TRACES, TraceSpec, generate_trace,
)
