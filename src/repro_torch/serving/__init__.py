"""The serving substrate the port runs: the virtual-clock event loop and
the request metrics.  The reference's cluster, gateway, HTTP, trace and
workload modules are not copied yet."""
from repro_torch.serving.metrics import (  # noqa: F401
    RequestRecord, StreamMetrics, records_from_events, rejections_by_reason,
    summarize,
)
from repro_torch.serving.sim import EventLoop  # noqa: F401
