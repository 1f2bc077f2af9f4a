from repro_torch.perfmodel import batch  # noqa: F401
from repro_torch.perfmodel.batch import StepCostBatch  # noqa: F401
from repro_torch.perfmodel.costs import (  # noqa: F401
    StepCost, cache_stats, decode_cost, kv_read_bytes,
    model_flops_per_token, prefill_cost, weight_bytes,
)
from repro_torch.perfmodel.hw import H100, TPU_V5E, HardwareSpec  # noqa: F401
from repro_torch.perfmodel.interference import (  # noqa: F401
    OverlapResult, forecast_phase_times, overlapped_times, phase_time,
)
