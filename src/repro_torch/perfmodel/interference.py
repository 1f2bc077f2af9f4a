"""P/D co-residency timing model — the TPU analogue of CU masking.

On TPU there is no spatial CU partition; the RAPID adaptation exposes the
same control variable f_d (decode's share of issue capacity) through
(a) grid-slot partitioning in the unified Pallas step and (b) the
token-budget knob (DESIGN.md §2).  This module turns (StepCost, f) pairs
into durations, modeling:

  * compute scaling    — a phase holding fraction f of issue capacity runs
    its compute-bound portion at f * peak (paper Fig 3a: prefill perf is
    proportional to CUs).
  * memory insensitivity — the bandwidth-bound portion is unaffected by f
    until f is tiny (Fig 3b: decode holds perf down to 40-50% CUs).
  * memory-subsystem interference (§3.4) — co-resident phases degrade each
    other's HBM term by ~2% (prefill) and 2-5% (decode); no partitioning
    mechanism exists for it, matching the paper.
  * overallocation (Fig 6c / Fig 7) — both phases claim f=1 and share by
    occupancy demand: each phase's share is proportional to its standalone
    compute-utilization, so a small decode batch (low demand u) coexists
    almost freely, while a large one degrades toward a 1/2 split — this
    reproduces Fig 7's P100-D100 curve crossing the SLO as batch grows,
    with no fitted constants beyond the §3.4 interference percentages.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np

from repro_torch.perfmodel import batch as _batch
# §3.4 memory-subsystem interference constants live in the formula
# layer (perfmodel.batch); re-exported here under their historical names
from repro_torch.perfmodel.batch import (MEM_INTERFERENCE_DECODE,
                                         MEM_INTERFERENCE_PREFILL)
from repro_torch.perfmodel.costs import StepCost
from repro_torch.perfmodel.hw import HardwareSpec


def phase_time(cost: StepCost, hw: HardwareSpec, chips: int,
               f: float = 1.0, mem_interference: float = 0.0,
               bw_share: float = 1.0) -> float:
    """Duration of one phase step given issue-capacity fraction f."""
    if cost.flops == 0 and cost.hbm_bytes == 0:
        return 0.0
    t_compute = cost.flops / (chips * hw.peak_flops * max(f, 1e-3))
    t_mem = cost.hbm_bytes * (1.0 + mem_interference) / \
        (chips * hw.hbm_bw * bw_share)
    t_coll = cost.coll_bytes / hw.ici_bw
    return max(t_compute, t_mem) + t_coll + hw.launch_overhead_s


def compute_utilization(cost: StepCost, hw: HardwareSpec,
                        chips: int) -> float:
    """Standalone occupancy demand u in [0, 1]: fraction of issue capacity
    the phase can actually use while bandwidth-bound."""
    t_c = cost.flops / (chips * hw.peak_flops)
    t_m = cost.hbm_bytes / (chips * hw.hbm_bw)
    t_coll = cost.coll_bytes / hw.ici_bw
    denom = max(t_m, t_c) + t_coll
    if denom <= 0:
        return 0.0
    return min(1.0, t_c / denom)


@dataclasses.dataclass(frozen=True)
class OverlapResult:
    t_prefill: float
    t_decode: float
    f_prefill: float
    f_decode: float
    mode: str            # "overalloc" | "distinct" | "solo"


def overlapped_times(p_cost: Optional[StepCost], d_cost: Optional[StepCost],
                     hw: HardwareSpec, chips: int, *,
                     f_decode: Optional[float] = None) -> OverlapResult:
    """Durations for co-resident prefill/decode steps.

    f_decode=None -> overallocation (both claim the whole chip, shares
    set by occupancy demand).  Otherwise a distinct split: decode gets
    f_decode, prefill gets 1 - f_decode (the profiled CU-mask analogue).
    """
    if d_cost is None and p_cost is None:
        return OverlapResult(0.0, 0.0, 0.0, 0.0, "solo")
    if d_cost is None:
        return OverlapResult(
            phase_time(p_cost, hw, chips), 0.0, 1.0, 0.0, "solo")
    if p_cost is None:
        return OverlapResult(
            0.0, phase_time(d_cost, hw, chips), 0.0, 1.0, "solo")

    if f_decode is None:
        # Overallocation: issue-capacity shares proportional to demand.
        u_d = compute_utilization(d_cost, hw, chips)
        u_p = compute_utilization(p_cost, hw, chips)
        share_d = u_d / max(u_d + u_p, 1e-9)
        share_p = 1.0 - share_d
        t_d = phase_time(d_cost, hw, chips, f=max(share_d, 1e-3),
                         mem_interference=MEM_INTERFERENCE_DECODE)
        t_p = phase_time(p_cost, hw, chips, f=max(share_p, 1e-3),
                         mem_interference=MEM_INTERFERENCE_PREFILL)
        return OverlapResult(t_p, t_d, share_p, share_d, "overalloc")

    f_d = min(max(f_decode, 0.05), 0.95)
    f_p = 1.0 - f_d
    t_d = phase_time(d_cost, hw, chips, f=f_d,
                     mem_interference=MEM_INTERFERENCE_DECODE)
    t_p = phase_time(p_cost, hw, chips, f=f_p,
                     mem_interference=MEM_INTERFERENCE_PREFILL)
    return OverlapResult(t_p, t_d, f_p, f_d, "distinct")


@functools.lru_cache(maxsize=65536)
def forecast_phase_times(p_cost: Optional[StepCost],
                         d_cost: Optional[StepCost], hw: HardwareSpec,
                         chips_p: int, chips_d: int, *,
                         colocated: bool = True,
                         f_decode: Optional[float] = None
                         ) -> "tuple[float, float]":
    """Projected ``(t_prefill, t_decode)`` for a replica's current load —
    the primitive behind projection-driven cluster decisions (autoscaler,
    admission).  Colocated replicas couple the two phases through
    ``overlapped_times`` on the shared chip group; split-pool (disagg)
    replicas run each phase at its own pool's ``phase_time`` with no
    cross-phase interference (§3.2: the pools share nothing but the
    transfer link).

    Memoized: the projection autoscaler and admission controller call
    this with the same (cost, chips) operating points tick after tick
    whenever the fleet state is unchanged; caching returns the identical
    tuple without re-running the overlap model.

    N=1 view of ``batch.forecast_phase_times`` — the fleet tick prices
    all replicas through the batched overlap model in one call, and this
    view guarantees the scalar path computes the exact same formula."""
    pb, _ = _batch.pack_costs((p_cost,))
    db, _ = _batch.pack_costs((d_cost,))
    t_p, t_d = _batch.forecast_phase_times(
        pb, db, hw, chips_p, chips_d, colocated=colocated,
        p_mask=p_cost is not None, d_mask=d_cost is not None,
        f_decode=np.nan if f_decode is None else f_decode)
    return float(t_p[0]), float(t_d[0])
