"""Adaptive Resource Manager (paper §4.5.3) + offline profiling.

Two regimes, switched at runtime on the decode batch size:

  * overallocation — both phases get 100% of compute (f=None); the
    hardware scheduler (TPU analogue: occupancy-demand sharing, see
    perfmodel/interference.py) fills gaps.  Used while the decode batch is
    small enough that inter-stream interference keeps ITL under the SLO.

  * distinct allocation — decode gets the *minimum* capacity fraction
    that meets the ITL SLO (from an offline profile, the CU-mask table
    analogue); prefill gets the rest.

The offline profile is built with the same perfmodel the simulator uses —
the moral equivalent of the paper's microbenchmark profiling pass, and it
is regenerated per (model, chips, SLO) triple.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional

from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel import interference as I
from repro_torch.perfmodel.hw import HardwareSpec

# capacity-fraction grid matching the paper's profiled CU-mask settings
F_GRID = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.75, 0.8, 0.85, 0.9]
BS_BUCKETS = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]


@dataclasses.dataclass(frozen=True)
class DecodeProfile:
    """bs bucket -> min f_d meeting the SLO; plus the Fig 7 crossover:
    ``overalloc_bs_limit`` is the largest profiled bs *below the first
    SLO miss* for which overallocation meets the SLO.  The scan stops
    raising the limit at the first miss — a non-monotone interference
    curve (a mid bs failing while a larger bs passes) must not re-open
    the overallocation regime above the crossover, or the runtime would
    overallocate at batch sizes bracketed by known SLO violations."""
    buckets: List[int]
    min_f: Dict[int, float]
    overalloc_bs_limit: int
    slo_itl_s: float


def build_decode_profile(cfg, hw: HardwareSpec, chips: int,
                         slo_itl_s: float, avg_ctx: int,
                         tp: Optional[int] = None) -> DecodeProfile:
    """Offline profiling pass: sweep (bs, f) and record SLO frontiers."""
    tp = tp or chips
    min_f: Dict[int, float] = {}
    overalloc_limit = 0
    crossover_hit = False
    # a representative co-resident prefill (saturating, compute-bound)
    p_cost = C.prefill_cost(cfg, [4096], tp)
    for bs in BS_BUCKETS:
        d_cost = C.decode_cost(cfg, bs, float(bs * avg_ctx), tp)
        # overallocation check (P100-D100 of Fig 7): the crossover is the
        # FIRST SLO miss — later passes on a non-monotone curve must not
        # raise the limit past a known-violating batch size
        r = I.overlapped_times(p_cost, d_cost, hw, chips)
        if r.t_decode <= slo_itl_s and not crossover_hit:
            overalloc_limit = bs
        elif r.t_decode > slo_itl_s:
            crossover_hit = True
        # distinct-allocation frontier
        for f in F_GRID:
            t_d = I.phase_time(d_cost, hw, chips, f=f,
                               mem_interference=I.MEM_INTERFERENCE_DECODE)
            if t_d <= slo_itl_s:
                min_f[bs] = f
                break
        else:
            min_f[bs] = F_GRID[-1]  # best effort: SLO unreachable at this bs
    return DecodeProfile(list(BS_BUCKETS), min_f, overalloc_limit, slo_itl_s)


_PROFILE_CACHE: Dict[tuple, DecodeProfile] = {}


def cached_decode_profile(cfg, hw: HardwareSpec, chips: int,
                          slo_itl_s: float, avg_ctx: int,
                          tp: Optional[int] = None) -> DecodeProfile:
    """Memoized ``build_decode_profile`` for runtime consumers.

    Every autoscaled rapid replica clone used to re-run the full offline
    sweep (``len(BS_BUCKETS) * len(F_GRID)`` perfmodel evaluations) for a
    (model, chips, SLO) triple the fleet already profiled; identical
    triples now share one read-only ``DecodeProfile``.  Tests that
    monkeypatch the interference model must call ``build_decode_profile``
    directly — this cache assumes the real perfmodel."""
    key = (cfg, hw, chips, slo_itl_s, avg_ctx, tp)
    prof = _PROFILE_CACHE.get(key)
    if prof is None:
        prof = _PROFILE_CACHE[key] = build_decode_profile(
            cfg, hw, chips, slo_itl_s, avg_ctx, tp=tp)
    return prof


@dataclasses.dataclass
class Allocation:
    f_decode: Optional[float]   # None => overallocation
    mode: str                   # solo | overalloc | distinct | distinct_clamped

    @property
    def f_prefill(self) -> float:
        return 1.0 if self.f_decode is None else 1.0 - self.f_decode


class AdaptiveResourceManager:
    """Runtime allocation policy driven by the offline profile.

    Regime selection is explicit in ``allocate`` (the branches are
    pinned by tests, not by evaluation order):

      * ``decode_bs <= 0``      -> ``solo``: no decode work exists, so
        prefill (or an idle engine) owns the chips regardless of
        ``prefill_active``;
      * ``not prefill_active``  -> ``solo``: decode runs alone at f=1;
      * ``bs <= crossover``     -> ``overalloc`` (both phases at 100%);
      * within profiled buckets -> ``distinct`` at the bucket's min f_d
        (between-bucket sizes round UP to the next bucket);
      * above the largest bucket -> ``distinct_clamped``: the profile
        has no data, so decode gets the conservative ``F_GRID[-1]``
        rather than silently reusing the last bucket's (smaller) f_d —
        the clamp is visible in ``Allocation.mode`` / ``history``.
    """

    def __init__(self, profile: DecodeProfile):
        self.profile = profile
        self.history: List[Allocation] = []

    def allocate(self, decode_bs: int, prefill_active: bool) -> Allocation:
        if decode_bs <= 0:
            # no decode work: prefill-only (or idle) — solo even when a
            # prefill is active, and regardless of the crossover value
            a = Allocation(None, "solo")
        elif not prefill_active:
            # decode alone owns the chips: no split needed
            a = Allocation(None, "solo")
        elif decode_bs <= self.profile.overalloc_bs_limit:
            a = Allocation(None, "overalloc")
        else:
            i = bisect.bisect_left(self.profile.buckets, decode_bs)
            if i >= len(self.profile.buckets):
                # beyond the profiled range: conservative extrapolation —
                # the largest profiled f_d would under-provision a bigger
                # batch, so give decode the top of the capacity grid and
                # record the clamp where history consumers can see it
                a = Allocation(F_GRID[-1], "distinct_clamped")
            else:
                a = Allocation(self.profile.min_f[self.profile.buckets[i]],
                               "distinct")
        self.history.append(a)
        return a
