"""Victim selection shared by every engine and the cluster rebalancer.

Each engine used to carry its own copy of ``_preempt_victim``'s chooser
(newest running request loses — recompute-on-resume is cheapest for the
request with the least sunk prefill work).  The cluster-level
cross-replica preemption/migration tick needs the *same* ranking, so the
choice lives here as a small policy object the engines and the cluster
both consult.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.core.request import Request, class_rank


@dataclasses.dataclass(frozen=True)
class PreemptionPolicy:
    """Ranks running requests for eviction.

    ``order`` breaks ties *within* an SLO class:

    ``newest``        — latest arrival loses (least sunk work; default,
                        matches the engines' historical behaviour).
    ``least_progress``— fewest generated tokens loses (minimizes wasted
                        decode work when arrivals are bursty).

    With ``class_aware`` on (default) victims are ranked by SLO class
    FIRST — best_effort loses before batch loses before interactive —
    and ``order`` only decides among the worst class present.  In a
    single-class batch every rank ties, so the choice is identical to
    the class-blind ranking (golden parity).
    """

    order: str = "newest"
    class_aware: bool = True

    def choose(self, running: Sequence[Request]) -> Optional[Request]:
        if not running:
            return None
        rank = class_rank if self.class_aware else (lambda r: 0)
        if self.order == "newest":
            return max(running,
                       key=lambda r: (rank(r.slo_class), r.arrival))
        if self.order == "least_progress":
            return min(running,
                       key=lambda r: (-rank(r.slo_class),
                                      r.tokens_generated, -r.arrival))
        raise ValueError(f"unknown preemption order {self.order!r}")


DEFAULT_PREEMPTION = PreemptionPolicy()
