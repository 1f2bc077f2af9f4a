"""Cluster-level KV-aware admission control.

The routers place every arrival unconditionally; under KV pressure
the engine then discovers the overflow *mid-flight* and preempts
(recompute-on-resume), which burns prefill work exactly when the fleet
can least afford it.  The admission controller moves that discovery to
arrival time: it projects the new request's KV footprint
(``kvcache.manager.kv_pages_for`` over prompt + expected decode tokens)
against each replica's live pool state (``LoadSnapshot.kv_utilization``
/ ``kv_free_blocks`` plus the pages its queued-but-unallocated requests
will claim) and

  * **admits** on the subset of replicas with headroom (the router picks
    among those — a redirect when its unconstrained choice was full),
  * **queues** the arrival cluster-side and retries when no replica has
    headroom right now, and
  * **rejects** cleanly when the prompt can never fit any replica's pool
    or the queueing deadline expires — instead of letting an engine hit
    ``OutOfBlocks`` (or preemption-thrash) mid-flight.

Split-pool (disagg) targets are checked against BOTH pools: the prompt's
transient *prefill-side* footprint must also fit the prefill pool's
projected occupancy (live pages plus the claims of every queued-but-
unstarted prompt, from ``LoadSnapshot.prefill_kv_*``).  Without this the
controller admits work whose transient prefill KV the replica cannot
hold — the request then sits in ``waiting_prefill`` starving the batch
former, exactly the §3.2.2 imbalance the decode-side check cannot see.
``prefill_pool_aware=False`` restores the decode-only projection.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.request import Request
from repro_torch.kvcache import kv_pages_for

# class-ordered headroom multipliers: lower-importance classes see a
# tighter effective pool, so under pressure best_effort is shed first,
# batch queues, and interactive admits up to the full headroom
DEFAULT_CLASS_HEADROOM: Mapping[str, float] = {
    "interactive": 1.0,
    "batch": 0.95,
    "best_effort": 0.80,
}


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs for the KV-aware admission controller.

    ``kv_headroom`` is the pool fraction the projected post-admit
    occupancy may not exceed (the margin absorbs decode growth of
    already-running requests).  ``projected_output_frac`` scales the
    request's ``max_new_tokens`` in the footprint projection — 1.0
    reserves for the worst case, smaller values statistically multiplex.

    ``prefill_pool_aware`` additionally projects the prompt's transient
    footprint against split-pool (disagg) replicas' *prefill* pools;
    ``prefill_headroom`` is that pool's occupancy ceiling (transient
    pages churn faster than decode KV, so it defaults looser).

    ``class_aware`` multiplies ``kv_headroom`` by the request's SLO
    class's entry in ``class_headroom`` (serving/workloads.py defines
    the classes).  Best-effort requests that miss their tighter ceiling
    are *shed* (rejected immediately, reason ``class_shed``) rather than
    queued — interactive requests are never shed and always see the full
    headroom.  Off by default: the class-blind controller treats every
    class identically (golden parity).
    """
    kv_headroom: float = 0.90
    projected_output_frac: float = 0.5
    retry_s: float = 0.25           # cluster-side queue poll interval
    max_wait_s: float = 60.0        # queued longer than this => reject
    prefill_pool_aware: bool = True
    prefill_headroom: float = 0.95
    class_aware: bool = False
    class_headroom: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_CLASS_HEADROOM))

    def headroom_for(self, slo_class: str) -> float:
        if not self.class_aware:
            return self.kv_headroom
        return self.kv_headroom * self.class_headroom.get(slo_class, 1.0)


class AdmissionController:
    """Stateful decision maker; one per cluster."""

    def __init__(self, policy: AdmissionPolicy):
        self.policy = policy
        self.stats: Dict[str, int] = collections.Counter()
        self._first_seen: Dict[int, float] = {}

    # -- projections --------------------------------------------------------
    def projected_pages(self, r: Request, page_size: int) -> int:
        horizon = r.prompt_len + int(
            round(self.policy.projected_output_frac * r.max_new_tokens))
        return kv_pages_for(horizon, page_size)

    def prefill_pool_fits(self, replica, r: Request, snap=None) -> bool:
        """Split-pool targets only: would the prompt's transient
        prefill-side pages keep the *prefill* pool's projected occupancy
        (live pages + every queued prompt's claim + this request) under
        ``prefill_headroom``?  Colocated replicas report a zero-sized
        prefill pool and pass vacuously."""
        if not self.policy.prefill_pool_aware:
            return True
        s = snap if snap is not None else replica.snapshot()
        if getattr(s, "prefill_kv_total_blocks", 0) <= 0:
            return True        # colocated engine: no transient pool
        pages = kv_pages_for(r.prompt_len, replica.serve.page_size)
        used = s.prefill_kv_total_blocks - s.prefill_kv_free_blocks
        return used + s.queued_prefill_kv_pages + pages <= \
            self.policy.prefill_headroom * s.prefill_kv_total_blocks

    def fits(self, replica, r: Request, snap=None) -> bool:
        """Would admitting ``r`` keep the replica's projected pool
        occupancy (live + queued claims + this request) under the
        request's class headroom?  Disagg replicas must fit BOTH the
        decode pool (prompt + projected output) and the transient
        prefill pool (prompt).  Parked session-prefix blocks are
        reclaimable on demand, so they count as free in the projection.
        """
        s = snap if snap is not None else replica.snapshot()
        if s.kv_total_blocks <= 0:
            return True        # engine without a paged pool: no signal
        pages = self.projected_pages(r, replica.serve.page_size)
        used = s.kv_total_blocks - s.kv_free_blocks - \
            getattr(s, "kv_session_blocks", 0)
        if used + s.queued_kv_pages + pages > \
                self.policy.headroom_for(r.slo_class) * s.kv_total_blocks:
            return False
        return self.prefill_pool_fits(replica, r, snap=s)

    def feasible(self, replica, r: Request, snap=None) -> bool:
        """Can the prompt *ever* fit this replica's pools?"""
        s = snap if snap is not None else replica.snapshot()
        if s.kv_total_blocks <= 0:
            return True
        pages = kv_pages_for(r.prompt_len, replica.serve.page_size)
        if pages > s.kv_total_blocks:
            return False
        if self.policy.prefill_pool_aware and \
                getattr(s, "prefill_kv_total_blocks", 0) > 0:
            return pages <= s.prefill_kv_total_blocks
        return True

    # -- the decision -------------------------------------------------------
    def decide(self, r: Request, replicas: Sequence, now: float
               ) -> Tuple[str, Optional[List], Optional[str]]:
        """Returns ``("admit", fit_replicas, None)``, ``("wait", None,
        None)`` or ``("reject", None, reason)`` with ``reason`` one of
        ``never_fits`` / ``kv_headroom`` / ``class_shed`` (the
        ``RejectedEvent.reason`` vocabulary)."""
        # one snapshot per replica per decision: snapshots walk whole
        # queues, and decide() re-runs every retry tick under overload
        snaps = [(rep, rep.snapshot()) for rep in replicas]
        feasible = [(rep, s) for rep, s in snaps
                    if self.feasible(rep, r, snap=s)]
        if not feasible:
            self.stats["rejected_infeasible"] += 1
            self._first_seen.pop(r.rid, None)
            return "reject", None, "never_fits"
        fit = [rep for rep, s in feasible if self.fits(rep, r, snap=s)]
        if fit:
            self.stats["admitted"] += 1
            if len(fit) < len(replicas):
                self.stats["redirected"] += 1
            self._first_seen.pop(r.rid, None)
            return "admit", fit, None
        if self.policy.class_aware and r.slo_class == "best_effort":
            # shed: queueing best-effort work behind its tight ceiling
            # only delays the reclaim the higher classes need
            self.stats["shed"] += 1
            self._first_seen.pop(r.rid, None)
            return "reject", None, "class_shed"
        first = self._first_seen.setdefault(r.rid, now)
        if now - first >= self.policy.max_wait_s:
            self.stats["rejected_timeout"] += 1
            self._first_seen.pop(r.rid, None)
            return "reject", None, "kv_headroom"
        self.stats["delayed"] += 1
        return "wait", None, None
