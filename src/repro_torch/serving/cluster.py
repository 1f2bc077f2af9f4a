"""Multi-replica cluster serving layer (DistServe-style fleet scale).

Runs N engine replicas — any mix of ``rapid`` / ``hybrid`` / ``disagg``
from ``core/engines.py`` — under ONE shared ``EventLoop`` (a single
virtual clock), behind a pluggable router:

  * ``round_robin``   — classic cycling over routable replicas.
  * ``least_loaded``  — fewest queued prefill tokens (the quantity that
    actually backs up TTFT), tie-broken by queued request count.
  * ``slo_aware``     — projects per-replica TTFT and ITL for the new
    request from the perfmodel (prefill cost of the queued + new prompt
    tokens; decode cost of the grown batch) and picks the replica with
    the lowest combined SLO-normalized score.

Routing happens at arrival time on the shared loop, so routers see each
replica's live load — exactly the information a fleet front-end has.

  * ``bucketed``      — BucketServe-style length bucketing for
    *heterogeneous* fleets: each replica advertises a prompt-length
    ceiling proportional to its chip count; requests go to the smallest
    compatible tier (tie-broken by capacity-normalized load), so short
    prompts never occupy the big replicas that long prompts need.

Optional SLO-driven scaling, two policies:

  * ``ScalePolicy`` — reactive: a periodic controller watches the
    recent TTFT-attainment window and adds replicas (up to
    ``max_replicas``) while the fleet is missing SLO.
  * ``ProjectionPolicy`` — projection-driven (paper §4.5.3 at cluster
    scale): every replica's live ``LoadSnapshot`` is priced by the
    perfmodel (``forecast_phase_times``) to forecast TTFT/ITL over the
    next horizon, the trailing arrival token rate sizes the capacity
    deficit, and the controller scales *before* violations happen —
    adding as many replicas as the deficit needs in one tick and, for
    split-pool (disagg) replicas, growing the prefill and decode chip
    pools *independently* (``Engine.resize_lane``).

Either way retired replicas stop receiving traffic but keep running
until their queues drain, so no request is lost.

Optional KV-aware admission (``AdmissionPolicy``, serving/admission.py):
arrivals whose projected KV footprint would overflow every replica's
pool are queued cluster-side (and eventually rejected) instead of being
placed and preempted mid-flight.

Optional cross-replica preemption/migration (``RebalancePolicy``): a
periodic tick picks victims on KV-overloaded replicas via the shared
``PreemptionPolicy`` (core/preemption.py), charges the KV-transfer cost
from perfmodel/costs.py, and re-enqueues them on the least-loaded
compatible replica — the placement is *revoked*, which the plain router
never did.  The tick is hysteretic (a replica must stay hot for
``hot_ticks`` consecutive checks before losing live KV) and cost/benefit
gated (a live-context move is skipped when the KV transfer plus the
destination's queue beats nothing — i.e. when ``kv_migration_seconds``
exceeds the projected queue relief).

Serving API v2: the cluster is an event-stream node.  Every replica
engine's typed stream (core/events.py) is forwarded into one fleet
stream (``cluster.subscribe`` / ``cluster.events``), cluster-side
admission rejections are emitted as ``RejectedEvent``s, and both the
autoscaler's TTFT-attainment window and ``run_fleet``'s summary consume
the stream (via ``serving.metrics.StreamMetrics``) instead of scraping
records after the fact.
"""
from __future__ import annotations

import bisect
import copy
import dataclasses
import math
from typing import (TYPE_CHECKING, Callable, Dict, List, Optional,
                    Sequence, Union)

import numpy as np

from repro_torch.config import ServeConfig
from repro_torch.core.events import EventStream, RejectedEvent
from repro_torch.core.preemption import PreemptionPolicy
from repro_torch.core.queues import IndexedQueue
from repro_torch.core.request import Request, State
from repro_torch.perfmodel import batch as B
from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel import interference as I
from repro_torch.perfmodel.hw import TPU_V5E, HardwareSpec
from repro_torch.serving.admission import AdmissionController, AdmissionPolicy
from repro_torch.serving.metrics import (RequestRecord, StreamMetrics,
                                         fleet_summarize, ttft_ceiling)
from repro_torch.serving.sim import EventLoop

if TYPE_CHECKING:   # deferred to break the serving <-> core import cycle
    from repro_torch.core.engines import BaseEngine, LoadSnapshot


@dataclasses.dataclass(frozen=True)
class ReplicaSpec:
    """One replica's recipe: engine mode plus optional per-replica
    overrides (heterogeneous fleets).  ``chips`` rescales the base
    ``ServeConfig`` (disagg splits follow); ``serve`` replaces it
    wholesale.  Split-pool replicas may instead size their pools
    independently with ``chips_p``/``chips_d`` (prefill / decode chip
    groups — both required together; ``chips`` is then derived)."""
    mode: str
    chips: Optional[int] = None
    serve: Optional[ServeConfig] = None
    chips_p: Optional[int] = None
    chips_d: Optional[int] = None


def parse_mix(mix: str) -> List[ReplicaSpec]:
    """Parse ``--mix`` syntax.  Three forms compose freely:

      * ``rapid,rapid,hybrid``      — one replica per entry, default chips
      * ``rapid:2x4,hybrid:1x8``    — ``mode:COUNTxCHIPS`` groups
      * ``disagg:1x8+24``           — ``mode:COUNTxP+D`` per-pool chip
        groups (8 prefill chips, 24 decode chips per replica)
    """
    specs: List[ReplicaSpec] = []
    for part in mix.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            mode, shape = part.split(":", 1)
            count_s, _, chips_s = shape.lower().partition("x")
            if not chips_s:
                raise ValueError(
                    f"bad --mix group {part!r}: want mode:COUNTxCHIPS "
                    "or mode:COUNTxP+D")
            if "+" in chips_s:
                p_s, _, d_s = chips_s.partition("+")
                spec = ReplicaSpec(mode.strip(), chips_p=int(p_s),
                                   chips_d=int(d_s))
            else:
                spec = ReplicaSpec(mode.strip(), chips=int(chips_s))
            specs.extend([spec] * int(count_s))
        else:
            specs.append(ReplicaSpec(part))
    if not specs:
        raise ValueError(f"empty --mix {mix!r}")
    return specs


@dataclasses.dataclass
class Replica:
    idx: int
    mode: str
    engine: BaseEngine
    serve: ServeConfig
    routable: bool = True
    # indexed so the rebalance tick's eviction is O(1), not an O(n)
    # list.remove over every request the replica ever served
    assigned: IndexedQueue = dataclasses.field(
        default_factory=IndexedQueue)

    @property
    def name(self) -> str:
        return f"{self.mode}-{self.idx}"

    def snapshot(self) -> LoadSnapshot:
        return self.engine.load_snapshot()


# ---------------------------------------------------------------------------
# Routers
# ---------------------------------------------------------------------------


class Router:
    """Picks a replica index for each arriving request."""

    name = "base"
    # perfmodel-backed routers score the whole candidate list through
    # perfmodel.batch in one call when this is set (the cluster copies
    # its own batch_pricing flag here); the scalar per-replica path is
    # kept as the reference/fallback and is bit-identical by the batch
    # layer's contract
    batch_pricing = True

    def choose(self, r: Request, replicas: List[Replica]) -> int:
        raise NotImplementedError

    def bind(self, fleet: List[Replica]) -> None:
        """Give the router a reference to the cluster's FULL replica
        list (the live list object, so later scale-ups are visible).
        ``choose`` may be handed a filtered subset (admission control,
        retired replicas); size-aware routers must compute fleet-relative
        quantities like bucket ceilings against the full fleet, not the
        subset."""

    def admits(self, length: int, rep: Replica,
               replicas: List[Replica]) -> bool:
        """Whether a sequence of ``length`` tokens may be (re)placed on
        ``rep`` — the rebalancer asks before migrating.  Size-agnostic
        routers accept anything."""
        return True


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self):
        self._next = 0

    def choose(self, r: Request, replicas: List[Replica]) -> int:
        i = self._next % len(replicas)
        self._next += 1
        return i


class LeastLoadedRouter(Router):
    """Balance queued prefill tokens — counts back up TTFT, tokens do."""

    name = "least_loaded"

    def choose(self, r: Request, replicas: List[Replica]) -> int:
        def key(i: int):
            s = replicas[i].snapshot()
            return (s.queued_prefill_tokens, s.queued_requests,
                    s.running_decode, i)
        return min(range(len(replicas)), key=key)


class SloAwareRouter(Router):
    """Project TTFT/ITL per replica from the perfmodel and route to the
    replica with the lowest SLO-normalized combined score (DistServe's
    placement insight applied at the router)."""

    name = "slo_aware"

    def __init__(self, cfg, serve: ServeConfig, hw: HardwareSpec = TPU_V5E):
        self.cfg = cfg
        self.serve = serve
        self.hw = hw

    def _score(self, r: Request, rep: Replica) -> float:
        s = rep.snapshot()
        # disagg replicas split their chips into prefill/decode pools
        # (engine exposes chips_p/chips_d); colocated engines use them
        # all — per-replica, so heterogeneous fleets score correctly
        chips_p = getattr(rep.engine, "chips_p", rep.serve.chips)
        chips_d = getattr(rep.engine, "chips_d", rep.serve.chips)
        # projected TTFT: every queued prompt token plus ours must be
        # prefilled before our first token can exist
        p_cost = C.prefill_cost(
            self.cfg, [s.queued_prefill_tokens + r.prompt_len], chips_p)
        proj_ttft = I.phase_time(p_cost, self.hw, chips_p)
        # projected ITL: the decode batch we would eventually join
        bs = s.running_decode + 1
        ctx = float(s.decode_ctx_tokens + r.prompt_len)
        d_cost = C.decode_cost(self.cfg, bs, ctx, chips_d)
        proj_itl = I.phase_time(d_cost, self.hw, chips_d)
        slo = self.serve.slo
        return (proj_ttft / ttft_ceiling(r.prompt_len, slo)
                + proj_itl / (slo.itl_ms / 1e3))

    def _scores(self, r: Request, replicas: List[Replica]) -> np.ndarray:
        """Vectorized ``_score`` over the whole candidate list: one
        batched prefill pricing and one batched decode pricing for the
        fleet instead of 2N scalar cost calls per arrival.  Loads come
        from ``Engine.router_load()`` — the three priced counters read
        directly, not the full 16-field snapshot the scalar reference
        path builds per replica (value-identical either way)."""
        loads = [rep.engine.router_load() for rep in replicas]
        chips_p = np.asarray(
            [getattr(rep.engine, "chips_p", rep.serve.chips)
             for rep in replicas], dtype=np.int64)
        chips_d = np.asarray(
            [getattr(rep.engine, "chips_d", rep.serve.chips)
             for rep in replicas], dtype=np.int64)
        pl = r.prompt_len
        pb = B.prefill_cost(
            self.cfg, [[tok + pl] for tok, _, _ in loads], chips_p)
        proj_ttft = B.phase_time(pb, self.hw, chips_p)
        db = B.decode_cost(
            self.cfg, [run + 1 for _, run, _ in loads],
            [float(ctx + pl) for _, _, ctx in loads], chips_d)
        proj_itl = B.phase_time(db, self.hw, chips_d)
        slo = self.serve.slo
        return (proj_ttft / ttft_ceiling(pl, slo)
                + proj_itl / (slo.itl_ms / 1e3))

    def choose(self, r: Request, replicas: List[Replica]) -> int:
        if not self.batch_pricing:
            return min(range(len(replicas)),
                       key=lambda i: (self._score(r, replicas[i]), i))
        # scores are bit-identical to the scalar path and np.argmin
        # returns the FIRST minimum, so the (score, i) tie-break holds
        return int(np.argmin(self._scores(r, replicas)))


class BucketedRouter(Router):
    """BucketServe-style length bucketing for heterogeneous fleets.

    Each replica advertises a prompt-length *bucket ceiling* proportional
    to its chip count (the largest tier always advertises the full
    ``max_seq_len``, so any servable prompt has a compatible replica).
    A request is routed among the replicas whose ceiling covers its
    prompt, preferring lower capacity-normalized load and, on ties, the
    smallest compatible tier — short prompts stay off the big replicas
    that long prompts need.
    """

    name = "bucketed"

    def __init__(self):
        self._fleet: Optional[List[Replica]] = None

    def bind(self, fleet: List[Replica]) -> None:
        self._fleet = fleet

    @staticmethod
    def ceiling(rep: Replica, replicas: Sequence[Replica]) -> int:
        cmax = max(p.serve.chips for p in replicas)
        return max(1, rep.serve.max_seq_len * rep.serve.chips // cmax)

    def _reference(self, replicas: List[Replica]) -> Sequence[Replica]:
        # ceilings are relative to the biggest replica in the FULL fleet;
        # computing them over a filtered subset (admission fit-list) would
        # silently inflate the small tiers' ceilings
        return self._fleet if self._fleet else replicas

    def admits(self, length: int, rep: Replica,
               replicas: List[Replica]) -> bool:
        return self.ceiling(rep, self._reference(replicas)) >= length

    def choose(self, r: Request, replicas: List[Replica]) -> int:
        ref = self._reference(replicas)
        ceils = [self.ceiling(rep, ref) for rep in replicas]
        compatible = [i for i in range(len(replicas))
                      if ceils[i] >= r.prompt_len]
        if not compatible:
            # oversized for every offered replica (whole-fleet oversize,
            # or admission filtered out the big tier): best-effort on the
            # biggest ceiling available rather than dropping the request
            return max(range(len(replicas)), key=lambda i: (ceils[i], -i))

        def key(i: int):
            s = replicas[i].snapshot()
            norm_load = s.queued_prefill_tokens / max(1,
                                                      replicas[i].serve.chips)
            return (norm_load, ceils[i], s.queued_requests, i)
        return min(compatible, key=key)


ROUTERS: Dict[str, Callable[..., Router]] = {
    "round_robin": lambda cfg, serve, hw: RoundRobinRouter(),
    "least_loaded": lambda cfg, serve, hw: LeastLoadedRouter(),
    "slo_aware": lambda cfg, serve, hw: SloAwareRouter(cfg, serve, hw),
    "bucketed": lambda cfg, serve, hw: BucketedRouter(),
}


def make_router(name: str, cfg, serve: ServeConfig,
                hw: HardwareSpec = TPU_V5E) -> Router:
    if name not in ROUTERS:
        raise KeyError(f"unknown router {name!r}; known: {sorted(ROUTERS)}")
    return ROUTERS[name](cfg, serve, hw)


# ---------------------------------------------------------------------------
# SLO-driven replica scaling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScalePolicy:
    """Reactive autoscaler: add a replica while the recent TTFT-attainment
    window misses ``target_attainment``; retire an idle surplus replica
    after ``idle_windows`` consecutive quiet checks."""
    min_replicas: int = 1
    max_replicas: int = 4
    check_interval_s: float = 5.0
    window_s: float = 10.0
    target_attainment: float = 0.9
    idle_windows: int = 2
    scale_up_mode: Optional[str] = None   # None => clone replica 0's mode


@dataclasses.dataclass(frozen=True)
class ProjectionPolicy:
    """Projection-driven autoscaler (paper §4.5.3 at cluster scale).

    Where ``ScalePolicy`` reacts to a *trailing* TTFT-attainment window —
    it cannot act until delayed requests have already finished late —
    this policy runs every replica's live ``LoadSnapshot`` through the
    perfmodel (``perfmodel.costs`` + ``perfmodel.interference.
    forecast_phase_times``) and scales on what the fleet is *about* to
    do over the next ``horizon_s``:

      * **TTFT forecast** — each replica's queued prefill backlog, plus
        its share of the trailing arrival token rate extended over the
        horizon, is priced as one prefill; a drain time beyond the
        length-dependent TTFT ceiling (x ``ttft_margin``) flags the
        replica prefill-pressed *before* any request misses SLO.
      * **ITL forecast** — the decode batch the replica will be running
        once queued work joins is priced against the ITL SLO
        (x ``itl_margin``).
      * **capacity forecast** — fleet-wide prefill token throughput vs
        the arrival token rate; the controller adds as many replicas as
        the projected deficit needs in ONE tick (the reactive policy
        drips one replica per window and chases the backlog).

    Split-pool (disagg) replicas scale their pools *independently* when
    ``pool_scaling`` is on: a prefill-pressed replica grows only its
    prefill chip group (``pool_chip_step`` chips, up to
    ``max_pool_chips``) — decode chips and every live decode-pool KV
    page are untouched — and vice versa.  Whole-replica adds remain the
    fallback once pools are maxed (or for colocated replicas).

    Scale-down reuses the reactive policy's conservative idle-retire
    rule; pools never shrink (live KV cannot be evicted out from under
    running requests).
    """
    min_replicas: int = 1
    max_replicas: int = 4
    check_interval_s: float = 5.0
    horizon_s: float = 5.0
    ttft_margin: float = 1.0       # scale when proj TTFT > margin*ceiling
    itl_margin: float = 1.0        # scale when proj ITL > margin*SLO
    idle_windows: int = 2
    scale_up_mode: Optional[str] = None   # None => clone replica 0's mode
    pool_scaling: bool = True      # disagg: grow P/D pools independently
    pool_chip_step: int = 4
    max_pool_chips: int = 64


@dataclasses.dataclass(frozen=True)
class RebalancePolicy:
    """Cross-replica preemption/migration: while a replica's KV pool sits
    above ``kv_high`` and another routable replica sits below ``kv_low``,
    move up to ``max_moves_per_tick`` victims per check.  Queued victims
    are re-routed for free; running victims are preempted via the shared
    ``PreemptionPolicy`` and charged the KV-transfer time of their live
    context (perfmodel ``kv_migration_seconds``) before re-enqueueing.

    Two guards keep the tick from thrashing:

    * **hysteresis** — a replica must report ``kv_utilization >=
      kv_high`` for ``hot_ticks`` *consecutive* checks before any live
      KV is evicted from it (queued victims, which hold no KV, may still
      be re-routed on the first hot tick);
    * **cost/benefit** — a live-context move is skipped when the KV
      transfer time plus the destination's projected prefill backlog
      exceeds the victim's projected wait on the source, i.e. when
      ``kv_migration_seconds`` exceeds the projected queue relief.
      ``cost_benefit=False`` restores the unguarded behaviour.
    """
    check_interval_s: float = 1.0
    kv_high: float = 0.85
    kv_low: float = 0.65
    max_moves_per_tick: int = 2
    max_migrations_per_request: int = 2
    link_gbps: Optional[float] = None   # None => serve.kv_transfer_gbps
    hot_ticks: int = 2                  # consecutive hot checks required
    cost_benefit: bool = True           # gate live-KV moves on net win


class Cluster:
    """N engine replicas sharing one EventLoop behind a Router."""

    def __init__(self, cfg, serve: ServeConfig,
                 modes: Sequence[Union[str, ReplicaSpec]],
                 router: str = "round_robin", hw: HardwareSpec = TPU_V5E,
                 scale: Optional[Union[ScalePolicy,
                                       ProjectionPolicy]] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 rebalance: Optional[RebalancePolicy] = None,
                 loop: Optional[EventLoop] = None,
                 session_affinity: bool = False,
                 preempt_policy: Optional[PreemptionPolicy] = None,
                 batch_pricing: bool = True):
        if not modes:
            raise ValueError("cluster needs at least one replica mode")
        self.cfg = cfg
        self.serve = serve
        self.hw = hw
        # fleet-vectorized pricing: projection/rebalance ticks and the
        # slo_aware router price all replicas through perfmodel.batch in
        # one call; False restores the scalar per-replica loops (same
        # numbers bit-for-bit — the batch layer is a pure vectorization)
        self.batch_pricing = batch_pricing
        self.loop = loop if loop is not None else EventLoop()
        # session -> replica idx holding the session's parked prefix KV;
        # affinity routing sends the next turn there so the prefix hits
        self.session_affinity = session_affinity
        self._session_home: Dict[str, int] = {}
        self._preempt_policy = preempt_policy
        self._base_specs: Dict[str, ReplicaSpec] = {}
        # fleet event stream: replica streams forward here, plus cluster-
        # side rejections; the autoscaler window and run_fleet consume it
        self.stream = EventStream()
        self.metrics = StreamMetrics()
        self.stream.subscribe(self.metrics)
        self.replicas: List[Replica] = []
        for spec in modes:
            self._add_replica(spec)
        self.router = make_router(router, cfg, serve, hw)
        self.router.batch_pricing = batch_pricing
        # the live list object: scale-ups appended later stay visible
        self.router.bind(self.replicas)
        self.scale = scale
        self.admission = AdmissionController(admission) \
            if admission is not None else None
        self.rebalance = rebalance
        self.rejected: List[Request] = []
        self._all: List[Request] = []
        # (t, action, n): action in {"up","down"} with n = routable count,
        # or {"pool_prefill","pool_decode"} with n = the lane's new chips
        self._scale_events: List[tuple] = []
        self._migrations: List[tuple] = []     # (t, src, dst, rid, had_kv)
        self._migration_counts: Dict[int, int] = {}
        self._idle_checks = 0
        self._hot_streak: Dict[int, int] = {}  # replica idx -> hot ticks
        self._pressed_streak = 0   # consecutive pressed projection ticks
        # arrival index for the projection policy's trailing token rate:
        # sorted arrival times + prefix token sums, rebuilt lazily at
        # the first tick after an enqueue (ticks are far sparser than
        # incremental enqueues can be)
        self._arr_t: List[float] = []
        self._arr_cum: List[int] = []
        self._arr_dirty = False

    # -- replica lifecycle ---------------------------------------------------
    def _add_replica(self, spec: Union[str, ReplicaSpec]) -> Replica:
        # local import: core.engines itself imports serving.metrics/sim
        from repro_torch.core.engines import make_engine
        if isinstance(spec, str):
            spec = ReplicaSpec(spec)
        serve = spec.serve if spec.serve is not None else self.serve
        if (spec.chips_p is None) != (spec.chips_d is None):
            raise ValueError(
                f"ReplicaSpec({spec.mode}): chips_p and chips_d must be "
                "given together")
        if spec.chips_p is not None:
            # independently-sized P/D pools (split-pool replicas)
            serve = dataclasses.replace(
                serve, chips=spec.chips_p + spec.chips_d,
                disagg_split=(spec.chips_p, spec.chips_d))
        elif spec.chips is not None and spec.chips != serve.chips:
            serve = dataclasses.replace(
                serve, chips=spec.chips,
                disagg_split=(max(1, spec.chips // 2),
                              max(1, spec.chips - spec.chips // 2)))
        if self._preempt_policy is not None:
            engine = make_engine(spec.mode, self.cfg, serve, self.hw,
                                 loop=self.loop,
                                 preempt_policy=self._preempt_policy)
        else:
            engine = make_engine(spec.mode, self.cfg, serve, self.hw,
                                 loop=self.loop)
        if spec.chips_p is not None and \
                getattr(engine.scheduler, "colocated", True):
            raise ValueError(
                f"ReplicaSpec({spec.mode}): chips_p/chips_d describe "
                "split-pool replicas; colocated modes share every chip "
                f"between both phases — use chips={serve.chips} instead")
        # scale-up clones a mode's ORIGINAL spec, not the bare mode
        # string, so autoscaled replicas keep per-pool chip shapes
        self._base_specs.setdefault(spec.mode, spec)
        rep = Replica(idx=len(self.replicas), mode=spec.mode,
                      engine=engine, serve=serve,
                      assigned=IndexedQueue(serve.page_size))
        rep.engine.subscribe(self.stream.emit)   # forward into fleet stream
        self.replicas.append(rep)
        return rep

    # -- streaming API -------------------------------------------------------
    def subscribe(self, fn, rid: Optional[int] = None):
        """Attach a consumer to the merged fleet event stream (all
        replicas plus cluster-side rejections)."""
        return self.stream.subscribe(fn, rid)

    def events(self):
        return self.stream.events()

    @property
    def routable(self) -> List[Replica]:
        return [rep for rep in self.replicas if rep.routable]

    @property
    def num_replicas(self) -> int:
        return len(self.replicas)

    # -- ingress ---------------------------------------------------------------
    def submit(self, r: Request) -> None:
        """Route an arriving request to a replica (called on the loop at
        the request's arrival time).  With admission control enabled the
        arrival may instead be queued cluster-side or rejected."""
        # scale-down can empty routable() between arrival and routing:
        # retired replicas still run, so fall back to the full fleet
        # rather than crashing the router on an empty list
        live = self.routable or self.replicas
        if self.admission is not None:
            verdict, fit, reason = self.admission.decide(r, live,
                                                         self.loop.now)
            if verdict == "reject":
                r.state = State.REJECTED
                r.reject_reason = reason
                self.rejected.append(r)
                self.stream.emit(RejectedEvent(
                    r.rid, self.loop.now, r.arrival, r.prompt_len,
                    reason, 0, 0, r.slo_class))
                return
            if verdict == "wait":
                self.loop.after(self.admission.policy.retry_s,
                                lambda r=r: self.submit(r))
                return
            live = fit
        rep = None
        if self.session_affinity and r.session_id is not None:
            # route the session's next turn to the replica parking its
            # prefix KV — but only if admission still allows it there
            home = self._session_home.get(r.session_id)
            if home is not None:
                rep = next((cand for cand in live if cand.idx == home),
                           None)
        if rep is None:
            rep = live[self.router.choose(r, live)]
        if r.session_id is not None:
            self._session_home[r.session_id] = rep.idx
        rep.assigned.append(r)
        rep.engine.submit(r)

    def enqueue(self, requests: Sequence[Request]) -> None:
        self._all.extend(requests)
        self._arr_dirty = True
        for r in requests:
            self.loop.at(r.arrival, lambda r=r: self.submit(r))

    def run(self, requests: Sequence[Request]):
        """Serve a trace to completion.  Returns (records, span_s)."""
        self.enqueue(requests)
        if self.scale is not None:
            self.loop.after(self.scale.check_interval_s, self._scale_tick)
        if self.rebalance is not None:
            self.loop.after(self.rebalance.check_interval_s,
                            self._rebalance_tick)
        self.loop.run()
        span = self.loop.now if self.loop.now > 0 else 1.0
        return [RequestRecord.from_request(r) for r in self._all], span

    def _outstanding(self) -> bool:
        # O(1): every request ends with exactly one terminal event
        # (FinishedEvent / RejectedEvent, incl. cluster-side admission
        # rejections), and StreamMetrics folds each into one record —
        # so "any request still in flight" is a count comparison, not a
        # walk over every request ever enqueued (the first version
        # rescanned self._all on every rebalance/scale tick)
        return len(self._all) > len(self.metrics.records)

    # -- per-replica views -----------------------------------------------------
    def per_replica_records(self) -> Dict[str, List[RequestRecord]]:
        return {rep.name: [RequestRecord.from_request(r)
                           for r in rep.assigned]
                for rep in self.replicas}

    def per_replica_counts(self) -> Dict[str, int]:
        return {rep.name: len(rep.assigned) for rep in self.replicas}

    # -- autoscaler ------------------------------------------------------------
    def _recent_attainment(self) -> Optional[float]:
        # stream consumer: the window comes from FinishedEvents folded by
        # StreamMetrics, not from walking every replica's request list
        window = [rec for rec in self.metrics.finished_since(
            self.loop.now - self.scale.window_s) if rec.ttft is not None]
        if not window:
            return None
        ok = sum(1 for rec in window
                 if rec.ttft <= ttft_ceiling(rec.prompt_len, self.serve.slo))
        return ok / len(window)

    def _scale_tick(self) -> None:
        outstanding = self._outstanding()
        if isinstance(self.scale, ProjectionPolicy):
            self._projection_tick()
        else:
            self._reactive_tick()
        if outstanding:
            self.loop.after(self.scale.check_interval_s, self._scale_tick)

    def _scale_up_one(self) -> None:
        mode = self.scale.scale_up_mode or self.replicas[0].mode
        # reactivate a retired replica before constructing a new one,
        # else oscillating load grows self.replicas without bound
        retired = [rep for rep in self.replicas if not rep.routable
                   and rep.mode == mode]
        if retired:
            retired[0].routable = True
        else:
            # clone the mode's original spec so per-pool chip shapes
            # (chips_p/chips_d) survive autoscaling
            self._add_replica(self._base_specs.get(mode,
                                                   ReplicaSpec(mode)))
        self._scale_events.append((self.loop.now, "up",
                                   len(self.routable)))

    def _retire_if_idle(self, busy: bool) -> None:
        if not busy and len(self.routable) > self.scale.min_replicas:
            self._idle_checks += 1
            if self._idle_checks >= self.scale.idle_windows:
                # retire the newest routable replica: it stops receiving
                # traffic (it is already drained — fleet was idle)
                self.routable[-1].routable = False
                self._scale_events.append((self.loop.now, "down",
                                           len(self.routable)))
                self._idle_checks = 0
        else:
            self._idle_checks = 0

    def _reactive_tick(self) -> None:
        att = self._recent_attainment()
        snaps = [rep.snapshot() for rep in self.replicas]
        # prefill_busy covers the window where a batch is in flight but
        # sits in no queue — a replica mid-prefill is NOT drained
        busy = any(s.queued_requests or s.running_decode
                   or s.prefill_busy or s.decode_busy for s in snaps)
        # backlog is the *leading* indicator (attainment only moves once
        # delayed requests finish): queued prefill work beyond one full
        # prefill step per routable replica means TTFTs are already sliding
        backlog = sum(s.queued_prefill_tokens for s in snaps) / \
            max(1, len(self.routable))
        pressed = (att is not None and att < self.scale.target_attainment) \
            or backlog > self.serve.prefill_max_tokens
        if pressed and len(self.routable) < self.scale.max_replicas:
            self._scale_up_one()
            self._idle_checks = 0
        else:
            self._retire_if_idle(busy)

    # -- projection-driven scaling (perfmodel forecasts) -----------------------
    def _arrival_token_rate(self, window_s: float) -> float:
        """Prompt tokens/s that ARRIVED over the trailing window — the
        observed inbound rate the projections extend over the horizon."""
        if self._arr_dirty:
            # only the projection tick reads the index; reactive / non-
            # scaling clusters never pay for the sort
            arr = sorted((r.arrival, r.prompt_len) for r in self._all)
            self._arr_t = [a for a, _ in arr]
            cum = 0
            self._arr_cum = []
            for _, pl in arr:
                cum += pl
                self._arr_cum.append(cum)
            self._arr_dirty = False
        now = self.loop.now
        window = min(window_s, now) if now > 0 else window_s
        if not self._arr_t or window <= 0:
            return 0.0
        hi = bisect.bisect_right(self._arr_t, now)
        lo = bisect.bisect_left(self._arr_t, now - window)
        if hi <= lo:
            return 0.0
        toks = self._arr_cum[hi - 1] - (self._arr_cum[lo - 1] if lo else 0)
        return toks / window

    def _prefill_token_rate(self, rep: Replica,
                            snap: "LoadSnapshot") -> float:
        """Sustained prefill throughput (tokens/s) of one replica at a
        representative saturating prompt batch.  Colocated replicas are
        priced WITH their current decode batch co-resident — prefill
        only ever gets its interference share of the chips there, and
        an idealized solo rate would overstate capacity and starve the
        scale-up decision."""
        chips_p = snap.chips_prefill or rep.serve.chips
        chips_d = snap.chips_decode or rep.serve.chips
        tokens = max(1, self.serve.prefill_max_tokens // 4)
        p_cost = C.prefill_cost(self.cfg, [tokens], chips_p)
        colocated = getattr(rep.engine.scheduler, "colocated", True)
        d_cost = None
        if colocated and snap.running_decode:
            d_cost = C.decode_cost(self.cfg, snap.running_decode,
                                   float(snap.decode_ctx_tokens), chips_d)
        t_p, _ = I.forecast_phase_times(p_cost, d_cost, self.hw, chips_p,
                                        chips_d, colocated=colocated)
        return tokens / max(t_p, 1e-9)

    def _project_replica(self, rep: Replica, s: "LoadSnapshot",
                         inbound_rate: float,
                         prefill_rate: float) -> tuple:
        """(projected-TTFT / ceiling, projected-ITL / SLO) for one
        replica: its queued backlog, plus the part of its arrival-rate
        share it cannot drain compounded over the horizon, priced by
        the perfmodel.

        Only the *surplus* over the replica's sustained prefill rate
        accumulates, so steady sub-capacity load projects an (almost)
        empty backlog and never reads as pressure.  The drain time is
        compared against the TIGHTEST arrival ceiling
        (``ttft_ceiling(1) == ttft_base_s``): the TTFT SLO is
        length-dependent and short prompts queued behind the backlog
        are the first to violate — a token-weighted mean ceiling would
        let a few long documents mask their misses."""
        pol = self.scale
        chips_p = s.chips_prefill or rep.serve.chips
        chips_d = s.chips_decode or rep.serve.chips
        surplus = max(0.0, inbound_rate - prefill_rate)
        backlog = s.queued_prefill_tokens + int(surplus * pol.horizon_s)
        p_cost = C.prefill_cost(self.cfg, [backlog], chips_p) \
            if backlog > 0 else None
        bs = s.running_decode + s.queued_requests
        ctx = float(s.decode_ctx_tokens + s.queued_prefill_tokens)
        d_cost = C.decode_cost(self.cfg, bs, ctx, chips_d) if bs else None
        t_p, t_d = I.forecast_phase_times(
            p_cost, d_cost, self.hw, chips_p, chips_d,
            colocated=getattr(rep.engine.scheduler, "colocated", True))
        ttft_ratio = t_p / ttft_ceiling(1, self.serve.slo)
        itl_ratio = t_d / (self.serve.slo.itl_ms / 1e3)
        return ttft_ratio, itl_ratio

    def _fleet_forecast(self, prefill_tokens, decode_bs, decode_ctx,
                        chips_p, chips_d, colocated):
        """THE batched forecast call site: price a fleet of replica load
        points through ``perfmodel.batch`` in one call and return the
        ``(t_prefill, t_decode)`` arrays.  Both projection passes (the
        sustained-rate pass and the backlog pass) route through here —
        this replaces the per-replica ``interference.
        forecast_phase_times`` loops of the scalar path.

        Entry ``i`` carries no prefill phase when
        ``prefill_tokens[i] <= 0`` and no decode phase when
        ``decode_bs[i] == 0`` (the scalar API's ``None`` costs)."""
        tp_p = np.asarray(chips_p, dtype=np.int64)
        tp_d = np.asarray(chips_d, dtype=np.int64)
        pb = B.prefill_cost(self.cfg, [[t] for t in prefill_tokens], tp_p)
        db = B.decode_cost(self.cfg, decode_bs, decode_ctx, tp_d)
        return B.forecast_phase_times(
            pb, db, self.hw, tp_p, tp_d,
            colocated=np.asarray(colocated, dtype=bool),
            p_mask=np.asarray([t > 0 for t in prefill_tokens]),
            d_mask=np.asarray([b > 0 for b in decode_bs]),
            f_decode=np.nan)

    def _projection_forecasts(self, live: List[Replica],
                              snaps: Dict[int, "LoadSnapshot"],
                              share: float) -> "tuple[dict, dict]":
        """Batched replacement for the per-replica
        ``_prefill_token_rate`` / ``_project_replica`` loops: two
        ``_fleet_forecast`` invocations per tick (the backlog pass
        depends on the rates through the arrival surplus), each pricing
        every live replica at once.  Returns the same ``rates`` and
        ``(ttft_ratio, itl_ratio)`` maps as the scalar loops,
        bit-for-bit."""
        pol = self.scale
        chips_p, chips_d, coloc = [], [], []
        for rep in live:
            s = snaps[rep.idx]
            chips_p.append(s.chips_prefill or rep.serve.chips)
            chips_d.append(s.chips_decode or rep.serve.chips)
            coloc.append(getattr(rep.engine.scheduler, "colocated", True))
        # sustained-rate pass: a saturating prompt batch, co-resident
        # with the current decode batch on colocated replicas only
        tokens = max(1, self.serve.prefill_max_tokens // 4)
        rate_bs = [snaps[rep.idx].running_decode if c else 0
                   for rep, c in zip(live, coloc)]
        rate_ctx = [float(snaps[rep.idx].decode_ctx_tokens)
                    for rep in live]
        t_rate, _ = self._fleet_forecast([tokens] * len(live), rate_bs,
                                         rate_ctx, chips_p, chips_d,
                                         coloc)
        rates = {rep.idx: tokens / max(float(t), 1e-9)
                 for rep, t in zip(live, t_rate)}
        # backlog pass: queued work plus the undrainable arrival surplus
        backlogs, bss, ctxs = [], [], []
        for rep in live:
            s = snaps[rep.idx]
            surplus = max(0.0, share - rates[rep.idx])
            backlogs.append(s.queued_prefill_tokens +
                            int(surplus * pol.horizon_s))
            bss.append(s.running_decode + s.queued_requests)
            ctxs.append(float(s.decode_ctx_tokens +
                              s.queued_prefill_tokens))
        t_p, t_d = self._fleet_forecast(backlogs, bss, ctxs,
                                        chips_p, chips_d, coloc)
        ceil = ttft_ceiling(1, self.serve.slo)
        itl = self.serve.slo.itl_ms / 1e3
        proj = {rep.idx: (float(tp) / ceil, float(td) / itl)
                for rep, tp, td in zip(live, t_p, t_d)}
        return rates, proj

    def _grow_pool(self, rep: Replica, lane: str) -> bool:
        """Independent P/D pool scaling: add ``pool_chip_step`` chips to
        ONE pool of a split-pool replica (the other pool's chips and
        live KV are untouched).  Returns False for colocated replicas or
        when the lane is already at ``max_pool_chips``."""
        pol = self.scale
        eng = rep.engine
        if getattr(eng.scheduler, "colocated", True):
            return False
        cur = eng.scheduler.lane_chips(eng.serve)[lane]
        new = min(cur + pol.pool_chip_step, pol.max_pool_chips)
        if new <= cur:
            return False
        eng.resize_lane(lane, new)
        rep.serve = eng.serve          # keep the Replica view in sync
        self._scale_events.append((self.loop.now, f"pool_{lane}", new))
        return True

    def _projection_tick(self) -> None:
        pol = self.scale
        snaps = {rep.idx: rep.snapshot() for rep in self.replicas}
        busy = any(s.queued_requests or s.running_decode
                   or s.prefill_busy or s.decode_busy
                   for s in snaps.values())
        live = self.routable or self.replicas
        inbound = self._arrival_token_rate(
            max(pol.horizon_s, pol.check_interval_s))
        share = inbound / max(1, len(live))
        # one perfmodel rate evaluation per replica per tick, shared by
        # the per-replica projections and the fleet capacity forecast;
        # batch_pricing collapses both per-replica loops into two
        # fleet-wide perfmodel.batch calls with identical numbers
        if self.batch_pricing:
            rates, proj = self._projection_forecasts(live, snaps, share)
        else:
            rates = {rep.idx: self._prefill_token_rate(rep,
                                                       snaps[rep.idx])
                     for rep in live}
            proj = {rep.idx: self._project_replica(
                rep, snaps[rep.idx], share, rates[rep.idx])
                for rep in live}
        pressed: List[tuple] = []      # (ratio, lane, replica)
        for rep in live:
            ttft_r, itl_r = proj[rep.idx]
            if ttft_r > pol.ttft_margin:
                pressed.append((ttft_r, "prefill", rep))
            if itl_r > pol.itl_margin:
                pressed.append((itl_r, "decode", rep))
        pool_acted = False
        if pol.pool_scaling:
            # grow the worst-pressed pool first; one pool action per tick
            # keeps growth observable between forecasts
            for _, lane, rep in sorted(pressed, key=lambda x: -x[0]):
                if self._grow_pool(rep, lane):
                    pool_acted = True
                    break
        self._pressed_streak = self._pressed_streak + 1 if pressed else 0
        added = 0
        if pressed and len(self.routable) < pol.max_replicas:
            # capacity forecast: add enough replicas IN THIS TICK to
            # cover the projected deficit — arrival rate plus draining
            # the standing queues within one horizon — instead of
            # dripping one per window while the backlog compounds.
            # Without a deficit, a whole replica is the FALLBACK for
            # pressure the pools could not absorb this tick, or that
            # persists into a second tick despite pool growth
            fleet_rate = sum(rates.values())
            per_rep = fleet_rate / max(1, len(live))
            queued = sum(snaps[rep.idx].queued_prefill_tokens
                         for rep in live)
            deficit = inbound + queued / max(pol.horizon_s, 1e-9) \
                - fleet_rate
            if deficit > 0:
                n_add = max(1, int(math.ceil(deficit /
                                             max(per_rep, 1e-9))))
            elif not pool_acted or self._pressed_streak >= 2:
                n_add = 1
            else:
                n_add = 0
            for _ in range(n_add):
                if len(self.routable) >= pol.max_replicas:
                    break
                self._scale_up_one()
                added += 1
        if pool_acted or added:
            self._idle_checks = 0
        else:
            self._retire_if_idle(busy)

    # -- cross-replica preemption / migration ----------------------------------
    def _migration_ok(self, victim: Request, tgt: Replica,
                      live: List[Replica]) -> bool:
        if self._migration_counts.get(victim.rid, 0) >= \
                self.rebalance.max_migrations_per_request:
            return False
        # a migrated request re-prefills its whole live context on the
        # destination, so bucket compatibility is against context_len
        return self.router.admits(victim.context_len, tgt, live)

    def _prefill_seconds(self, rep: Replica, tokens: int) -> float:
        """Projected time for ``rep`` to prefill ``tokens`` prompt tokens
        (its queued backlog plus a migrated victim's re-prefill)."""
        chips = getattr(rep.engine, "chips_p", rep.serve.chips)
        if tokens <= 0:
            return 0.0
        cost = C.prefill_cost(self.cfg, [tokens], chips)
        return I.phase_time(cost, self.hw, chips)

    def _benefit_ok(self, victim: Request, src: Replica, tgt: Replica,
                    snaps: Dict[int, "LoadSnapshot"]) -> bool:
        """Cost/benefit gate for live-KV moves: migrate only when the KV
        transfer plus the destination's projected queue beats waiting out
        the source's backlog — i.e. the transfer time must not exceed the
        projected queue relief."""
        if not self.rebalance.cost_benefit:
            return True
        gbps = self.rebalance.link_gbps or self.serve.kv_transfer_gbps
        xfer = C.kv_migration_seconds(self.cfg, victim.context_len, gbps)
        src_wait = self._prefill_seconds(
            src, snaps[src.idx].queued_prefill_tokens + victim.context_len)
        dst_wait = xfer + self._prefill_seconds(
            tgt, snaps[tgt.idx].queued_prefill_tokens + victim.context_len)
        return dst_wait < src_wait

    def _benefit_filter(self, victim: Request, src: Replica,
                        targets: List[Replica],
                        snaps: Dict[int, "LoadSnapshot"]
                        ) -> List[Replica]:
        """Batched cost/benefit gate: the source's projected wait and
        every candidate destination's price in ONE ``perfmodel.batch``
        call instead of a scalar cost pair per target."""
        if not self.rebalance.cost_benefit or not targets:
            return targets
        if not self.batch_pricing:
            return [rep for rep in targets
                    if self._benefit_ok(victim, src, rep, snaps)]
        gbps = self.rebalance.link_gbps or self.serve.kv_transfer_gbps
        xfer = C.kv_migration_seconds(self.cfg, victim.context_len, gbps)
        reps = [src] + targets
        tokens = [snaps[r.idx].queued_prefill_tokens + victim.context_len
                  for r in reps]
        chips = np.asarray([getattr(r.engine, "chips_p", r.serve.chips)
                            for r in reps], dtype=np.int64)
        waits = B.phase_time(
            B.prefill_cost(self.cfg, [[t] for t in tokens], chips),
            self.hw, chips)
        src_wait = float(waits[0])
        return [rep for rep, w in zip(targets, waits[1:])
                if xfer + float(w) < src_wait]

    def _rebalance_tick(self) -> None:
        pol = self.rebalance
        live = self.routable or self.replicas
        # hysteresis bookkeeping for EVERY replica, every tick: a replica
        # that cools down (or sits retired/solo) must lose its streak, or
        # it would migrate live KV on its first hot tick after rejoining
        snaps = {rep.idx: rep.snapshot() for rep in self.replicas}
        for rep in self.replicas:
            if snaps[rep.idx].kv_utilization >= pol.kv_high:
                self._hot_streak[rep.idx] = \
                    self._hot_streak.get(rep.idx, 0) + 1
            else:
                self._hot_streak[rep.idx] = 0
        if len(live) > 1:
            hot = sorted((rep for rep in live
                          if snaps[rep.idx].kv_utilization >= pol.kv_high),
                         key=lambda rep: -snaps[rep.idx].kv_utilization)
            moves = 0
            for src in hot:
                while moves < pol.max_moves_per_tick:
                    targets = [rep for rep in live if rep is not src
                               and snaps[rep.idx].kv_utilization
                               <= pol.kv_low]
                    cand = src.engine.migration_candidate()
                    if not targets or cand is None:
                        break
                    victim, has_kv = cand
                    if has_kv and \
                            self._hot_streak.get(src.idx, 0) < pol.hot_ticks:
                        # queued victims are free to move on the first hot
                        # tick; live KV waits out the hysteresis window
                        break
                    targets = [rep for rep in targets
                               if self._migration_ok(victim, rep, live)]
                    if has_kv:
                        targets = self._benefit_filter(victim, src,
                                                       targets, snaps)
                    if not targets:
                        break
                    tgt = min(targets, key=lambda rep: (
                        snaps[rep.idx].kv_utilization,
                        snaps[rep.idx].queued_prefill_tokens, rep.idx))
                    self._migrate(src, tgt, victim, has_kv)
                    moves += 1
                    # refresh the pair we touched; a single move rarely
                    # flips the rest of the fleet inside one tick
                    snaps[src.idx] = src.snapshot()
                    snaps[tgt.idx] = tgt.snapshot()
                    if snaps[src.idx].kv_utilization < pol.kv_high:
                        break
                if moves >= pol.max_moves_per_tick:
                    break
        if self._outstanding():
            self.loop.after(pol.check_interval_s, self._rebalance_tick)

    def _migrate(self, src: Replica, tgt: Replica, expected: Request,
                 expected_kv: bool) -> None:
        evicted = src.engine.evict_for_migration()
        assert evicted is not None and evicted[0] is expected, \
            "migration candidate changed under eviction"
        victim, had_kv = evicted
        del expected_kv
        if victim.session_id is not None:
            # the session's parked prefix (if any) stays on src where the
            # next turn will no longer land: invalidate it and re-home
            # the session — the victim re-prefills from scratch on tgt
            drop = getattr(src.engine.kv, "drop_session", None)
            if drop is not None:
                drop(victim.session_id)
            victim.cached_prefix_len = 0
            self._session_home[victim.session_id] = tgt.idx
        src.assigned.remove(victim)
        tgt.assigned.append(victim)
        self._migration_counts[victim.rid] = \
            self._migration_counts.get(victim.rid, 0) + 1
        self._migrations.append((self.loop.now, src.name, tgt.name,
                                 victim.rid, had_kv))
        if had_kv:
            gbps = self.rebalance.link_gbps or self.serve.kv_transfer_gbps
            xfer = C.kv_migration_seconds(self.cfg, victim.context_len,
                                          gbps)
            self.loop.after(xfer, lambda: tgt.engine.submit(victim))
        else:
            tgt.engine.submit(victim)

    @property
    def admission_stats(self) -> Dict[str, int]:
        return dict(self.admission.stats) if self.admission else {}


def run_fleet(cfg, serve: ServeConfig,
              modes: Sequence[Union[str, ReplicaSpec]], router: str,
              requests: Sequence[Request], hw: HardwareSpec = TPU_V5E,
              scale: Optional[Union[ScalePolicy, ProjectionPolicy]] = None,
              admission: Optional[AdmissionPolicy] = None,
              rebalance: Optional[RebalancePolicy] = None,
              session_affinity: bool = False,
              preempt_policy: Optional[PreemptionPolicy] = None,
              batch_pricing: bool = True):
    """Build a cluster, serve a trace, and return
    ``(fleet_summarize(...) dict, cluster)``.  Requests are deep-copied so
    the caller's trace can be replayed against other configurations."""
    cluster = Cluster(cfg, serve, modes, router=router, hw=hw, scale=scale,
                      admission=admission, rebalance=rebalance,
                      session_affinity=session_affinity,
                      preempt_policy=preempt_policy,
                      batch_pricing=batch_pricing)
    _, span = cluster.run([copy.deepcopy(r) for r in requests])
    # the fleet-wide summary is built from the cluster's event stream
    # (StreamMetrics), which already carries cluster-side rejections
    summary = fleet_summarize(cluster.per_replica_records(), serve.slo,
                              span, fleet_records=cluster.metrics.records,
                              loop_stats=cluster.loop.stats)
    f = summary["fleet"]
    f["migrations"] = len(cluster._migrations)
    if cluster.admission is not None:
        summary["admission"] = cluster.admission_stats
    return summary, cluster
