"""Generic serving engine: one execution substrate, pluggable policies.

Serving API v2 (this module + core/scheduler.py + core/executor.py +
core/events.py) splits the historical monolithic engines into

  * a ``Scheduler`` — pure policy: consulted at every wake point with a
    read-only ``SchedView``, returns a ``StepPlan`` (admissions,
    rejections, lane launches, timed retries);
  * an ``Executor`` — prices the launched steps (default
    ``PerfModelExecutor``; a real-kernel executor slots in behind the
    same interface);
  * this ``Engine`` — the substrate: queues, decode-owned paged-KV
    pools, the event loop, preemption, KV transfers, and a typed
    request-lifecycle **event stream** (``TokenEvent`` / ``PhaseEvent``
    / ``FinishedEvent`` / ``RejectedEvent``) consumed via
    ``engine.subscribe()`` / ``engine.events()``.

``RapidEngine`` / ``HybridEngine`` / ``DisaggEngine`` are thin
constructors binding the matching scheduler; ``make_engine`` keeps the
historical entry point.  Callers submit work (``enqueue``/``submit``)
and consume the stream (see README "Serving API v2"); the free function
``drive(engine, requests)`` is the blocking convenience for standalone
engines — the old ``Engine.run()`` shim is gone.

Parity: the scheduler/executor engines reproduce the pre-split engines'
per-request TTFT/ITL/finish metrics exactly (tests/test_parity.py golden
traces; tests/test_cluster.py single-replica equivalence).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.config import ServeConfig
from repro_torch.core.events import (EventStream, FinishedEvent, PhaseEvent,
                                     RejectedEvent, TokenEvent)
from repro_torch.core.executor import Executor, PerfModelExecutor
from repro_torch.core.preemption import DEFAULT_PREEMPTION, PreemptionPolicy
from repro_torch.core.queues import IndexedQueue
from repro_torch.core.request import Request, State
from repro_torch.core.scheduler import (DisaggScheduler, HybridScheduler,
                                        LaneState, RapidScheduler, SchedView,
                                        Scheduler, StepPlan, Wake,
                                        kv_pool_blocks as kv_pool_blocks,
                                        make_scheduler)
from repro_torch.kvcache import KVCacheManager, OutOfBlocks, kv_pages_for
from repro_torch.perfmodel.hw import TPU_V5E, HardwareSpec
from repro_torch.serving.metrics import RequestRecord
from repro_torch.serving.sim import EventLoop


@dataclasses.dataclass
class UtilSample:
    t: float
    kv_util: float
    busy: bool


@dataclasses.dataclass(frozen=True)
class LoadSnapshot:
    """Instantaneous engine load, consumed by cluster routers.

    ``queued_prefill_tokens`` counts prompt tokens that still need prefill
    compute (including the un-chunked remainder on hybrid engines) — the
    quantity a least-loaded router balances.  ``decode_ctx_tokens`` is the
    total live context of the running decode batch, which the SLO-aware
    router feeds to the decode cost model.

    ``kv_free_blocks`` / ``kv_total_blocks`` describe the decode-side
    paged-KV pool, and ``queued_kv_pages`` the pages that queued-but-
    unallocated requests will claim when admitted — together they let the
    cluster admission controller project whether a new request fits
    without the engine ever hitting ``OutOfBlocks`` mid-flight.

    Split-pool (disagg) engines additionally expose the transient
    *prefill-side* pool (``prefill_kv_free_blocks`` /
    ``prefill_kv_total_blocks``, with ``queued_prefill_kv_pages`` the
    claims of queued-but-unstarted prompts against it) and their per-pool
    chip counts — the signals projection-driven admission and the
    per-pool autoscaler consume.  Colocated engines report zero pool
    fields and ``chips_prefill == chips_decode == serve.chips``.
    """
    queued_requests: int
    queued_prefill_tokens: int
    running_decode: int
    decode_ctx_tokens: int
    kv_utilization: float
    prefill_busy: bool
    decode_busy: bool
    kv_free_blocks: int = 0
    kv_total_blocks: int = 0
    queued_kv_pages: int = 0
    # split-pool (disagg) per-pool occupancy; zeros on colocated engines
    prefill_kv_free_blocks: int = 0
    prefill_kv_total_blocks: int = 0
    queued_prefill_kv_pages: int = 0
    chips_prefill: int = 0
    chips_decode: int = 0
    # decode-pool blocks parked for finished sessions (prefix cache) —
    # allocated but reclaimable, so admission adds them to free headroom
    kv_session_blocks: int = 0

    @property
    def prefill_kv_utilization(self) -> float:
        if self.prefill_kv_total_blocks <= 0:
            return 0.0
        return 1.0 - self.prefill_kv_free_blocks / \
            self.prefill_kv_total_blocks


class Engine:
    """Scheduler/executor-driven serving engine (one replica)."""

    def __init__(self, cfg, serve: ServeConfig, hw: HardwareSpec = TPU_V5E,
                 scheduler: Optional[Scheduler] = None,
                 executor: Optional[Executor] = None,
                 loop: Optional[EventLoop] = None,
                 preempt_policy: PreemptionPolicy = DEFAULT_PREEMPTION):
        self.cfg = cfg
        self.serve = serve
        self.hw = hw
        # injected loop => this engine is one replica of a cluster sharing
        # a single virtual clock; standalone engines own a private loop
        self.loop = loop if loop is not None else EventLoop()
        self.scheduler = scheduler if scheduler is not None \
            else make_scheduler(serve.mode, cfg, serve, hw)
        self.preempt_policy = preempt_policy
        sched = self.scheduler
        pools = sched.pool_blocks(cfg, serve, hw)
        # session prefix cache budget: inert unless requests carry
        # session ids AND the topology keeps KV resident across turns
        # (colocated join-route engines; disagg decode KV is freed on
        # finish like before)
        session_blocks = int(serve.session_cache_frac * pools["decode"]) \
            if sched.prefill_route == "join" else 0
        self.kv = KVCacheManager(pools["decode"], serve.page_size,
                                 session_cache_blocks=session_blocks)
        self.kv_p = KVCacheManager(pools["prefill"], serve.page_size) \
            if "prefill" in pools else None
        lane_chips = sched.lane_chips(serve)
        if not sched.colocated:
            self.chips_p = lane_chips["prefill"]
            self.chips_d = lane_chips["decode"]
        self.executor = executor if executor is not None else \
            PerfModelExecutor(cfg, hw, colocated=sched.colocated,
                              lane_chips=lane_chips)
        self.arm = getattr(sched, "arm", None)     # rapid compat
        # queues: named order-preserving indexed queues (O(1) remove /
        # membership + incremental load accounting, core/queues.py), also
        # exposed as attributes for direct inspection (waiting_kv /
        # waiting_prefill / pending_join / ...)
        self.queues: Dict[str, IndexedQueue] = {
            name: IndexedQueue(serve.page_size)
            for name in sched.queue_names}
        for name, q in self.queues.items():
            setattr(self, name, q)
        self.running = IndexedQueue(serve.page_size)
        self._lane_busy: Dict[str, bool] = {ln: False for ln in sched.lanes}
        self._lane_cost: Dict[str, object] = {ln: None for ln in sched.lanes}
        self._lane_f: Dict[str, Optional[float]] = \
            {ln: None for ln in sched.lanes}
        self.inflight_prefill_tokens = 0
        self.inflight_transfers = 0
        self.inflight_transfer_tokens = 0
        self.finished: List[Request] = []
        self.rejected: List[Request] = []
        self.util_samples: List[UtilSample] = []
        self._all: List[Request] = []
        self.stream = EventStream()

    # -- lane state (legacy flag names kept as read-only views) -------------
    @property
    def prefill_busy(self) -> bool:
        return self._lane_busy.get("prefill",
                                   self._lane_busy.get("step", False))

    @property
    def decode_busy(self) -> bool:
        return self._lane_busy.get("decode",
                                   self._lane_busy.get("step", False))

    @property
    def busy(self) -> bool:                       # hybrid legacy name
        return self._lane_busy.get("step", False)

    # -- streaming API -------------------------------------------------------
    def subscribe(self, fn, rid: Optional[int] = None):
        """Attach a consumer to the typed event stream; ``rid`` narrows
        to one request.  Returns ``fn`` for later ``unsubscribe``."""
        return self.stream.subscribe(fn, rid)

    def events(self):
        """Replay log of every event emitted so far."""
        return self.stream.events()

    def submit(self, r: Request) -> None:
        """Admit one request now (the streaming entry point)."""
        sched = self.scheduler
        r.state = sched.arrival_state
        self.queues[sched.arrival_queue].append(r)
        self.stream.emit(PhaseEvent(r.rid, self.loop.now, "queued"))
        self._wake(Wake("arrival"))

    def enqueue(self, requests: List[Request]) -> None:
        """Seed arrival events on the (possibly shared) loop without
        running it — the cluster drives the loop itself."""
        self._all.extend(requests)
        for r in requests:
            self.loop.at(r.arrival, lambda r=r: self.submit(r))

    def records(self) -> List[RequestRecord]:
        return [RequestRecord.from_request(r) for r in self._all]

    # -- scheduler consultation ---------------------------------------------
    def _view(self, wake: Wake) -> SchedView:
        sched = self.scheduler
        lanes = {ln: LaneState(self._lane_busy[ln], self._lane_cost[ln],
                               self._lane_f[ln]) for ln in sched.lanes}
        return SchedView(now=self.loop.now, serve=self.serve,
                         queues=self.queues, running=self.running,
                         kv=self.kv, kv_p=self.kv_p, lanes=lanes, wake=wake)

    def _wake(self, wake: Wake) -> None:
        view = self._view(wake)
        plan = self.scheduler.schedule(view)
        self._apply(plan, view)

    def _apply(self, plan: StepPlan, view: SchedView) -> None:
        now = self.loop.now
        failed_admits: set = set()
        for r, qname in plan.rejects:
            if qname is None:                     # in-flight transfer
                self.inflight_transfers -= 1
                self.inflight_transfer_tokens -= r.prompt_len
            else:
                self.queues[qname].remove(r)
            self._reject(r)
        for adm in plan.admits:
            r = adm.request
            if adm.from_queue is None:            # in-flight transfer
                self.inflight_transfers -= 1
                self.inflight_transfer_tokens -= r.prompt_len
            else:
                self.queues[adm.from_queue].remove(r)
            # clamp the trace-optimistic shared prefix to what is
            # actually parked HERE (sessions may land on a replica
            # without their prefix, or the cache may have evicted it);
            # transfer-route (disagg) engines never park and sessionless
            # requests have no cache entry, so the clamp zeroes the
            # field there — prefill never skips tokens without KV.
            # A gateway-staged checkpoint restore (crash failover) is the
            # second KV source that can make prefix compute skippable.
            r.cached_prefix_len = max(
                self.kv.session_hit_tokens(
                    r.session_id, r.prompt_len, r.cached_prefix_len),
                self.kv.restore_hit_tokens(r.rid, r.prompt_len))
            try:
                r.blocks = self.kv.allocate_prompt(
                    r.rid, r.prompt_len, session_id=r.session_id,
                    max_prefix=r.cached_prefix_len)
            except OutOfBlocks:
                # defensive: scheduler projections and pool state can
                # only drift on sessionful traces (adoption races);
                # requeue instead of crashing the loop.  Unreachable on
                # the default single-class path.
                r.cached_prefix_len = 0
                if adm.from_queue is None:
                    self.inflight_transfers += 1
                    self.inflight_transfer_tokens += r.prompt_len
                    self.loop.after(
                        self.serve.slo.itl_ms / 1e3,
                        lambda r=r: self._wake(
                            Wake("admit_retry", request=r)))
                else:
                    self.queues[adm.from_queue].appendleft(r)
                failed_admits.add(r.rid)
                continue
            if adm.truncate_to is not None and \
                    adm.truncate_to < r.max_new_tokens:
                r.max_new_tokens = adm.truncate_to
                r.truncated = True
            if adm.stamp_t_blocks:
                r.t_blocks = now
            r.state = adm.state
            if adm.stamp_prefill_start:
                r.t_prefill_start = now
            self.queues[adm.to_queue].append(r)
            self.stream.emit(PhaseEvent(r.rid, now, "kv_allocated"))
        if failed_admits:
            # a failed admit never reached its target queue, so it must
            # not appear in a launch planned on the assumption it would
            # (only reachable on sessionful traces — adoption races)
            if plan.prefill is not None:
                plan.prefill.batch = [r for r in plan.prefill.batch
                                      if r.rid not in failed_admits]
                if not plan.prefill.batch:
                    plan.prefill = None
            if plan.hybrid is not None:
                plan.hybrid.chunks = [(r, t) for r, t in plan.hybrid.chunks
                                      if r.rid not in failed_admits]
                if not plan.hybrid.chunks and not self.running:
                    plan.hybrid = None
            if plan.decode is not None:
                plan.decode.joins = [r for r in plan.decode.joins
                                     if r.rid not in failed_admits]
        outs = self.executor.execute(plan, view)
        if plan.prefill is not None:
            batch = plan.prefill.batch
            q = self.queues[plan.prefill.queue]
            for r in batch:
                q.remove(r)
                if plan.prefill.pool == "prefill":
                    # split pools never park session KV, and the decode-
                    # side clamp runs only after transfer: drop the
                    # optimistic prefix claim before pricing the prefill
                    r.cached_prefix_len = 0
                    self.kv_p.allocate_prompt(r.rid, r.prompt_len)
                r.state = State.PREFILLING
                r.t_prefill_start = now
                self.stream.emit(PhaseEvent(r.rid, now, "prefill"))
            self._lane_busy["prefill"] = True
            self._lane_cost["prefill"] = outs.prefill.cost
            self.inflight_prefill_tokens = sum(r.prefill_tokens_needed
                                               for r in batch)
            self.loop.after(outs.prefill.duration_s,
                            lambda b=batch: self._prefill_done(b))
        if plan.decode is not None:
            for r in plan.decode.joins:
                self.queues["pending_join"].remove(r)
                r.state = State.DECODING
                self.running.append(r)
                self.stream.emit(PhaseEvent(r.rid, now, "decode"))
            self._lane_busy["decode"] = True
            self._lane_cost["decode"] = outs.decode.cost
            self._lane_f["decode"] = plan.decode.f_decode
            batch = list(self.running)
            self.loop.after(outs.decode.duration_s,
                            lambda b=batch: self._decode_done(b))
        if plan.hybrid is not None:
            self._lane_busy["step"] = True
            self._lane_cost["step"] = outs.hybrid.cost
            batch = list(self.running)
            chunks = plan.hybrid.chunks
            self.loop.after(outs.hybrid.duration_s,
                            lambda b=batch, c=chunks: self._step_done(b, c))
        for retry in plan.retries:
            self.loop.after(
                retry.delay_s,
                lambda r=retry.request: self._wake(
                    Wake("admit_retry", request=r)))

    # -- step completions (the execution substrate) -------------------------
    def _prefill_done(self, batch: List[Request]) -> None:
        now = self.loop.now
        sched = self.scheduler
        freed = False
        for r in batch:
            r.t_prefill_end = now
            # whole-prompt prefill covered every non-cached token;
            # recording it keeps the conservation invariant
            # prefill_tokens_done + cached_prefix_len == prompt_len
            r.prefill_tokens_done = r.prefill_tokens_needed
            if sched.prefill_route == "transfer":
                # KV transfer on the critical path (ICI), then decode-side
                # admission + first-token recompute (vLLM v1, §3.2.1)
                xfer = self.executor.transfer_seconds(r, self.serve)
                self.inflight_transfers += 1
                self.inflight_transfer_tokens += r.prompt_len
                self.stream.emit(PhaseEvent(r.rid, now, "transfer"))
                self.loop.after(xfer, lambda r=r: self._transfer_arrived(r))
            else:
                r.emit_token(now)             # first token from prefill
                self.stream.emit(TokenEvent(r.rid, now,
                                            r.tokens_generated - 1))
                r.state = State.PREFILL_FINISHED
                if r.done:                    # single-token request
                    self._release_kv(r)
                    self._finish(r)
                    freed = True
                else:
                    self.queues["pending_join"].append(r)
        self._lane_busy["prefill"] = False
        self._lane_cost["prefill"] = None
        self.inflight_prefill_tokens = 0
        self._wake(Wake("prefill_done", kv_freed=freed))

    def _transfer_arrived(self, r: Request) -> None:
        self.kv_p.free(r.rid)         # prefill-side memory released ONCE
        self._wake(Wake("transfer_arrived", request=r))

    def _decode_done(self, batch: List[Request]) -> None:
        now = self.loop.now
        freed = False
        for r in batch:
            if r not in self.running:     # preempted mid-loop
                continue
            try:
                self.kv.append_token(r.rid)
            except OutOfBlocks:
                victim = self._preempt_victim()
                if victim is None or victim is r:
                    continue
                self.kv.append_token(r.rid)
            r.emit_token(now)
            self.running.note_token(r)
            self.stream.emit(TokenEvent(r.rid, now, r.tokens_generated - 1))
            if r.done:
                self._release_kv(r)
                self.running.remove(r)
                self._finish(r)
                freed = True
        self._lane_busy["decode"] = False
        self._lane_cost["decode"] = None
        self.util_samples.append(UtilSample(now, self.kv.utilization, True))
        self._wake(Wake("decode_done", kv_freed=freed))

    def _step_done(self, decode_batch: List[Request],
                   chunks: List[tuple]) -> None:
        now = self.loop.now
        chunking = self.queues["chunking"]
        for r, take in chunks:
            r.prefill_tokens_done += take
            chunking.note_chunk_progress(r, take)
            if r.prefill_tokens_done >= r.prefill_tokens_needed:
                r.t_prefill_end = now
                r.emit_token(now)     # last chunk produces first token
                self.stream.emit(TokenEvent(r.rid, now,
                                            r.tokens_generated - 1))
                chunking.remove(r)
                if r.done:
                    self._release_kv(r)
                    self._finish(r)
                else:
                    r.state = State.DECODING
                    self.running.append(r)
                    self.stream.emit(PhaseEvent(r.rid, now, "decode"))
        for r in decode_batch:
            if r not in self.running:     # preempted mid-loop
                continue
            try:
                self.kv.append_token(r.rid)
            except OutOfBlocks:
                victim = self._preempt_victim()
                if victim is None or victim is r:
                    continue
                self.kv.append_token(r.rid)
            r.emit_token(now)
            self.running.note_token(r)
            self.stream.emit(TokenEvent(r.rid, now, r.tokens_generated - 1))
            if r.done:
                self._release_kv(r)
                self.running.remove(r)
                self._finish(r)
        self._lane_busy["step"] = False
        self._lane_cost["step"] = None
        self.util_samples.append(UtilSample(now, self.kv.utilization, True))
        self._wake(Wake("step_done"))

    # -- terminal transitions ------------------------------------------------
    def _release_kv(self, r: Request) -> None:
        """Release a finishing request's decode-pool KV: park it for the
        session's next turn when the request is sessionful (colocated
        engines), else free it exactly as before."""
        if r.session_id is not None and \
                self.kv.session_cache_blocks > 0:
            self.kv.release_to_session(r.rid, r.session_id)
        else:
            self.kv.free(r.rid)

    def _finish(self, r: Request) -> None:
        r.state = State.FINISHED
        r.t_finish = self.loop.now
        self.finished.append(r)
        self.stream.emit(FinishedEvent(
            r.rid, self.loop.now, r.arrival, r.prompt_len,
            r.tokens_generated, r.preemptions, r.slo_class,
            retries=r.retries, truncated=r.truncated))

    def _reject(self, r: Request, reason: str = "never_fits") -> None:
        """A request whose prompt can never fit the pool is turned away
        instead of deadlocking the queue head (or, for disagg, retrying
        forever) — the caller sees ``state == REJECTED``, never an
        ``OutOfBlocks`` escaping the event loop."""
        r.state = State.REJECTED
        r.blocks = None
        r.reject_reason = reason
        self.rejected.append(r)
        self.stream.emit(RejectedEvent(
            r.rid, self.loop.now, r.arrival, r.prompt_len, reason,
            r.tokens_generated, r.preemptions, r.slo_class,
            retries=r.retries))

    # -- local preemption (recompute on resume) ------------------------------
    def _preempt_victim(self) -> Optional[Request]:
        """Preempt one running request; the shared ``PreemptionPolicy``
        ranks victims, the scheduler's topology names the re-entry
        queue."""
        victim = self._evict_running()
        if victim is not None:
            self._requeue_preempted(victim)
        return victim

    def _evict_running(self) -> Optional[Request]:
        victim = self.preempt_policy.choose(self.running)
        if victim is None:
            return None
        self.running.remove(victim)
        self.kv.preempt(victim.rid)
        victim.preemptions += 1
        victim.blocks = None
        victim.prefill_tokens_done = 0
        # recompute-on-resume re-prefills the WHOLE context: the cached
        # prefix's pages were just freed with the rest of the victim's KV
        victim.cached_prefix_len = 0
        self.stream.emit(PhaseEvent(victim.rid, self.loop.now, "preempted"))
        return victim

    def _requeue_preempted(self, victim: Request) -> None:
        # recompute-on-resume: the whole context becomes the new "prompt"
        sched = self.scheduler
        victim.state = sched.requeue_state
        self.queues[sched.requeue_queue].appendleft(victim)

    # -- targeted removal / crash halt (serving gateway) --------------------
    def evict_request(self, r: Request) -> bool:
        """Remove ONE specific request from this engine entirely.  Unlike
        ``_preempt_victim`` the victim is chosen by the caller (gateway
        backpressure pause, targeted recovery) and is NOT requeued here —
        the caller re-``submit()``s it (possibly on another replica)
        later; recompute-on-resume re-prefills the context and token
        emission continues from ``tokens_generated``.  Returns False when
        ``r`` is pinned inside an in-flight lane step (mid-prefill,
        mid-transfer): callers retry after the step completes."""
        if r in self.running:
            self.running.remove(r)
            self.kv.preempt(r.rid)
            r.preemptions += 1
            r.blocks = None
            r.prefill_tokens_done = 0
            r.cached_prefix_len = 0
            r.state = State.PREEMPTED
            self.stream.emit(PhaseEvent(r.rid, self.loop.now, "preempted"))
            return True
        for q in self.queues.values():
            if r in q:
                q.remove(r)
                # only count a preemption when work is actually lost:
                # a request still waiting for KV has nothing to recompute
                if r.blocks is not None or r.prefill_tokens_done > 0:
                    r.preemptions += 1
                    self.stream.emit(PhaseEvent(r.rid, self.loop.now,
                                                "preempted"))
                if r.blocks is not None:
                    self.kv.preempt(r.rid)
                    r.blocks = None
                    r.cached_prefix_len = 0
                r.prefill_tokens_done = 0
                r.state = State.PREEMPTED
                return True
        return False

    def halt(self) -> None:
        """Model this engine crashing: stop planning new work.  Pending
        step-completion callbacks are already on the (shared) loop and
        still fire — they emit into a stream nobody forwards anymore and
        then find an inert scheduler, so the replica freezes instead of
        leaking events forever.  Irreversible; the gateway replaces a
        crashed worker with a fresh one."""
        if not isinstance(self.scheduler, _HaltedScheduler):
            self.scheduler = _HaltedScheduler(self.scheduler)

    @property
    def halted(self) -> bool:
        return isinstance(self.scheduler, _HaltedScheduler)

    # -- cross-replica migration (cluster rebalance tick) -------------------
    def _peek_queued_for_migration(self) -> Optional[Request]:
        """Newest request still waiting for KV/prefill — it holds no KV,
        so moving it is a free re-route."""
        q = self.queues[self.scheduler.migration_queue]
        return q[-1] if q else None

    def _pop_queued_for_migration(self) -> Optional[Request]:
        q = self.queues[self.scheduler.migration_queue]
        return q.pop() if q else None

    def migration_candidate(self):
        """Peek at what ``evict_for_migration`` would take: (request,
        has_kv) or None.  No side effects — the cluster uses this to
        check bucket compatibility and migration caps before evicting."""
        q = self._peek_queued_for_migration()
        if q is not None:
            return q, False
        victim = self.preempt_policy.choose(self.running)
        return (victim, True) if victim is not None else None

    def evict_for_migration(self):
        """Remove one request from this engine entirely for re-enqueue on
        another replica.  Returns (request, had_kv) or None; ``had_kv``
        means live KV was dropped (the cluster charges a transfer cost)."""
        q = self._pop_queued_for_migration()
        if q is not None:
            q.state = State.ARRIVED
            return q, False
        victim = self._evict_running()
        if victim is None:
            return None
        victim.state = State.ARRIVED
        return victim, True

    # -- runtime pool scaling (cluster autoscaler) ---------------------------
    def resize_lane(self, lane: str, chips: int) -> None:
        """Grow one lane's chip group in place (split-pool engines only):
        the matching KV pool gains the extra chips' HBM worth of pages,
        the executor prices that lane on the new chip count, and the
        OTHER pool — including every live KV page in it — is untouched.
        Chip groups only grow; shrinking would strand live KV."""
        sched = self.scheduler
        old = sched.lane_chips(self.serve).get(lane)
        if old is None:
            raise KeyError(f"engine has no lane {lane!r}")
        if chips < old:
            raise ValueError(
                f"lane {lane!r} only grows ({old} -> {chips} shrinks)")
        if chips == old:
            return
        pools = sched.resize_lane(lane, chips, self.cfg, self.serve,
                                  self.hw)
        for pool, mgr in (("decode", self.kv), ("prefill", self.kv_p)):
            if mgr is not None and pools.get(pool, 0) > \
                    mgr.allocator.num_blocks:
                mgr.grow(pools[pool] - mgr.allocator.num_blocks)
        self.chips_p = sched.chips_p
        self.chips_d = sched.chips_d
        if hasattr(self.executor, "lane_chips"):
            self.executor.lane_chips[lane] = chips
        # total chips / split recorded on the config so routers and
        # admission (which read serve.chips) see the new capacity
        self.serve = dataclasses.replace(
            self.serve, chips=self.chips_p + self.chips_d,
            disagg_split=(self.chips_p, self.chips_d))

    # -- load view ------------------------------------------------------------
    def load_snapshot(self) -> LoadSnapshot:
        """O(1) load view from the incremental ``IndexedQueue`` counters.

        Routers, admission and the autoscaler call this per arrival and
        per tick; the first implementation re-walked every queue on every
        call (kept below as ``load_snapshot_recompute`` — the reference
        the property tests compare against, and the pinned baseline the
        hot-path benchmark measures its speedup from)."""
        sched = self.scheduler
        ps = self.serve.page_size
        queues = self.queues
        queued = sum(len(queues[q]) for q in sched.count_queues)
        # pending_prefill_tokens nets out session-cached prefixes (and
        # chunked progress); equal to prompt_tokens for whole queues of
        # sessionless requests, so the legacy accounting is unchanged
        tokens = sum(queues[q].pending_prefill_tokens
                     for q in sched.token_queues)
        tokens += sum(queues[q].pending_prefill_tokens
                      for q in sched.partial_token_queues)
        tokens += self.inflight_prefill_tokens
        pages = sum(queues[q].kv_pages for q in sched.unalloc_queues)
        # split-pool engines: the same queued prompts also claim transient
        # prefill-side pages before they ever reach the decode pool
        prefill_free = prefill_total = prefill_pages = 0
        if self.kv_p is not None:
            prefill_free = self.kv_p.allocator.free_count
            prefill_total = self.kv_p.allocator.num_blocks
            prefill_pages = pages
        running = len(self.running)
        ctx = self.running.ctx_tokens
        if sched.prefill_route == "transfer":
            # transfers in flight count as imminent decode load: they are
            # done with prefill but WILL join the decode batch, so both
            # routers and the autoscaler's idle detection must see them
            queued += self.inflight_transfers
            running += self.inflight_transfers
            ctx += self.inflight_transfer_tokens
            pages += kv_pages_for(self.inflight_transfer_tokens, ps)
        return LoadSnapshot(
            queued_requests=queued,
            queued_prefill_tokens=tokens,
            running_decode=running,
            decode_ctx_tokens=ctx,
            kv_utilization=self.kv.utilization,
            prefill_busy=self.prefill_busy,
            decode_busy=self.decode_busy,
            kv_free_blocks=self.kv.allocator.free_count,
            kv_total_blocks=self.kv.allocator.num_blocks,
            queued_kv_pages=pages,
            prefill_kv_free_blocks=prefill_free,
            prefill_kv_total_blocks=prefill_total,
            queued_prefill_kv_pages=prefill_pages,
            chips_prefill=getattr(self, "chips_p", self.serve.chips),
            chips_decode=getattr(self, "chips_d", self.serve.chips),
            kv_session_blocks=self.kv.session_blocks)

    def router_load(self) -> "tuple[int, int, int]":
        """The three ``LoadSnapshot`` fields routers price on —
        ``(queued_prefill_tokens, running_decode, decode_ctx_tokens)`` —
        read straight from the incremental counters, skipping the full
        16-field snapshot build (KV occupancy, page claims, lane flags).

        The batched slo_aware router gathers one of these per replica
        per arrival; at fleet scale the full snapshot's construction
        cost dominates the priced decision itself.  Must stay
        value-identical to ``load_snapshot()`` — pinned by
        ``test_load_accounting``."""
        sched = self.scheduler
        queues = self.queues
        tokens = self.inflight_prefill_tokens
        for q in sched.token_queues:
            tokens += queues[q].pending_prefill_tokens
        for q in sched.partial_token_queues:
            tokens += queues[q].pending_prefill_tokens
        running = len(self.running)
        ctx = self.running.ctx_tokens
        if sched.prefill_route == "transfer":
            running += self.inflight_transfers
            ctx += self.inflight_transfer_tokens
        return tokens, running, ctx

    def load_snapshot_recompute(self) -> LoadSnapshot:
        """Recompute the load view from scratch by walking every queue —
        the first O(n) implementation, kept verbatim as (a) the oracle the
        hypothesis property tests compare the incremental counters
        against and (b) the pinned pre-optimization baseline
        ``benchmarks/bench_hotpath.py`` measures its speedup from.
        Must stay semantically identical to ``load_snapshot``."""
        sched = self.scheduler
        ps = self.serve.page_size
        queued = sum(len(self.queues[q]) for q in sched.count_queues)
        tokens = sum(r.prompt_len - r.cached_prefix_len
                     - r.prefill_tokens_done
                     for q in sched.token_queues for r in self.queues[q])
        tokens += sum(r.prompt_len - r.cached_prefix_len
                      - r.prefill_tokens_done
                      for q in sched.partial_token_queues
                      for r in self.queues[q])
        tokens += self.inflight_prefill_tokens
        pages = sum(kv_pages_for(r.prompt_len, ps)
                    for q in sched.unalloc_queues for r in self.queues[q])
        prefill_free = prefill_total = prefill_pages = 0
        if self.kv_p is not None:
            prefill_free = self.kv_p.allocator.free_count
            prefill_total = self.kv_p.allocator.num_blocks
            prefill_pages = pages
        running = len(self.running)
        ctx = sum(r.context_len for r in self.running)
        if sched.prefill_route == "transfer":
            queued += self.inflight_transfers
            running += self.inflight_transfers
            ctx += self.inflight_transfer_tokens
            pages += kv_pages_for(self.inflight_transfer_tokens, ps)
        return LoadSnapshot(
            queued_requests=queued,
            queued_prefill_tokens=tokens,
            running_decode=running,
            decode_ctx_tokens=ctx,
            kv_utilization=self.kv.utilization,
            prefill_busy=self.prefill_busy,
            decode_busy=self.decode_busy,
            kv_free_blocks=self.kv.allocator.free_count,
            kv_total_blocks=self.kv.allocator.num_blocks,
            queued_kv_pages=pages,
            prefill_kv_free_blocks=prefill_free,
            prefill_kv_total_blocks=prefill_total,
            queued_prefill_kv_pages=prefill_pages,
            chips_prefill=getattr(self, "chips_p", self.serve.chips),
            chips_decode=getattr(self, "chips_d", self.serve.chips),
            kv_session_blocks=self.kv.session_blocks)


class _HaltedScheduler:
    """Scheduler stand-in installed by ``Engine.halt()``: keeps the
    topology attributes (queue accounting, load snapshots still work)
    but plans nothing, so in-flight completions drain without launching
    new steps."""

    def __init__(self, inner: Scheduler):
        self._inner = inner

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def schedule(self, view: SchedView) -> StepPlan:
        return StepPlan()


# legacy name: early callers subclassed/annotated against BaseEngine
BaseEngine = Engine


# ---------------------------------------------------------------------------
# Thin mode-bound constructors (compatibility + convenience)
# ---------------------------------------------------------------------------


class RapidEngine(Engine):
    """Paper §4 engine: RapidScheduler on the shared substrate.
    ``executor`` (the port's addition) runs its plans, e.g. a
    ``KernelExecutor`` on the device; default: the perfmodel's."""

    def __init__(self, cfg, serve: ServeConfig, hw: HardwareSpec = TPU_V5E,
                 avg_ctx_hint: int = 4096,
                 loop: Optional[EventLoop] = None,
                 preempt_policy: PreemptionPolicy = DEFAULT_PREEMPTION,
                 executor: Optional[Executor] = None):
        super().__init__(
            cfg, serve, hw,
            scheduler=RapidScheduler(cfg, serve, hw, avg_ctx_hint),
            executor=executor, loop=loop, preempt_policy=preempt_policy)


class HybridEngine(Engine):
    """Sarathi/vLLM-v1 chunked-prefill baseline."""

    def __init__(self, cfg, serve: ServeConfig, hw: HardwareSpec = TPU_V5E,
                 loop: Optional[EventLoop] = None,
                 preempt_policy: PreemptionPolicy = DEFAULT_PREEMPTION):
        super().__init__(cfg, serve, hw,
                         scheduler=HybridScheduler(cfg, serve, hw),
                         loop=loop, preempt_policy=preempt_policy)


class DisaggEngine(Engine):
    """DistServe-style split-pool baseline."""

    def __init__(self, cfg, serve: ServeConfig, hw: HardwareSpec = TPU_V5E,
                 loop: Optional[EventLoop] = None,
                 preempt_policy: PreemptionPolicy = DEFAULT_PREEMPTION):
        super().__init__(cfg, serve, hw,
                         scheduler=DisaggScheduler(cfg, serve, hw),
                         loop=loop, preempt_policy=preempt_policy)


ENGINES = {
    "rapid": RapidEngine,
    "hybrid": HybridEngine,
    "disagg": DisaggEngine,
}


def make_engine(mode: str, cfg, serve: ServeConfig,
                hw: HardwareSpec = TPU_V5E,
                loop: Optional[EventLoop] = None,
                preempt_policy: PreemptionPolicy = DEFAULT_PREEMPTION
                ) -> Engine:
    if mode not in ENGINES:
        raise KeyError(
            f"unknown engine mode {mode!r}; known: {sorted(ENGINES)}")
    return ENGINES[mode](cfg, serve, hw, loop=loop,
                         preempt_policy=preempt_policy)


def drive(engine: BaseEngine, requests: List[Request]
          ) -> "tuple[List[RequestRecord], float]":
    """Blocking convenience driver for a STANDALONE engine (tests,
    examples, single-replica experiments): enqueue the trace, run its
    loop dry, and return ``(records, span_s)``.

    This replaces the old ``Engine.run()`` shim.  It is a free function
    on purpose: cluster and gateway callers share one loop across many
    engines and must drive it themselves, consuming the typed event
    stream (``engine.subscribe`` / ``serving.metrics.StreamMetrics``)
    rather than scraping records after the fact."""
    engine.enqueue(list(requests))
    engine.loop.run()
    span = engine.loop.now if engine.loop.now > 0 else 1.0
    return engine.records(), span
