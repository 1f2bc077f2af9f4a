"""Online serving gateway: admission, routing, streaming, failover.

The gateway is the asyncio-shaped front-end the paper's serving stack
has been building toward: it owns cluster-side admission
(serving/admission.py) and routing (the serving/cluster.py router zoo,
including session affinity), keeps a registry of per-replica engine
workers with heartbeat health checks, and forwards each engine's typed
event stream (core/events.py) into bounded per-request channels — the
same events serialize as JSON lines for the HTTP surface
(serving/http.py), so the engines' event stream IS the wire format.

Everything is scheduled through a *clock* (serving/clock.py): under the
simulated ``EventLoop`` the whole gateway — heartbeats, crash
detection, failover, drains, backpressure — runs deterministically in
CI with no sockets or sleeps; under ``RealTimeClock`` the same code
serves real HTTP clients.

Churn semantics (tests/test_gateway_churn.py):

  * **Worker crash.**  ``kill_worker`` halts the engine and stops its
    heartbeats; the registry declares it dead after
    ``heartbeat_timeout_s`` and the gateway re-submits every in-flight
    request as a fresh clone on a healthy worker (re-prefill from
    scratch; the session prefix may shortcut it on a session-affine
    worker).  The per-request channel dedupes the replayed token
    indices, so a consumer sees one contiguous stream; ``retries`` on
    the final record counts the failovers.  When retries are exhausted
    or no healthy worker remains, the request ends with a typed
    ``RejectedEvent(reason="worker_lost")`` — accepted requests never
    vanish silently.
  * **Rolling upgrade.**  ``drain_worker`` stops routing to a worker,
    migrates its queued (KV-free) requests away via the existing
    migration machinery, lets in-flight decodes finish in place, then
    retires and deregisters it.  ``rolling_upgrade`` chains
    add-replacement → drain-old across the fleet, one worker at a time.
  * **Slow consumer.**  A per-request channel that fills to
    ``stream_buffer`` pauses *its own* request — the gateway evicts it
    from its engine (freeing KV for everyone else) and re-admits it
    when the consumer drains.  Other streams are unaffected.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.events import (CancelledEvent, EventStream,
                                     FinishedEvent, PhaseEvent, RejectedEvent,
                                     TERMINAL_EVENTS, TokenEvent)
from repro_torch.core.request import Request, State
from repro_torch.kvcache import CheckpointStore, KVCheckpoint
from repro_torch.perfmodel.costs import kv_migration_seconds
from repro_torch.perfmodel.hw import TPU_V5E, HardwareSpec
from repro_torch.serving.admission import AdmissionController, AdmissionPolicy
from repro_torch.serving.cluster import make_router
from repro_torch.serving.faults import RetryPolicy
from repro_torch.serving.metrics import (RequestRecord, StreamMetrics,
                                         fleet_summarize)
from repro_torch.serving.sim import EventLoop
from repro_torch.serving.worker import ReplicaWorker, WorkerState


@dataclasses.dataclass(frozen=True)
class GatewayPolicy:
    """Gateway-level knobs (admission knobs live in AdmissionPolicy).

    ``heartbeat_timeout_s`` should exceed ``heartbeat_s`` by a safety
    factor (default ~3.5 beats) so one delayed beat never triggers a
    spurious failover.  ``stream_buffer`` bounds each request's channel;
    a consumer that falls that far behind gets its request evicted from
    the engine (backpressure) until it drains below
    ``stream_buffer * resume_frac``.

    ``checkpoint_interval`` > 0 enables crash-consistent KV recovery:
    every that-many delivered tokens the gateway snapshots the request's
    KV off the worker (the copy is costed with the perfmodel's
    ``kv_migration_seconds`` at ``checkpoint_gbps``, defaulting to the
    serve config's ``kv_transfer_gbps``), and crash failover resumes
    from the newest snapshot instead of re-prefilling — re-computing at
    most ``checkpoint_interval`` tokens.  ``checkpoint_store_blocks``
    caps the parked-KV budget (0 = unbounded)."""
    heartbeat_s: float = 0.5
    heartbeat_timeout_s: float = 1.75
    health_check_s: float = 0.5
    drain_check_s: float = 0.25
    stream_buffer: int = 64
    resume_frac: float = 0.5
    max_retries: int = 2
    evict_retry_s: float = 0.05     # re-try eviction pinned mid-step
    checkpoint_interval: int = 0    # tokens between KV snapshots (0=off)
    checkpoint_gbps: float = 0.0    # snapshot link speed (0 => serve cfg)
    checkpoint_store_blocks: int = 0    # parked-KV budget (0 = unbounded)


class RequestChannel:
    """Bounded per-request event channel between a worker and a consumer.

    ``offer`` is the producer side (gateway); it **dedupes token
    replays** — after a crash failover the clone re-generates tokens
    from index 0, and only the first occurrence of each index passes —
    so consumers always see one contiguous token stream per request.

    Consumption is either *inline* (a ``consumer`` callable invoked at
    offer time — no buffering, used by the simulated trace replay) or
    *pulled* (``take``/``drain`` on the internal deque, used by the HTTP
    server; ``notify`` pokes the async waiter).  When the buffer
    reaches ``capacity`` the channel flags itself paused and tells the
    gateway via ``on_pause``; draining below ``resume_at`` fires
    ``on_resume``.  Terminal events are always accepted — capacity is a
    backpressure watermark, not a hard drop."""

    def __init__(self, rid: int, capacity: int = 64,
                 resume_at: Optional[int] = None,
                 consumer: Optional[Callable] = None,
                 notify: Optional[Callable[[], None]] = None,
                 on_pause: Optional[Callable[[int], None]] = None,
                 on_resume: Optional[Callable[[int], None]] = None):
        self.rid = rid
        self.capacity = capacity
        self.resume_at = capacity // 2 if resume_at is None else resume_at
        self._consumer = consumer
        self._notify = notify
        self._on_pause = on_pause
        self._on_resume = on_resume
        self.buf: collections.deque = collections.deque()
        self.next_index = 0          # next un-seen token index
        self.closed = False          # terminal event passed through
        self.paused = False
        self.stalled = False         # fault injection: consumer wedged
        self.dup_tokens = 0          # replayed indices suppressed (failover)
        self.gap_tokens = 0          # ahead-of-stream indices (wire loss)

    def offer(self, ev) -> bool:
        """Deliver ``ev``; False when it was a duplicate (replayed token
        index) or the channel already closed."""
        if self.closed:
            return False
        if isinstance(ev, TokenEvent):
            if ev.index != self.next_index:
                # replayed (failover) or out of order; the split counter
                # is the recovery cost metric: dup_tokens is exactly the
                # tokens the failover re-computed for this request
                if ev.index < self.next_index:
                    self.dup_tokens += 1
                else:
                    self.gap_tokens += 1
                return False
            self.next_index += 1
        if isinstance(ev, TERMINAL_EVENTS):
            self.closed = True
        if self._consumer is not None and not self.stalled:
            self._consumer(ev)
            return True
        self.buf.append(ev)
        if self._notify is not None:
            self._notify()
        if (not self.closed and not self.paused
                and len(self.buf) >= self.capacity):
            self.paused = True
            if self._on_pause is not None:
                self._on_pause(self.rid)
        return True

    def take(self):
        """Pop the oldest buffered event (None when empty)."""
        ev = self.buf.popleft() if self.buf else None
        self._maybe_resume()
        return ev

    def drain(self) -> List:
        out = list(self.buf)
        self.buf.clear()
        self._maybe_resume()
        return out

    def stall(self) -> None:
        """Fault injection: wedge the consumer — even inline consumers
        start buffering, so the backpressure watermark (pause/evict)
        engages exactly as for a genuinely slow reader."""
        self.stalled = True

    def unstall(self) -> None:
        """Un-wedge: flush everything buffered during the stall to the
        inline consumer (pull-mode consumers drain themselves)."""
        self.stalled = False
        if self._consumer is not None:
            while self.buf:
                self._consumer(self.buf.popleft())
        self._maybe_resume()

    def _maybe_resume(self) -> None:
        if self.paused and len(self.buf) <= self.resume_at:
            self.paused = False
            if self._on_resume is not None:
                self._on_resume(self.rid)

    @property
    def done(self) -> bool:
        """Closed AND fully consumed."""
        return self.closed and not self.buf

    def __len__(self) -> int:
        return len(self.buf)


class WorkerRegistry:
    """Tracks workers, their heartbeats, and declares the silent dead.

    ``replicas`` is the live ``Replica`` list the router binds to (same
    contract as ``Cluster.replicas`` — later registrations are visible).
    The periodic health tick compares each worker's last heartbeat
    against ``heartbeat_timeout_s``; a crashed worker stops beating
    (``ReplicaWorker.kill``) and is marked dead here, which triggers the
    gateway's failover exactly once per death."""

    def __init__(self, clock, policy: GatewayPolicy,
                 on_death: Callable[[ReplicaWorker], None],
                 keep_alive: Callable[[], bool]):
        self.clock = clock
        self.policy = policy
        self.workers: Dict[int, ReplicaWorker] = {}
        self.replicas: List = []     # router-facing live list
        self.last_beat: Dict[int, float] = {}
        self._on_death = on_death
        self._keep_alive = keep_alive
        self._tick_armed = False
        self.fenced_beats = 0        # beats refused from dead/unknown wids

    def register(self, w: ReplicaWorker) -> None:
        self.workers[w.wid] = w
        self.replicas.append(w.replica)
        self.last_beat[w.wid] = self.clock.now
        w.ensure_beat()
        self.ensure_tick()

    def deregister(self, wid: int) -> None:
        w = self.workers.pop(wid, None)
        if w is not None:
            if w.replica in self.replicas:
                self.replicas.remove(w.replica)
            self.last_beat.pop(wid, None)

    def heartbeat(self, wid: int) -> None:
        """Record a beat — unless the sender was already declared dead
        (or never registered).  Fencing: a worker that went silent past
        ``heartbeat_timeout_s`` had its requests failed over; letting a
        late beat resurrect it would double-serve them.  A fenced worker
        can only rejoin as a *fresh* worker via ``add_worker``."""
        w = self.workers.get(wid)
        if w is None or w.state in (WorkerState.DEAD, WorkerState.RETIRED):
            self.fenced_beats += 1
            return
        self.last_beat[wid] = self.clock.now

    def healthy(self) -> List[ReplicaWorker]:
        return [w for w in self.workers.values()
                if w.state is WorkerState.UP and not w.crashed]

    # -- periodic health check ----------------------------------------------

    def ensure_tick(self) -> None:
        if not self._tick_armed:
            self._tick_armed = True
            self.clock.after(self.policy.health_check_s, self._health_tick)

    def _health_tick(self) -> None:
        self._tick_armed = False
        now = self.clock.now
        for w in list(self.workers.values()):
            if (w.state in (WorkerState.UP, WorkerState.DRAINING)
                    and now - self.last_beat.get(w.wid, now)
                    > self.policy.heartbeat_timeout_s):
                w.mark_dead()
        for w in list(self.workers.values()):
            if w.state is WorkerState.DEAD and not w.death_handled:
                w.death_handled = True
                if w.replica in self.replicas:
                    self.replicas.remove(w.replica)
                self._on_death(w)
        if self._keep_alive():
            self.ensure_tick()

    def resume_ticks(self) -> None:
        """Re-arm heartbeats + health tick after a simulated idle gap.

        The virtual clock may have jumped far past every stale beat
        while the gateway was idle (ticks stop re-arming when nothing is
        in flight); granting each live worker one fresh beat prevents
        the entire fleet being declared dead on the first tick back."""
        now = self.clock.now
        for w in self.workers.values():
            if w.state in (WorkerState.UP, WorkerState.DRAINING):
                self.last_beat[w.wid] = now
                w.ensure_beat()
        self.ensure_tick()


@dataclasses.dataclass
class _RequestState:
    """Gateway-side bookkeeping for one live request."""
    request: Request
    channel: RequestChannel
    worker: Optional[ReplicaWorker] = None
    orig_prefix: int = 0         # trace's optimistic cached_prefix_len
    paused: bool = False         # consumer fell behind
    evicted: bool = False        # removed from its engine while paused
    orig_prompt: int = 0         # original prompt_len (clones may extend)
    orig_max_new: int = 0        # original max_new_tokens budget
    token_base: int = 0          # absolute index of the clone's token 0
    ckpt_inflight: bool = False  # a snapshot copy is on the wire
    resume_ckpt: Optional[KVCheckpoint] = None   # stage at next dispatch


def _make_engine(mode: str, cfg, serve, hw: HardwareSpec, loop):
    from repro_torch.core.engines import make_engine   # break import cycle
    return make_engine(mode, cfg, serve, hw, loop=loop)


class Gateway:
    """The serving front-end.  See module docstring for semantics."""

    def __init__(self, cfg, serve, modes=(), router: str = "least_loaded",
                 hw: HardwareSpec = TPU_V5E, clock=None,
                 policy: Optional[GatewayPolicy] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 session_affinity: bool = True,
                 retry: Optional[RetryPolicy] = None,
                 engine_factory: Optional[Callable] = None):
        self.cfg = cfg
        # how a worker's engine is built (the port's addition):
        # ``engine_factory(mode, cfg, serve, hw, loop=clock)``; the default
        # is ``core.engines.make_engine``, the perfmodel-priced engines
        self.engine_factory = engine_factory or _make_engine
        self.serve = serve
        self.hw = hw
        self.clock = clock if clock is not None else EventLoop()
        self.policy = policy if policy is not None else GatewayPolicy()
        self.retry = retry if retry is not None else \
            RetryPolicy(max_retries=self.policy.max_retries)
        self.router = make_router(router, cfg, serve, hw)
        self.admission = AdmissionController(
            admission if admission is not None else AdmissionPolicy())
        self.session_affinity = session_affinity
        self.stream = EventStream()          # fleet-wide, deduped
        self.metrics = StreamMetrics()
        self.stream.subscribe(self.metrics)
        self.registry = WorkerRegistry(self.clock, self.policy,
                                       on_death=self._on_worker_death,
                                       keep_alive=self._keep_alive)
        self.router.bind(self.registry.replicas)
        self._live: Dict[int, _RequestState] = {}
        self._paused: Set[int] = set()
        self._session_home: Dict[str, int] = {}
        self._next_wid = 0
        self._next_rid = 0
        self._submitted = 0
        self._expected = 0           # serve_trace() arrivals not yet in
        self.migrations = 0
        self.checkpoints = CheckpointStore(
            serve.page_size, self.policy.checkpoint_store_blocks)
        self.resumes = 0             # failovers restored from a snapshot
        self.replayed_tokens = 0     # tokens re-computed across failovers
        self.cancellations = 0
        self._wire_taps: List[Callable] = []     # fault injection hooks
        self._t0: Optional[float] = None
        self._idle = False           # ticks disarmed; resume on submit
        for m in modes:
            self.add_worker(m)

    # -- fleet management ---------------------------------------------------

    def add_worker(self, mode: str, serve=None) -> ReplicaWorker:
        sv = serve if serve is not None else self.serve
        wid = self._next_wid
        self._next_wid += 1
        engine = self.engine_factory(mode, self.cfg, sv, self.hw,
                                     loop=self.clock)
        w = ReplicaWorker(wid, mode, engine, sv, self.clock,
                          sink=self._on_worker_event,
                          heartbeat=self.registry.heartbeat,
                          keep_alive=self._keep_alive,
                          heartbeat_s=self.policy.heartbeat_s)
        self.registry.register(w)
        return w

    def kill_worker(self, wid: int) -> None:
        """Simulate an abrupt crash: the engine halts and heartbeats
        stop.  Failover happens when the health tick detects the
        silence, ``heartbeat_timeout_s`` later — not instantly.
        Killing an unknown or already-dead worker is a no-op (fault
        plans may race a scripted crash against a real death)."""
        w = self.registry.workers.get(wid)
        if w is not None:
            w.kill()

    def next_rid(self) -> int:
        self._next_rid += 1
        return self._next_rid - 1

    # -- request intake -----------------------------------------------------

    def submit(self, r: Request,
               consumer: Optional[Callable] = None,
               notify: Optional[Callable[[], None]] = None
               ) -> RequestChannel:
        """Accept a request; returns its event channel.  ``consumer``
        makes delivery inline (no backpressure); otherwise events buffer
        for ``take()``/``drain()`` with ``notify`` poked per event."""
        if self._t0 is None:
            self._t0 = min(self.clock.now, r.arrival)
        self._next_rid = max(self._next_rid, r.rid + 1)
        ch = RequestChannel(r.rid, capacity=self.policy.stream_buffer,
                            resume_at=int(self.policy.stream_buffer
                                          * self.policy.resume_frac),
                            consumer=consumer, notify=notify,
                            on_pause=self._channel_pause,
                            on_resume=self._channel_resume)
        st = _RequestState(request=r, channel=ch,
                           orig_prefix=r.cached_prefix_len,
                           orig_prompt=r.prompt_len,
                           orig_max_new=r.max_new_tokens)
        self._live[r.rid] = st
        self._submitted += 1
        if self._idle:
            # ticks disarmed while the gateway sat idle; grant one grace
            # beat so the fleet is not declared dead for time that
            # passed with nothing to do
            self._idle = False
            self.registry.resume_ticks()
        self._admit(st)
        return ch

    def _admit(self, st: _RequestState) -> None:
        r = st.request
        healthy = self.registry.healthy()
        if not healthy:
            self._reject(st, "worker_lost")
            return
        verdict, fit, reason = self.admission.decide(
            r, [w.replica for w in healthy], self.clock.now)
        if verdict == "reject":
            self._reject(st, reason)
        elif verdict == "wait":
            rid = r.rid
            self.clock.after(self.admission.policy.retry_s,
                             lambda: self._readmit(rid))
        else:
            fitw = [self.registry.workers[rep.idx] for rep in fit
                    if rep.idx in self.registry.workers]
            self._dispatch(st, self._choose(r, fitw or healthy))

    def _readmit(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is not None and st.worker is None:
            self._admit(st)

    def _choose(self, r: Request,
                candidates: List[ReplicaWorker]) -> ReplicaWorker:
        if self.session_affinity and r.session_id is not None:
            home = self._session_home.get(r.session_id)
            for w in candidates:
                if w.wid == home:
                    return w
        idx = self.router.choose(r, [w.replica for w in candidates])
        w = candidates[idx]
        if self.session_affinity and r.session_id is not None:
            self._session_home[r.session_id] = w.wid
        return w

    def _dispatch(self, st: _RequestState, w: ReplicaWorker) -> None:
        st.worker = w
        w.submit(st.request)

    # -- event fan-in -------------------------------------------------------

    def add_wire_tap(self, fn: Callable) -> None:
        """Fault-injection hook on the worker→gateway event wire:
        ``fn(worker, event)`` returns the event (possibly mutated) to
        pass it on, or None to drop the line."""
        self._wire_taps.append(fn)

    def remove_wire_tap(self, fn: Callable) -> None:
        if fn in self._wire_taps:
            self._wire_taps.remove(fn)

    def _on_worker_event(self, w: ReplicaWorker, ev) -> None:
        st = self._live.get(ev.rid)
        if st is None or st.worker is not w:
            return                   # stale worker / already terminal
        for tap in list(self._wire_taps):
            ev = tap(w, ev)
            if ev is None:
                return               # injected wire drop
        if st.token_base:
            ev = self._rebase(st, ev)
        if st.channel.offer(ev):     # False => deduped replay
            self.stream.emit(ev)
            if isinstance(ev, TokenEvent):
                self._maybe_checkpoint(st, ev)
        if isinstance(ev, TERMINAL_EVENTS):
            self._finish(st)

    def _rebase(self, st: _RequestState, ev):
        """Translate a resumed clone's events into the request's
        absolute coordinates: the clone's token 0 is really token
        ``token_base``, and its (extended) prompt is really the original
        prompt plus the restored output prefix."""
        base = st.token_base
        if isinstance(ev, TokenEvent):
            return dataclasses.replace(ev, index=ev.index + base)
        if isinstance(ev, (FinishedEvent, RejectedEvent)):
            return dataclasses.replace(ev, output_len=ev.output_len + base,
                                       prompt_len=st.orig_prompt)
        return ev

    # -- KV checkpointing ---------------------------------------------------

    def _ckpt_seconds(self, kv_tokens: int) -> float:
        gbps = self.policy.checkpoint_gbps or self.serve.kv_transfer_gbps
        return kv_migration_seconds(self.cfg, kv_tokens, gbps)

    def _maybe_checkpoint(self, st: _RequestState, ev: TokenEvent) -> None:
        """Kick off an async KV snapshot every ``checkpoint_interval``
        delivered tokens.  The copy takes perfmodel transfer time; it
        only commits if the source worker is still alive when it ends —
        an in-flight copy dies with its worker (crash consistency)."""
        interval = self.policy.checkpoint_interval
        if interval <= 0 or st.ckpt_inflight:
            return
        g = ev.index + 1             # absolute tokens delivered so far
        if g % interval != 0:
            return
        w = st.worker
        if w is None or w.crashed:
            return
        rid = st.request.rid
        kv_tokens = st.orig_prompt + g - 1   # prompt KV + decode appends
        st.ckpt_inflight = True
        self.clock.after(
            self._ckpt_seconds(kv_tokens),
            lambda: self._commit_checkpoint(rid, w, g, kv_tokens))

    def _commit_checkpoint(self, rid: int, src: ReplicaWorker,
                           g: int, kv_tokens: int) -> None:
        st = self._live.get(rid)
        if st is not None:
            st.ckpt_inflight = False
        if st is None or st.worker is not src:
            return                   # finished / failed over mid-copy
        if src.crashed or src.state in (WorkerState.DEAD,
                                        WorkerState.RETIRED):
            return                   # source died mid-copy: not durable
        ok = self.checkpoints.put(KVCheckpoint(
            rid=rid, generated=g, kv_tokens=kv_tokens, t=self.clock.now))
        if ok:
            ev = PhaseEvent(rid, self.clock.now, "checkpoint")
            if st.channel.offer(ev):
                self.stream.emit(ev)

    def _reject(self, st: _RequestState, reason: str) -> None:
        r = st.request
        ev = RejectedEvent(rid=r.rid, t=self.clock.now, arrival=r.arrival,
                           prompt_len=r.prompt_len, reason=reason,
                           output_len=st.channel.next_index,
                           preemptions=r.preemptions,
                           slo_class=r.slo_class, retries=r.retries)
        st.channel.offer(ev)
        self.stream.emit(ev)
        self._finish(st)

    def _finish(self, st: _RequestState) -> None:
        rid = st.request.rid
        self._live.pop(rid, None)
        self._paused.discard(rid)
        self.replayed_tokens += st.channel.dup_tokens
        self.checkpoints.drop(rid)       # parked KV freed immediately
        st.resume_ckpt = None
        if st.worker is not None:
            st.worker.engine.kv.clear_restore(rid)

    # -- crash failover -----------------------------------------------------

    def _on_worker_death(self, w: ReplicaWorker) -> None:
        """Re-home every request that was on ``w`` when it died.  With a
        parked checkpoint the clone *resumes* (restored KV, bounded
        replay); otherwise it re-prefills from scratch.  Re-dispatch is
        delayed by the retry policy's backoff plus the snapshot restore
        transfer time."""
        for st in [s for s in self._live.values() if s.worker is w]:
            r = st.request
            if r in w.replica.assigned:
                w.replica.assigned.remove(r)
            if st.evicted:
                st.worker = None     # resume will route it fresh
                continue
            ckpt = self.checkpoints.get(r.rid)
            clone = self._clone_for_retry(st, ckpt)
            st.request = clone
            st.resume_ckpt = ckpt
            st.token_base = ckpt.generated if ckpt is not None else 0
            healthy = [x for x in self.registry.healthy()
                       if x.wid != w.wid]
            if clone.retries > self.retry.max_retries or not healthy:
                st.resume_ckpt = None
                self._reject(st, "worker_lost")
                continue
            if st.paused:
                st.evicted = True    # hold until the consumer drains
                st.worker = None
                continue
            st.worker = None
            delay = self.retry.delay(clone.retries)
            if ckpt is not None:
                delay += self._ckpt_seconds(ckpt.kv_tokens)
            rid = r.rid
            self.clock.after(delay, lambda rid=rid: self._redispatch(rid))

    def _redispatch(self, rid: int) -> None:
        """Backoff expired: place the failover clone on a healthy
        worker (health may have changed while we waited)."""
        st = self._live.get(rid)
        if st is None or st.worker is not None or st.paused or st.evicted:
            return
        healthy = self.registry.healthy()
        if not healthy:
            self._reject(st, "worker_lost")
            return
        self._dispatch_fresh(st, self._choose(st.request, healthy))

    def _dispatch_fresh(self, st: _RequestState, w: ReplicaWorker) -> None:
        """Dispatch after a failover/eviction gap: stage the pending
        checkpoint restore (if any) on the target's KV manager so its
        admission clamp skips prefill compute for the restored context."""
        ckpt, st.resume_ckpt = st.resume_ckpt, None
        if ckpt is not None:
            if getattr(w.engine.scheduler, "prefill_route", "join") \
                    == "join":
                w.engine.kv.stage_restore(st.request.rid, ckpt.kv_tokens)
            # transfer-route (disagg) targets re-prefill the extended
            # context instead: their prefill pool never holds restored
            # KV (same rule as the session cache) — still strictly
            # cheaper than re-decoding token by token
            self.resumes += 1
            ev = PhaseEvent(st.request.rid, self.clock.now, "resume")
            if st.channel.offer(ev):
                self.stream.emit(ev)
        self._dispatch(st, w)

    def _clone_for_retry(self, st: _RequestState,
                         ckpt: Optional[KVCheckpoint] = None) -> Request:
        """A fresh copy for re-submission.  Without a checkpoint,
        token/prefill progress resets (the new worker re-prefills from
        scratch; a session-affine target may shortcut via its parked
        prefix).  With one, the restored context becomes the clone's
        "prompt" (original prompt + ``generated`` output tokens — same
        shape as preemption's recompute-on-resume) and the token budget
        shrinks by what the snapshot already covers; the gateway rebases
        the clone's token indices by ``token_base`` so the channel's
        index dedupe bounds the visible replay to the tokens generated
        after the snapshot.  Identity and accounting carry over."""
        r = st.request
        if ckpt is None:
            c = Request(rid=r.rid, arrival=r.arrival,
                        prompt_len=st.orig_prompt,
                        max_new_tokens=st.orig_max_new,
                        slo_class=r.slo_class, session_id=r.session_id,
                        cached_prefix_len=st.orig_prefix)
        else:
            c = Request(rid=r.rid, arrival=r.arrival,
                        prompt_len=st.orig_prompt + ckpt.generated,
                        max_new_tokens=max(
                            st.orig_max_new - ckpt.generated, 1),
                        slo_class=r.slo_class, session_id=r.session_id,
                        cached_prefix_len=0)
        c.preemptions = r.preemptions
        c.truncated = r.truncated
        c.retries = r.retries + 1
        return c

    # -- client cancellation ------------------------------------------------

    def cancel(self, rid: int, reason: str = "client_cancel") -> bool:
        """Explicit client cancel / disconnect: emit the terminal
        ``CancelledEvent`` immediately, free the parked checkpoint, and
        reap the engine slot — no waiting out the slow-consumer eviction
        path.  Returns False when the request is not live (already
        terminal or never submitted)."""
        st = self._live.get(rid)
        if st is None:
            return False
        r = st.request
        w, evicted = st.worker, st.evicted
        ev = CancelledEvent(rid=rid, t=self.clock.now, arrival=r.arrival,
                            prompt_len=st.orig_prompt,
                            output_len=st.channel.next_index,
                            preemptions=r.preemptions,
                            slo_class=r.slo_class, retries=r.retries,
                            reason=reason)
        st.channel.offer(ev)
        self.stream.emit(ev)
        self.cancellations += 1
        self._finish(st)
        if w is not None and not evicted:
            self._reap(w, r)
        return True

    def _reap(self, w: ReplicaWorker, r: Request) -> None:
        """Free a cancelled request's engine slot, retrying while it is
        pinned inside an in-flight lane step.  Stops when the worker is
        gone (its KV died with it) or the request reached a terminal
        engine state on its own."""
        if w.crashed or w.state in (WorkerState.DEAD, WorkerState.RETIRED):
            return
        if r.state in (State.FINISHED, State.REJECTED):
            return
        if not w.evict(r):
            self.clock.after(self.policy.evict_retry_s,
                             lambda: self._reap(w, r))

    # -- slow-consumer backpressure -----------------------------------------

    def _channel_pause(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None or st.paused:
            return
        st.paused = True
        self._paused.add(rid)
        # deferred: pause fires from inside offer(), i.e. mid-engine-step
        # — mutating engine containers re-entrantly would corrupt the
        # very iteration that emitted the event
        self.clock.after(0, lambda: self._do_pause(rid))

    def _do_pause(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None or not st.paused or st.evicted:
            return
        w = st.worker
        if w is None or w.state is not WorkerState.UP:
            return                   # drain/death paths own it now
        if w.evict(st.request):
            st.evicted = True
            w.engine.kv.clear_restore(rid)   # unconsumed restore staging
        else:                        # pinned inside an in-flight step
            self.clock.after(self.policy.evict_retry_s,
                             lambda: self._do_pause(rid))

    def _channel_resume(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None or not st.paused:
            return
        st.paused = False
        self._paused.discard(rid)
        self.registry.resume_ticks()
        self.clock.after(0, lambda: self._do_resume(rid))

    def _do_resume(self, rid: int) -> None:
        st = self._live.get(rid)
        if st is None or st.paused or not st.evicted:
            return
        st.evicted = False
        w = st.worker
        if w is None or w.state is not WorkerState.UP:
            healthy = self.registry.healthy()
            if not healthy:
                self._reject(st, "worker_lost")
                return
            w = self._choose(st.request, healthy)
        self._dispatch_fresh(st, w)

    # -- drain / rolling upgrade --------------------------------------------

    def drain_worker(self, wid: int,
                     on_retired: Optional[Callable[[], None]] = None
                     ) -> None:
        """Stop routing to ``wid``, migrate its queued (KV-free) work to
        healthy peers, let in-flight decodes finish in place, then
        retire + deregister it.  ``on_retired`` fires once it is gone."""
        w = self.registry.workers[wid]
        w.start_drain()
        while True:
            targets = [x for x in self.registry.healthy() if x.wid != wid]
            if not targets:
                break
            cand = w.engine.migration_candidate()
            if cand is None or cand[1]:      # has_kv: finish in place
                break
            got = w.engine.evict_for_migration()
            if got is None:
                break
            r, _ = got
            if r in w.replica.assigned:
                w.replica.assigned.remove(r)
            self.migrations += 1
            st = self._live.get(r.rid)
            target = self._choose(r, targets)
            if st is not None and st.request is r:
                self._dispatch(st, target)
            else:
                target.submit(r)
        self._drain_tick(wid, on_retired)

    def _drain_tick(self, wid: int,
                    on_retired: Optional[Callable[[], None]]) -> None:
        w = self.registry.workers.get(wid)
        if w is None or w.state is not WorkerState.DRAINING:
            return
        busy = any(s.worker is w and not s.evicted
                   for s in self._live.values())
        if w.idle() and not busy:
            w.retire()
            self.registry.deregister(wid)
            if on_retired is not None:
                on_retired()
            return
        self.clock.after(self.policy.drain_check_s,
                         lambda: self._drain_tick(wid, on_retired))

    def rolling_upgrade(self,
                        on_done: Optional[Callable[[], None]] = None
                        ) -> None:
        """Replace every UP worker one at a time: add a fresh worker of
        the same mode, drain the old one, move on when it retires."""
        targets = [w.wid for w in self.registry.workers.values()
                   if w.state is WorkerState.UP]

        def step(i: int) -> None:
            if i >= len(targets):
                if on_done is not None:
                    on_done()
                return
            old = self.registry.workers[targets[i]]
            self.add_worker(old.mode, serve=old.replica.serve)
            self.drain_worker(old.wid, on_retired=lambda: step(i + 1))

        step(0)

    # -- liveness (simulated clock) -----------------------------------------

    def _keep_alive(self) -> bool:
        """Whether periodic ticks should re-arm.  On the real clock,
        always; on the virtual clock only while work is pending —
        otherwise ``EventLoop.run()`` would never drain its heap."""
        if not self.clock.virtual:
            return True
        if self._submitted < self._expected:
            return True
        alive = len(self._live) - len(self._paused) > 0
        if not alive:
            self._idle = True
        return alive

    def serve_trace(self, requests) -> tuple:
        """Drive a full trace on the simulated clock; returns
        ``(records, span_s)``.  Each request gets an inline discard
        consumer (no backpressure) — churn tests that want buffered
        channels submit requests themselves."""
        self._expected += len(requests)
        for r in requests:
            self.clock.at(r.arrival, lambda r=r: self.submit(
                r, consumer=lambda ev: None))
        self.clock.run()
        return self.metrics.records, self.span()

    # -- observability ------------------------------------------------------

    def span(self) -> float:
        t0 = self._t0 if self._t0 is not None else self.clock.now
        return max(self.clock.now - t0, 1e-9)

    def health(self) -> Dict[str, object]:
        workers = {w.name: w.state.value
                   for w in self.registry.workers.values()}
        return {"status": "ok" if self.registry.healthy() else "degraded",
                "workers": workers,
                "live_requests": len(self._live),
                "paused_streams": len(self._paused)}

    def metrics_summary(self) -> Dict[str, object]:
        per = {w.name: [RequestRecord.from_request(r)
                        for r in w.replica.assigned]
               for w in self.registry.workers.values()
               if w.state is not WorkerState.DEAD}
        summary = fleet_summarize(per, self.serve.slo, self.span(),
                                  fleet_records=self.metrics.records,
                                  loop_stats=self.clock.stats)
        summary["fleet"]["migrations"] = self.migrations
        summary["fleet"]["checkpoints"] = self.checkpoints.taken
        summary["fleet"]["resumes"] = self.resumes
        summary["fleet"]["replayed_tokens"] = self.replayed_tokens
        summary["fleet"]["cancelled"] = self.cancellations
        summary["fleet"]["fenced_beats"] = self.registry.fenced_beats
        summary["admission"] = dict(self.admission.stats)
        return summary
