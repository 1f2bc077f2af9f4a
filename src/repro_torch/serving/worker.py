"""Per-replica engine worker for the serving gateway.

A ``ReplicaWorker`` owns one ``Engine`` wrapped in the cluster-layer
``Replica`` record (so the router zoo, admission controller and metrics
all see the shape they already know), forwards the engine's typed event
stream (core/events.py) to the gateway, and sends periodic heartbeats
through the shared clock.  The gateway's registry declares a worker dead
when its heartbeats stop — which is exactly what ``kill()`` does, so a
simulated crash and a real hung process take the same code path.

Lifecycle::

    UP ──start_drain()──▶ DRAINING ──retire()──▶ RETIRED
     └──kill()/timeout──▶ DEAD

``kill()`` models an abrupt crash: the engine is halted in place (its
scheduler is swapped for one that plans nothing; in-flight lane
completions drain harmlessly), heartbeats stop, and every event the
crashed engine still emits is dropped at the forwarding boundary — the
gateway never sees tokens from a zombie.  Crucially ``kill()`` does NOT
flip ``state`` — the worker has crashed but nobody *knows* yet; the
registry's health tick notices the missing heartbeats after
``heartbeat_timeout_s`` and calls ``mark_dead()``, which is when
failover runs.  Recovery is the *gateway's* job (serving/gateway.py
re-submits clones elsewhere); the worker only guarantees the crash is
contained.
"""
from __future__ import annotations

import enum
from typing import Callable

from repro_torch.core.request import Request
from repro_torch.serving.cluster import Replica
from repro_torch.core.queues import IndexedQueue


class WorkerState(enum.Enum):
    UP = "up"
    DRAINING = "draining"   # no new work; finishing what it has
    DEAD = "dead"           # crashed / heartbeat timeout
    RETIRED = "retired"     # drained clean and deregistered


class ReplicaWorker:
    """One engine + its gateway-facing plumbing.

    ``sink(worker, event)`` receives every live engine event (the
    gateway fans these into per-request channels and its fleet metrics
    stream).  Heartbeats are scheduled through ``clock`` and re-armed
    only while ``keep_alive()`` is true, so a simulated run terminates
    once no request remains in flight.
    """

    def __init__(self, wid: int, mode: str, engine, serve,
                 clock, sink: Callable, heartbeat: Callable[[int], None],
                 keep_alive: Callable[[], bool],
                 heartbeat_s: float = 0.5):
        self.wid = wid
        self.state = WorkerState.UP
        self.clock = clock
        self.replica = Replica(idx=wid, mode=mode, engine=engine,
                               serve=serve, assigned=IndexedQueue(
                                   serve.page_size))
        self._sink = sink
        self._heartbeat = heartbeat
        self._keep_alive = keep_alive
        self.heartbeat_s = heartbeat_s
        self._beat_armed = False
        self.crashed = False         # ground truth; state lags detection
        self.death_handled = False   # gateway's failover-ran-once latch
        self._suppressed_beats = 0   # fault injection: heartbeat flap
        engine.subscribe(self._forward)

    # -- identity / views ---------------------------------------------------

    @property
    def mode(self) -> str:
        return self.replica.mode

    @property
    def name(self) -> str:
        return f"{self.replica.mode}-{self.wid}"

    @property
    def engine(self):
        return self.replica.engine

    def idle(self) -> bool:
        """Nothing queued, running, or mid-step on any lane."""
        eng = self.engine
        return (len(eng.running) == 0
                and all(len(q) == 0 for q in eng.queues.values())
                and not eng.prefill_busy and not eng.decode_busy
                and not eng.busy)

    # -- event forwarding ---------------------------------------------------

    def _forward(self, ev) -> None:
        # a crashed engine's in-flight lane completions may still emit;
        # drop them here so the gateway never streams zombie tokens
        if self.crashed or self.state is WorkerState.DEAD:
            return
        self._sink(self, ev)

    # -- request plumbing ---------------------------------------------------

    def submit(self, r: Request) -> None:
        self.replica.assigned.append(r)
        self.engine.submit(r)

    def evict(self, r: Request) -> bool:
        """Targeted removal (slow-consumer backpressure).  False when the
        request is pinned inside an in-flight lane step — the caller
        retries after the step completes."""
        ok = self.engine.evict_request(r)
        if ok and r in self.replica.assigned:
            self.replica.assigned.remove(r)
        return ok

    # -- lifecycle ----------------------------------------------------------

    def kill(self) -> None:
        """Abrupt crash: halt the engine and go silent.  ``state`` is
        NOT flipped — detection (and failover) waits for the registry's
        heartbeat timeout, like a real hung process."""
        if self.crashed or self.state in (WorkerState.DEAD,
                                          WorkerState.RETIRED):
            return
        self.crashed = True
        self.engine.halt()

    def mark_dead(self) -> None:
        """Registry verdict after missed heartbeats: the worker is gone
        for routing purposes and the gateway's failover may run."""
        if self.state in (WorkerState.DEAD, WorkerState.RETIRED):
            return
        self.crashed = True
        self.state = WorkerState.DEAD
        self.replica.routable = False
        self.engine.halt()

    def start_drain(self) -> None:
        """Stop accepting new work; existing requests run to completion
        (the gateway migrates what it can to other workers first)."""
        if self.state is WorkerState.UP:
            self.state = WorkerState.DRAINING
            self.replica.routable = False

    def retire(self) -> None:
        if self.state is WorkerState.DRAINING:
            self.state = WorkerState.RETIRED

    # -- heartbeats ---------------------------------------------------------

    def ensure_beat(self) -> None:
        """Arm the periodic heartbeat if it is not already scheduled."""
        if not self._beat_armed:
            self._beat_armed = True
            self.clock.after(self.heartbeat_s, self._beat)

    def suppress_beats(self, n: int) -> None:
        """Fault injection: swallow the next ``n`` heartbeats while the
        worker keeps running (GC pause / network flap).  If ``n *
        heartbeat_s`` stays under the registry's ``heartbeat_timeout_s``
        the flap must be invisible — no failover (pinned in
        tests/test_gateway_churn.py)."""
        self._suppressed_beats = max(self._suppressed_beats, n)

    def _beat(self) -> None:
        self._beat_armed = False
        if self.crashed or self.state in (WorkerState.DEAD,
                                          WorkerState.RETIRED):
            return                      # crashed workers fall silent
        if self._suppressed_beats > 0:
            self._suppressed_beats -= 1     # flapping: alive but silent
        else:
            self._heartbeat(self.wid)
        if self._keep_alive():
            self.ensure_beat()
