"""Clock abstraction for the serving gateway.

The gateway (serving/gateway.py) schedules everything — heartbeats,
health checks, admission retries, failover re-dispatch — through a
*clock* object instead of calling asyncio directly, so the same code
runs in two modes:

  * simulated: the existing ``serving.sim.EventLoop``.  ``run()``
    drains the heap deterministically; churn tests (worker crash
    mid-decode, rolling-upgrade drain, slow consumers) execute in CI
    without sockets, sleeps, or flaky wall-clock timing.
  * real time: ``RealTimeClock`` below, a thin adapter over an asyncio
    event loop for the HTTP server (serving/http.py).

Clock protocol (duck-typed; both implementations provide it):

  ``now``          current time in seconds (attribute or property)
  ``at(t, fn)``    run ``fn()`` at absolute time ``t`` (clamped to now)
  ``after(dt, fn)``run ``fn()`` after ``dt`` seconds
  ``virtual``      True when time only advances by draining scheduled
                   events.  Periodic tasks (heartbeats, health ticks)
                   must gate their re-arming on pending work when this
                   is set, or the simulated loop never goes idle.
  ``stats``        ``LoopStats``-compatible counters for /metrics.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.serving.sim import EventLoop, LoopStats

__all__ = ["EventLoop", "RealTimeClock"]


class RealTimeClock:
    """Clock over an asyncio event loop (``loop.time()`` timebase).

    Construction is loop-free so a gateway (whose constructor already
    arms worker heartbeats) can be built before asyncio starts;
    ``bind()`` attaches the running loop and flushes anything scheduled
    in the meantime — pre-bind delays are measured from bind time,
    which is when serving actually begins.

    ``now`` counts seconds *since bind* (0.0 before), not raw
    ``loop.time()``: timestamps recorded pre-bind (worker ``last_beat``
    at registration, request arrivals) must stay comparable after the
    loop attaches, or every worker looks heartbeat-timed-out the
    instant serving starts.
    """

    virtual = False

    def __init__(self):
        self._loop = None
        self._t0 = 0.0               # loop.time() at bind
        self._pending: list = []     # (dt, fn) queued before bind()
        self.stats = LoopStats()

    def bind(self, loop) -> None:
        self._loop = loop
        self._t0 = loop.time()
        pending, self._pending = self._pending, []
        for dt, fn in pending:
            self.after(dt, fn)

    @property
    def now(self) -> float:
        if self._loop is None:
            return 0.0
        return self._loop.time() - self._t0

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if self._loop is None:
            self._pending.append((max(t, 0.0), fn))
            return
        if t < self.now:
            t = self.now
            self.stats.clamped += 1
        self.stats.dispatched += 1
        self._loop.call_at(t + self._t0, fn)

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        if self._loop is None:
            self._pending.append((max(dt, 0.0), fn))
            return
        if dt < 0:
            dt = 0.0
            self.stats.clamped += 1
        self.stats.dispatched += 1
        self._loop.call_later(dt, fn)
