"""Virtual-clock discrete-event loop.

The serving engines are real control-flow code (queues, block allocation,
scheduling decisions); only *durations* come from the perfmodel.  The loop
is a plain heapq of (time, seq, callback) — engines schedule their own
step completions; arrivals are seeded up front from a trace.

``EventLoop.stats`` tracks loop health so consumers (notably
``benchmarks/bench_hotpath.py``) can report it: events dispatched,
past-due schedules clamped to ``now`` (``at()`` silently snapped these
with no record before these stats), and the peak heap size.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Optional


@dataclasses.dataclass
class LoopStats:
    """Event-loop health counters (reset with the loop, never cleared).

    ``clamped`` counts ``at()`` calls whose target time was already in
    the past (beyond float tolerance) and were snapped to ``now`` — a
    persistent non-zero rate means some component schedules against a
    stale clock.  ``peak_heap`` is the high-water mark of pending
    events."""
    dispatched: int = 0
    clamped: int = 0
    peak_heap: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class EventLoop:
    # Clock-protocol flag (see serving/clock.py): virtual clocks advance
    # by draining the heap; gateway periodic ticks must stop re-arming
    # when idle or run() would never return.
    virtual = True

    def __init__(self):
        self._heap = []
        self._seq = itertools.count()
        self.now = 0.0
        self.stats = LoopStats()

    def at(self, t: float, fn: Callable[[], None]) -> None:
        if t < self.now - 1e-12:
            t = self.now
            self.stats.clamped += 1
        heapq.heappush(self._heap, (t, next(self._seq), fn))
        if len(self._heap) > self.stats.peak_heap:
            self.stats.peak_heap = len(self._heap)

    def after(self, dt: float, fn: Callable[[], None]) -> None:
        self.at(self.now + dt, fn)

    def run(self, until: Optional[float] = None,
            max_events: int = 50_000_000) -> None:
        n = 0
        stats = self.stats
        while self._heap and n < max_events:
            # peek before popping: an event past the horizon must stay on
            # the heap so a resumed run() still delivers it
            if until is not None and self._heap[0][0] > until:
                self.now = until
                return
            t, _, fn = heapq.heappop(self._heap)
            self.now = t
            fn()
            n += 1
            stats.dispatched += 1
        if n >= max_events:
            raise RuntimeError("event budget exceeded (runaway sim?)")
        if until is not None and until > self.now:
            self.now = until
