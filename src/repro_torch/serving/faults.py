"""Deterministic fault injection for the serving gateway.

Everything here is scripted against the gateway's *clock* (virtual
``EventLoop`` in CI, ``RealTimeClock`` in a live deployment), so an
arbitrary fault schedule replays bit-identically: a ``FaultPlan`` is a
frozen list of ``Fault`` records, and ``FaultInjector.arm()`` schedules
each one at its tick.  Supported fault kinds:

  * ``crash``   — abrupt worker crash at tick ``t`` (``kill_worker``:
    engine halts, heartbeats stop; detection waits for the registry's
    heartbeat timeout, like a real hung process).
  * ``restart`` — a *fresh* worker of mode ``mode`` joins at ``t``
    (capacity recovery; a fenced dead worker can never rejoin as
    itself — see ``WorkerRegistry.heartbeat``).
  * ``flap``    — worker misses its next ``count`` heartbeats but keeps
    running (GC pause / transient partition).  Under the timeout it must
    be invisible; over it, the worker is declared dead and *fenced*.
  * ``drop`` / ``corrupt`` — lossy worker→gateway event wire: the next
    ``count`` token lines for ``rid`` (any rid when ``rid < 0``) are
    dropped, or corrupted so they fail the channel's index check.  Only
    **token** lines are lossy — terminal events ride the reliable
    control channel, otherwise a dropped terminal would leak the
    request forever (the exactly-once-termination property would be
    meaningless).
  * ``stall``   — the request's consumer wedges for ``duration``
    seconds: its channel buffers (even inline consumers), engaging the
    gateway's real slow-consumer backpressure/eviction machinery.

``RetryPolicy`` is the bounded failover policy the gateway consults on
worker death: at most ``max_retries`` re-dispatches per request, each
delayed by truncated exponential backoff (thundering-herd control when
a crash orphans a whole batch at once).
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.events import TokenEvent

FAULT_KINDS = ("crash", "restart", "flap", "drop", "corrupt", "stall")


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded failover retries with truncated exponential backoff.

    ``delay(n)`` is the pause before the ``n``-th re-dispatch (n >= 1):
    ``backoff_base_s * backoff_mult**(n-1)``, capped at
    ``backoff_max_s``.  The gateway adds the checkpoint-restore
    transfer time on top when resuming from a snapshot."""
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0

    def delay(self, retries: int) -> float:
        if retries <= 0:
            return 0.0
        return min(self.backoff_base_s * self.backoff_mult ** (retries - 1),
                   self.backoff_max_s)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scripted fault.  Field use by kind:

    crash/flap: ``wid`` (flap also ``count`` = beats missed);
    restart: ``mode`` (worker mode to add);
    drop/corrupt: ``rid`` (-1 = any), ``count`` = token lines affected;
    stall: ``rid``, ``duration`` seconds."""
    kind: str
    t: float
    wid: int = -1
    rid: int = -1
    count: int = 1
    duration: float = 0.0
    mode: str = "rapid"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, replayable fault schedule."""
    faults: Tuple[Fault, ...] = ()

    def __iter__(self):
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def crash_storm(cls, seed: int, workers: int, t0: float, t1: float,
                    crashes: int, restart_after: float = 2.0,
                    mode: str = "rapid") -> "FaultPlan":
        """A deterministic storm: ``crashes`` worker kills at uniform
        random ticks in [t0, t1), each followed by a fresh replacement
        worker ``restart_after`` seconds later (so fleet capacity
        recovers and survivors exist for failover).  Same seed, same
        storm — the two arms of benchmarks/fig17_recovery.py replay the
        identical schedule."""
        rng = random.Random(seed)
        faults: List[Fault] = []
        for _ in range(crashes):
            t = rng.uniform(t0, t1)
            wid = rng.randrange(workers)
            faults.append(Fault(kind="crash", t=t, wid=wid))
            faults.append(Fault(kind="restart", t=t + restart_after,
                                mode=mode))
        faults.sort(key=lambda f: f.t)
        return cls(tuple(faults))


class FaultInjector:
    """Arms a ``FaultPlan`` against a gateway's clock.

    One injector owns one wire tap on the gateway (installed lazily,
    removed never — an exhausted tap passes everything through), plus
    per-fault scheduled callbacks.  ``injected`` counts fired faults by
    kind; ``dropped_lines`` / ``corrupted_lines`` count affected wire
    lines."""

    def __init__(self, gateway, plan: FaultPlan):
        self.gw = gateway
        self.plan = plan
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.dropped_lines = 0
        self.corrupted_lines = 0
        # pending wire faults: list of [rid, remaining, corrupt?]
        self._wire_budget: List[List] = []
        self._tap_installed = False

    def arm(self) -> "FaultInjector":
        for f in self.plan:
            self.gw.clock.at(f.t, lambda f=f: self._fire(f))
        return self

    # -- firing --------------------------------------------------------------

    def _fire(self, f: Fault) -> None:
        self.injected[f.kind] += 1
        if f.kind == "crash":
            self.gw.kill_worker(f.wid)
        elif f.kind == "restart":
            self.gw.add_worker(f.mode)
        elif f.kind == "flap":
            w = self.gw.registry.workers.get(f.wid)
            if w is not None:
                w.suppress_beats(f.count)
        elif f.kind in ("drop", "corrupt"):
            self._ensure_tap()
            self._wire_budget.append([f.rid, f.count, f.kind == "corrupt"])
        elif f.kind == "stall":
            st = self.gw._live.get(f.rid)
            if st is None:
                return
            ch = st.channel
            ch.stall()
            self.gw.clock.after(f.duration, ch.unstall)

    # -- wire tap ------------------------------------------------------------

    def _ensure_tap(self) -> None:
        if not self._tap_installed:
            self._tap_installed = True
            self.gw.add_wire_tap(self._tap)

    def _tap(self, worker, ev):
        # only token lines are lossy (see module docstring)
        if not isinstance(ev, TokenEvent):
            return ev
        for entry in self._wire_budget:
            rid, remaining, corrupt = entry
            if remaining <= 0 or (rid >= 0 and rid != ev.rid):
                continue
            entry[1] -= 1
            if corrupt:
                # mangled index: fails the channel's contiguity check,
                # so the line is counted and discarded downstream
                self.corrupted_lines += 1
                return dataclasses.replace(ev, index=-(ev.index + 1))
            self.dropped_lines += 1
            return None
        return ev


def line_corruptor(rng: Optional[random.Random] = None,
                   rate: float = 0.0):
    """An NDJSON wire-line hook for the HTTP server: flips a byte in a
    fraction ``rate`` of outgoing lines (deterministic under a seeded
    ``rng``).  Returns the (possibly mangled) line — consumers must
    treat a non-parsing line as loss, not crash (event_from_json raises
    ``ValueError``, which the client-side reader skips)."""
    rng = rng if rng is not None else random.Random(0)

    def hook(line: bytes) -> bytes:
        if rate > 0.0 and line and rng.random() < rate:
            i = rng.randrange(len(line))
            return line[:i] + bytes([line[i] ^ 0x20]) + line[i + 1:]
        return line

    return hook
