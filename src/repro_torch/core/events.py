"""Typed request-lifecycle event stream (Serving API v2).

Engines emit a stream of small frozen event records as requests move
through the system; callers *subscribe* instead of scraping
``records()`` after the fact:

  * ``TokenEvent``    — one generated token (``index`` is 0-based; the
    first token of a request is the one produced by prefill).
  * ``PhaseEvent``    — a lifecycle transition: ``queued`` (arrival),
    ``kv_allocated`` (decode-side block allocation, paper Fig 4),
    ``prefill`` (prefill step started), ``transfer`` (disagg KV transfer
    started), ``decode`` (joined the decode batch), ``preempted``.
  * ``FinishedEvent`` — terminal success; carries enough metadata
    (arrival, prompt_len, output_len, preemptions) that consumers can
    build a full ``RequestRecord`` from the stream alone.
  * ``RejectedEvent`` — terminal admission failure.

Every request ends with exactly one ``FinishedEvent`` or
``RejectedEvent``; its ``TokenEvent`` times are monotone and count
exactly ``max_new_tokens`` on success (asserted in tests/test_events.py).
The gateway layer adds a third terminal, ``CancelledEvent``, for client
cancellation/disconnect — engines themselves never emit it.

The stream is also the serving gateway's **wire format**: each event
maps to one JSON line (``event_to_json`` / ``event_from_json``) with a
``type`` discriminator, and the mapping round-trips bit-identically —
``json`` serializes floats via ``repr``, which Python guarantees parses
back to the same float (tests/test_event_wire.py pins this over
engine-generated traces).

``EventStream`` is a synchronous pub/sub hub with a replay log: under
the virtual clock "streaming" means subscribers run inline at emission
time (same ``loop.now``), and ``events()`` returns everything emitted so
far for post-hoc consumers.

Hot-path notes (the stream sits on every token of every request): the
event records are ``slots=True`` frozen dataclasses (no per-instance
``__dict__``), ``emit`` skips the per-rid fanout dict entirely while no
per-rid subscriber exists (the overwhelmingly common case), and
``events()`` amortizes its immutable replay view — the tuple is rebuilt
only when something was emitted since the last call, so polling
consumers stop paying a full copy per read.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union


@dataclasses.dataclass(frozen=True, slots=True)
class TokenEvent:
    rid: int
    t: float
    index: int          # 0-based position in the request's output


@dataclasses.dataclass(frozen=True, slots=True)
class PhaseEvent:
    rid: int
    t: float
    phase: str          # queued|kv_allocated|prefill|transfer|decode|preempted


@dataclasses.dataclass(frozen=True, slots=True)
class FinishedEvent:
    """Terminal success.  ``retries`` counts gateway-level failovers
    (the request was re-submitted to another worker after its replica
    crashed); ``truncated`` means admission capped ``max_new_tokens`` so
    prompt+output fits a colocated pool (``output_len`` is the capped
    count)."""
    rid: int
    t: float
    arrival: float
    prompt_len: int
    output_len: int
    preemptions: int = 0
    slo_class: str = "interactive"
    retries: int = 0
    truncated: bool = False


@dataclasses.dataclass(frozen=True, slots=True)
class RejectedEvent:
    """Terminal admission failure.  ``reason`` is one of

      * ``never_fits``  — prompt (+ worst-case output, disagg) can never
        fit the pool, no amount of waiting helps;
      * ``kv_headroom`` — pools are full now and the cluster-side wait
        deadline expired;
      * ``class_shed``  — class-aware admission shed a lower-importance
        class to protect interactive headroom;
      * ``worker_lost`` — the gateway exhausted its failover retries (or
        had no healthy worker left) after replica crashes.
    """
    rid: int
    t: float
    arrival: float
    prompt_len: int
    reason: str = "never_fits"
    output_len: int = 0
    preemptions: int = 0
    slo_class: str = "interactive"
    retries: int = 0


@dataclasses.dataclass(frozen=True, slots=True)
class CancelledEvent:
    """Terminal client-side cancellation (explicit ``cancel(rid)`` or a
    mid-stream disconnect).  ``output_len`` is the number of tokens the
    client actually received before cancelling; ``reason`` is
    ``client_cancel`` or ``disconnect``."""
    rid: int
    t: float
    arrival: float
    prompt_len: int
    output_len: int = 0
    preemptions: int = 0
    slo_class: str = "interactive"
    retries: int = 0
    reason: str = "client_cancel"


Event = Union[TokenEvent, PhaseEvent, FinishedEvent, RejectedEvent,
              CancelledEvent]

TERMINAL_EVENTS = (FinishedEvent, RejectedEvent, CancelledEvent)


# ---------------------------------------------------------------------------
# Wire format (serving gateway): one JSON line per event
# ---------------------------------------------------------------------------

WIRE_TYPES: Dict[str, type] = {
    "token": TokenEvent,
    "phase": PhaseEvent,
    "finished": FinishedEvent,
    "rejected": RejectedEvent,
    "cancelled": CancelledEvent,
}
_WIRE_TAGS: Dict[type, str] = {cls: tag for tag, cls in WIRE_TYPES.items()}


def event_to_wire(ev: Event) -> Dict[str, object]:
    """Event -> plain dict with a ``type`` discriminator."""
    d: Dict[str, object] = {"type": _WIRE_TAGS[type(ev)]}
    for f in dataclasses.fields(ev):
        d[f.name] = getattr(ev, f.name)
    return d


def event_from_wire(d: Mapping[str, object]) -> Event:
    """Inverse of ``event_to_wire``; raises ``ValueError`` on unknown or
    missing ``type`` tags (a malformed wire line must not surface as a
    ``KeyError`` deep in a stream consumer)."""
    kw = dict(d)
    tag = kw.pop("type", None)
    cls = WIRE_TYPES.get(tag)
    if cls is None:
        raise ValueError(f"unknown wire event type {tag!r}")
    try:
        return cls(**kw)
    except TypeError as e:
        raise ValueError(f"bad wire fields for {tag!r}: {e}") from None


def event_to_json(ev: Event) -> str:
    """One JSON line (no trailing newline).  Floats serialize via
    ``repr`` so decode returns the identical value."""
    return json.dumps(event_to_wire(ev), separators=(",", ":"))


def event_from_json(line: str) -> Event:
    try:
        d = json.loads(line)
    except json.JSONDecodeError as e:
        raise ValueError(f"bad wire line: {e}") from None
    if not isinstance(d, dict):
        raise ValueError(f"bad wire line: expected object, got {type(d)}")
    return event_from_wire(d)


class EventStream:
    """Synchronous pub/sub with a replay log.

    ``subscribe(fn)`` registers a global consumer; ``subscribe(fn,
    rid=...)`` a per-request one (only that request's events).  Consumers
    are plain callables invoked inline at emission time — on the virtual
    clock that is "streaming".  ``events()`` returns the replay log.
    """

    def __init__(self):
        self._log: List[Event] = []
        self._subs: List[Callable[[Event], None]] = []
        self._per_rid: Dict[int, List[Callable[[Event], None]]] = {}
        self._view: Tuple[Event, ...] = ()   # cached replay tuple

    def emit(self, ev: Event) -> None:
        self._log.append(ev)
        for fn in self._subs:
            fn(ev)
        if self._per_rid:                    # skip fanout dict when empty
            for fn in self._per_rid.get(ev.rid, ()):
                fn(ev)

    def subscribe(self, fn: Callable[[Event], None],
                  rid: Optional[int] = None) -> Callable[[Event], None]:
        """Register ``fn``; returns it so callers can unsubscribe."""
        if rid is None:
            self._subs.append(fn)
        else:
            self._per_rid.setdefault(rid, []).append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[Event], None],
                    rid: Optional[int] = None) -> None:
        if rid is None:
            self._subs.remove(fn)
        else:
            self._per_rid[rid].remove(fn)
            if not self._per_rid[rid]:       # keep the empty-dict fast path
                del self._per_rid[rid]

    def events(self) -> Tuple[Event, ...]:
        """Immutable replay log.  Amortized: the tuple is only rebuilt
        when events were emitted since the previous call, so interleaved
        emit/read patterns cost O(new events), not O(log) per read."""
        if len(self._view) != len(self._log):
            self._view = tuple(self._log)
        return self._view

    def __len__(self) -> int:
        return len(self._log)
