"""Order-preserving indexed request queues with incremental accounting.

The first engines kept requests in plain ``deque``/``list`` containers, so
every hot-path transition paid O(n): ``remove()`` on admission/launch,
``in`` membership checks in the decode loop, and — worst of all —
``Engine.load_snapshot()`` re-summing every queue's lengths, prompt
tokens and KV-page claims on every router/admission/autoscaler call.
``IndexedQueue`` replaces all of those with O(1) operations:

  * **order-preserving** — iteration yields requests in FIFO insertion
    order; ``appendleft`` (preemption re-queue) goes to the front;
    ``remove`` preserves the order of everything else.  Backed by an
    ``OrderedDict`` keyed on ``Request.rid`` (unique per engine).
  * **O(1) everything** — append / appendleft / pop / popleft / remove /
    ``in`` / ``len`` / front-and-back peeks.
  * **incremental aggregates** — the quantities ``load_snapshot()``
    needs are maintained at add/remove time instead of recomputed:

      ``len(q)``                   request count
      ``q.prompt_tokens``          sum of members' ``prompt_len``
      ``q.pending_prefill_tokens`` sum of ``prefill_tokens_needed -
                                   prefill_tokens_done`` (session-cached
                                   prefix tokens never need compute)
      ``q.kv_pages``               sum of ``kv_pages_for(prompt_len, page)``
      ``q.ctx_tokens``             sum of members' ``context_len``

Each member's contribution is *snapshotted at add time* and stored next
to the request; ``remove`` subtracts exactly what was added (plus any
``note_*`` adjustments), so in-place ``Request`` mutation can never skew
an aggregate.  The two fields that legitimately change while a request
sits in a container have explicit notification hooks the engine calls:

  * ``note_chunk_progress(r, take)`` — hybrid chunked prefill advanced
    ``prefill_tokens_done`` by ``take`` while ``r`` waits in ``chunking``;
  * ``note_token(r)`` — a decode step appended one token to a *running*
    request (keeps ``ctx_tokens`` live for the running batch).

``tests/test_load_accounting.py`` pins the aggregates against
hand-computed values; the hypothesis property suite asserts
``Engine.load_snapshot() == Engine.load_snapshot_recompute()`` after
arbitrary enqueue/admit/preempt/migrate/finish sequences.
"""
from __future__ import annotations

import collections
from typing import Iterator, List, Optional

from repro_torch.core.request import Request
from repro_torch.kvcache import kv_pages_for


class IndexedQueue:
    """O(1) ordered request container (see module docstring)."""

    __slots__ = ("page_size", "_entries", "prompt_tokens",
                 "pending_prefill_tokens", "kv_pages", "ctx_tokens")

    # entry layout: [request, pending_contrib, ctx_contrib]
    _REQ, _PEND, _CTX = 0, 1, 2

    def __init__(self, page_size: int = 1,
                 items: Optional[List[Request]] = None):
        self.page_size = page_size
        self._entries: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self.prompt_tokens = 0
        self.pending_prefill_tokens = 0
        self.kv_pages = 0
        self.ctx_tokens = 0
        for r in items or ():
            self.append(r)

    # -- membership transitions ---------------------------------------------
    def _add(self, r: Request) -> list:
        if r.rid in self._entries:
            raise ValueError(f"request {r.rid} already queued")
        pend = r.prompt_len - r.cached_prefix_len - r.prefill_tokens_done
        ctx = r.context_len
        self._entries[r.rid] = entry = [r, pend, ctx]
        self.prompt_tokens += r.prompt_len
        self.pending_prefill_tokens += pend
        self.kv_pages += kv_pages_for(r.prompt_len, self.page_size)
        self.ctx_tokens += ctx
        return entry

    def append(self, r: Request) -> None:
        self._add(r)

    def appendleft(self, r: Request) -> None:
        self._add(r)
        self._entries.move_to_end(r.rid, last=False)

    def _subtract(self, entry: list) -> Request:
        r = entry[self._REQ]
        self.prompt_tokens -= r.prompt_len
        self.pending_prefill_tokens -= entry[self._PEND]
        self.kv_pages -= kv_pages_for(r.prompt_len, self.page_size)
        self.ctx_tokens -= entry[self._CTX]
        return r

    def remove(self, r: Request) -> None:
        entry = self._entries.get(r.rid)
        if entry is None or entry[self._REQ] is not r:
            raise ValueError(f"request {r.rid} not in queue")
        del self._entries[r.rid]
        self._subtract(entry)

    def pop(self) -> Request:
        _, entry = self._entries.popitem(last=True)
        return self._subtract(entry)

    def popleft(self) -> Request:
        _, entry = self._entries.popitem(last=False)
        return self._subtract(entry)

    # -- in-place mutation hooks --------------------------------------------
    def note_chunk_progress(self, r: Request, take: int) -> None:
        """``r.prefill_tokens_done`` advanced by ``take`` while queued."""
        self._entries[r.rid][self._PEND] -= take
        self.pending_prefill_tokens -= take

    def note_token(self, r: Request, n: int = 1) -> None:
        """``r`` generated ``n`` tokens while a member (running batch)."""
        self._entries[r.rid][self._CTX] += n
        self.ctx_tokens += n

    # -- views ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __bool__(self) -> bool:
        return bool(self._entries)

    def __contains__(self, r) -> bool:
        entry = self._entries.get(getattr(r, "rid", None))
        return entry is not None and entry[self._REQ] is r

    def __iter__(self) -> Iterator[Request]:
        for entry in self._entries.values():
            yield entry[self._REQ]

    def __getitem__(self, i: int) -> Request:
        """O(1) front/back peeks (the engine only ever peeks the ends);
        other indices fall back to an O(n) walk."""
        n = len(self._entries)
        if not n:
            raise IndexError("peek of empty IndexedQueue")
        if i == 0:
            key = next(iter(self._entries))
        elif i == -1 or i == n - 1:
            key = next(reversed(self._entries))
        else:
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(i)
            key = list(self._entries)[i]
        return self._entries[key][self._REQ]

    def __repr__(self) -> str:
        return (f"IndexedQueue(len={len(self)}, "
                f"prompt_tokens={self.prompt_tokens}, "
                f"kv_pages={self.kv_pages})")
