"""Request lifecycle — the queue states of paper Fig 4.

A request is directed simultaneously to both the prefill and decode sides:
  decode side : WAITING_KV -> (blocks allocated) -> notifies prefill
  prefill side: PENDING_KV -> WAITING_PREFILL -> PREFILLING -> done
  decode side : PREFILL_FINISHED -> DECODING -> FINISHED

Timestamps are recorded at every transition; TTFT/ITL metrics derive from
``token_times`` (token 1 is produced by the prefill step).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


# Multi-tenant SLO classes, ordered by importance.  Lower rank = more
# important: admission sheds and preemption evicts the HIGHEST rank
# first, so interactive traffic is the last to suffer.
CLASS_RANK = {"interactive": 0, "batch": 1, "best_effort": 2}


def class_rank(slo_class: str) -> int:
    """Rank for victim/shedding order; unknown classes rank with
    ``interactive`` (never shed by accident of a typo upstream)."""
    return CLASS_RANK.get(slo_class, 0)


class State(enum.Enum):
    ARRIVED = "arrived"
    WAITING_KV = "waiting_kv"          # decode: waiting for block alloc
    WAITING_PREFILL = "waiting_prefill"  # prefill: has blocks, in queue
    PREFILLING = "prefilling"
    PREFILL_FINISHED = "prefill_finished"  # decode notified, joining batch
    DECODING = "decoding"
    FINISHED = "finished"
    PREEMPTED = "preempted"
    REJECTED = "rejected"              # admission control turned it away


@dataclasses.dataclass
class Request:
    rid: int
    arrival: float
    prompt_len: int
    max_new_tokens: int

    # multi-tenant workload model (defaults reproduce the single-class
    # legacy behaviour bit-for-bit)
    slo_class: str = "interactive"     # interactive | batch | best_effort
    session_id: Optional[str] = None   # multi-turn conversation key
    # tokens at the head of the prompt whose KV may already be resident
    # from an earlier turn of the same session.  The value set by the
    # trace generator is OPTIMISTIC; the engine clamps it at admission
    # to what is actually cached and re-prefills the rest.
    cached_prefix_len: int = 0

    state: State = State.ARRIVED
    blocks: Optional[list] = None
    # progress
    prefill_tokens_done: int = 0       # for chunked prefill baselines
    tokens_generated: int = 0          # includes the prefill-produced token
    token_times: List[float] = dataclasses.field(default_factory=list)
    # timestamps
    t_blocks: Optional[float] = None
    t_prefill_start: Optional[float] = None
    t_prefill_end: Optional[float] = None
    t_finish: Optional[float] = None
    preemptions: int = 0
    reject_reason: Optional[str] = None  # set iff state == REJECTED
    # gateway-level failovers: times this request was re-submitted to a
    # different worker after its replica crashed (serving/gateway.py)
    retries: int = 0
    # admission capped max_new_tokens so prompt+output fits a colocated
    # pool (production-shaped truncation instead of a decode stall)
    truncated: bool = False

    @property
    def ttft(self) -> Optional[float]:
        return self.token_times[0] - self.arrival if self.token_times else None

    @property
    def itls(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    @property
    def context_len(self) -> int:
        return self.prompt_len + self.tokens_generated

    @property
    def prefill_tokens_needed(self) -> int:
        """Prompt tokens that actually need prefill compute — the prompt
        minus the session-cached prefix (0 skipped for sessionless
        requests, so this equals ``prompt_len`` on the legacy path)."""
        return self.prompt_len - self.cached_prefix_len

    @property
    def done(self) -> bool:
        return self.tokens_generated >= self.max_new_tokens

    def emit_token(self, now: float) -> None:
        self.tokens_generated += 1
        self.token_times.append(now)
