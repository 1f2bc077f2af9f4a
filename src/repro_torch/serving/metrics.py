"""TTFT / ITL / throughput / goodput metrics (paper §5.2-§5.3).

SLO attainment (paper's definition):
  * ITL : the request's p95 inter-token latency must not exceed itl_ms.
  * TTFT: length-dependent ceiling — prompts of 0-1000 tokens within 1 s,
          1000-2000 within 2 s, proportionally thereafter.

goodput        = SLO-satisfying requests completed per second (both SLOs)
itl_goodput    = same with only the ITL constraint (paper Fig 10)

Serving API v2: ``StreamMetrics`` assembles the same ``RequestRecord``s
incrementally from the typed engine/cluster event stream
(core/events.py) — the replacement for scraping ``records()`` after a
blocking ``run()``.

A copy of ``repro/serving/metrics.py`` without the cluster aggregation
(``per_class_summaries``, ``fleet_summarize``), which the port does not
run yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from repro_torch.config import SLOConfig
from repro_torch.core.events import (CancelledEvent, FinishedEvent,
                                     RejectedEvent, TokenEvent)
from repro_torch.core.request import Request, State


def percentile_linear(vals: Sequence[float], q: float) -> float:
    """Scalar ``np.percentile(vals, q)`` (default linear interpolation),
    bit-identical to numpy on float64 inputs but without the per-call
    array/ufunc machinery — this runs once per *finished request* (both
    record-assembly paths), where numpy's constant overhead dominated
    the whole metrics pipeline.  Replicates numpy's ``_lerp`` exactly,
    including the ``gamma >= 0.5`` symmetric form (golden parity asserts
    the results stay bit-equal to the recorded traces)."""
    a = sorted(vals)
    n = len(a)
    if n == 1:
        return float(a[0])
    vi = (q / 100.0) * (n - 1)
    lo = math.floor(vi)
    gamma = vi - lo
    lo = int(lo)
    hi = lo + 1 if lo + 1 < n else n - 1
    x, y = float(a[lo]), float(a[hi])
    diff = y - x
    if gamma >= 0.5:
        return y - diff * (1.0 - gamma)
    return x + diff * gamma


@dataclasses.dataclass(frozen=True)
class RequestRecord:
    rid: int
    arrival: float
    prompt_len: int
    output_len: int
    ttft: Optional[float]
    itl_p95: Optional[float]
    finish: Optional[float]
    preemptions: int = 0
    rejected: bool = False
    slo_class: str = "interactive"
    reject_reason: Optional[str] = None
    retries: int = 0          # gateway failovers after worker crashes
    truncated: bool = False   # admission capped max_new_tokens to fit
    cancelled: bool = False   # client cancel / disconnect mid-stream

    @classmethod
    def from_request(cls, r: Request) -> "RequestRecord":
        itls = r.itls
        return cls(
            rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
            output_len=r.tokens_generated, ttft=r.ttft,
            itl_p95=percentile_linear(itls, 95) if itls else None,
            finish=r.t_finish, preemptions=r.preemptions,
            rejected=r.state is State.REJECTED,
            slo_class=r.slo_class, reject_reason=r.reject_reason,
            retries=r.retries, truncated=r.truncated)


class StreamMetrics:
    """Event-stream consumer that assembles ``RequestRecord``s live.

    Subscribe one to an engine or cluster (``engine.subscribe(metrics)``)
    and it folds ``TokenEvent``s into per-request timelines, sealing a
    record at each ``FinishedEvent`` / ``RejectedEvent`` — no post-hoc
    ``records()`` scraping.  ``records`` accumulates in terminal-event
    order (chronological under the shared virtual clock);
    ``finished_since(t)`` serves windowed consumers like the autoscaler.
    """

    def __init__(self):
        self._token_times: Dict[int, List[float]] = {}
        self.records: List[RequestRecord] = []
        self.finished: List[RequestRecord] = []   # finish-ordered subset

    def __call__(self, ev) -> None:
        if isinstance(ev, TokenEvent):
            # hot path: one call per generated token — avoid setdefault's
            # unconditional empty-list allocation on every hit
            times = self._token_times.get(ev.rid)
            if times is None:
                self._token_times[ev.rid] = [ev.t]
            else:
                times.append(ev.t)
        elif isinstance(ev, FinishedEvent):
            ts = self._token_times.pop(ev.rid, [])
            itls = [b - a for a, b in zip(ts, ts[1:])]
            rec = RequestRecord(
                rid=ev.rid, arrival=ev.arrival, prompt_len=ev.prompt_len,
                output_len=ev.output_len,
                ttft=ts[0] - ev.arrival if ts else None,
                itl_p95=percentile_linear(itls, 95) if itls else None,
                finish=ev.t, preemptions=ev.preemptions, rejected=False,
                slo_class=ev.slo_class, retries=ev.retries,
                truncated=ev.truncated)
            self.records.append(rec)
            self.finished.append(rec)
        elif isinstance(ev, RejectedEvent):
            self._token_times.pop(ev.rid, None)
            self.records.append(RequestRecord(
                rid=ev.rid, arrival=ev.arrival, prompt_len=ev.prompt_len,
                output_len=ev.output_len, ttft=None, itl_p95=None,
                finish=None, preemptions=ev.preemptions, rejected=True,
                slo_class=ev.slo_class, reject_reason=ev.reason,
                retries=ev.retries))
        elif isinstance(ev, CancelledEvent):
            # terminal but neither success nor rejection: the partial
            # stream the client walked away from.  finish=None keeps it
            # out of completion/goodput; TTFT/ITL reflect what it saw.
            ts = self._token_times.pop(ev.rid, [])
            itls = [b - a for a, b in zip(ts, ts[1:])]
            self.records.append(RequestRecord(
                rid=ev.rid, arrival=ev.arrival, prompt_len=ev.prompt_len,
                output_len=ev.output_len,
                ttft=ts[0] - ev.arrival if ts else None,
                itl_p95=percentile_linear(itls, 95) if itls else None,
                finish=None, preemptions=ev.preemptions, rejected=False,
                slo_class=ev.slo_class, retries=ev.retries,
                cancelled=True))

    def finished_since(self, t_lo: float) -> List[RequestRecord]:
        """Records that finished at or after ``t_lo`` (windowed view)."""
        out: List[RequestRecord] = []
        for rec in reversed(self.finished):
            if rec.finish < t_lo:
                break
            out.append(rec)
        return out

    def summarize(self, slo: SLOConfig, span_s: float) -> Dict[str, float]:
        return summarize(self.records, slo, span_s)


def records_from_events(events: Iterable) -> List[RequestRecord]:
    """Replay a recorded event stream into ``RequestRecord``s."""
    metrics = StreamMetrics()
    for ev in events:
        metrics(ev)
    return metrics.records


def ttft_ceiling(prompt_len: int, slo: SLOConfig) -> float:
    return slo.ttft_base_s * max(
        1, -(-prompt_len // slo.ttft_tokens_per_ceiling))


def meets_itl(rec: RequestRecord, slo: SLOConfig) -> bool:
    if rec.finish is None:
        return False
    return rec.itl_p95 is None or rec.itl_p95 <= slo.itl_ms / 1e3


def meets_ttft(rec: RequestRecord, slo: SLOConfig) -> bool:
    if rec.finish is None or rec.ttft is None:
        return False
    return rec.ttft <= ttft_ceiling(rec.prompt_len, slo)


def _pct(vals: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(vals), q)) if len(vals) else \
        float("nan")


def summarize(records: List[RequestRecord], slo: SLOConfig,
              span_s: float) -> Dict[str, float]:
    done = [r for r in records if r.finish is not None]
    ttfts = [r.ttft for r in done if r.ttft is not None]
    itls = [r.itl_p95 for r in done if r.itl_p95 is not None]
    tokens = sum(r.output_len for r in done)
    ok_both = [r for r in done if meets_itl(r, slo) and meets_ttft(r, slo)]
    ok_itl = [r for r in done if meets_itl(r, slo)]
    return {
        "requests": len(records),
        "completed": len(done),
        "tokens": tokens,
        "throughput_tok_s": tokens / span_s if span_s else 0.0,
        "throughput_req_s": len(done) / span_s if span_s else 0.0,
        "goodput_req_s": len(ok_both) / span_s if span_s else 0.0,
        "itl_goodput_req_s": len(ok_itl) / span_s if span_s else 0.0,
        "slo_attainment": len(ok_both) / len(done) if done else 0.0,
        "rejected": sum(1 for r in records if r.rejected),
        "ttft_p50_s": _pct(ttfts, 50),
        "ttft_p95_s": _pct(ttfts, 95),
        "ttft_p99_s": _pct(ttfts, 99),
        "itl_p50_s": _pct(itls, 50),
        "itl_p95_s": _pct(itls, 95),
        "preemptions": sum(r.preemptions for r in done),
        "retries": sum(r.retries for r in records),
        "truncated": sum(1 for r in done if r.truncated),
        "cancelled": sum(1 for r in records if r.cancelled),
    }


def rejections_by_reason(records: List[RequestRecord]) -> Dict[str, int]:
    """Rejection counts keyed by ``RejectedEvent.reason`` vocabulary."""
    out: Dict[str, int] = {}
    for rec in records:
        if rec.rejected:
            reason = rec.reject_reason or "never_fits"
            out[reason] = out.get(reason, 0) + 1
    return out
