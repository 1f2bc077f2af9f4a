"""Multi-tenant workload classes, sessions, and time-varying arrivals.

Production serving fleets multiplex tenants with very different
contracts over one pool of chips: latency-sensitive chat (tight ITL,
multi-turn sessions whose turns share a growing prefix), throughput
batch jobs (loose deadlines, long documents), and best-effort scavenger
traffic that exists to soak up idle capacity and is the first thing shed
under pressure.  This module defines that taxonomy and the trace
generators that exercise it:

  * ``WORKLOAD_CLASSES`` — the three SLO classes (interactive / batch /
    best_effort), each with its OWN ``SLOConfig``; per-class goodput in
    ``serving.metrics.fleet_summarize`` is judged against these.
  * Multi-turn *session* generation: turn ``k``'s prompt is the full
    conversation context so far (previous prompt + generated reply) plus
    fresh user tokens, and ``cached_prefix_len`` marks the shared prefix
    a session-prefix cache can skip re-prefilling (kvcache/manager.py).
  * Non-homogeneous Poisson arrivals by thinning — ``diurnal_rate``
    (sinusoidal day/night load) and ``flash_crowd_rate`` (step burst),
    layered on the same lognormal length distributions as traces.py.

Everything is deterministic under the seed.  Plain single-class traces
from ``traces.generate_trace`` are the degenerate case: every request
``interactive``, no sessions, homogeneous arrivals.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np

from repro_torch.config import SLOConfig
from repro_torch.core.request import Request
from repro_torch.serving.traces import TRACES, TraceSpec, _lognormal_mean


@dataclasses.dataclass(frozen=True)
class WorkloadClass:
    """One tenant class: its SLO contract, length distribution, and (for
    sessionful classes) the multi-turn conversation shape."""
    name: str
    slo: SLOConfig
    trace: str = "lmsys"            # key into traces.TRACES
    sessions: bool = False          # multi-turn with shared prefixes
    mean_turns: float = 4.0         # geometric mean turns per session
    think_time_s: float = 4.0       # user think time between turns
    mean_followup_prompt: int = 256  # fresh tokens per follow-up turn


WORKLOAD_CLASSES: Dict[str, WorkloadClass] = {
    "interactive": WorkloadClass(
        "interactive", SLOConfig(itl_ms=100.0, ttft_base_s=1.0),
        trace="lmsys", sessions=True),
    "batch": WorkloadClass(
        "batch", SLOConfig(itl_ms=250.0, ttft_base_s=5.0),
        trace="arxiv"),
    "best_effort": WorkloadClass(
        "best_effort", SLOConfig(itl_ms=1000.0, ttft_base_s=20.0),
        trace="lmsys"),
}

DEFAULT_MIX: Mapping[str, float] = {
    "interactive": 0.45, "batch": 0.35, "best_effort": 0.20,
}


def class_slos() -> Dict[str, SLOConfig]:
    """Per-class SLOs for ``metrics.per_class_summaries``."""
    return {name: wc.slo for name, wc in WORKLOAD_CLASSES.items()}


# ---------------------------------------------------------------------------
# time-varying arrival processes (non-homogeneous Poisson, by thinning)
# ---------------------------------------------------------------------------


def diurnal_rate(base_qps: float, amplitude: float = 0.5,
                 period_s: float = 120.0,
                 phase_s: float = 0.0) -> Callable[[float], float]:
    """Sinusoidal day/night load: rate(t) = base * (1 + A sin(2πt/T)).
    ``period_s`` defaults short so simulated minutes sweep a full cycle.
    The returned callable carries ``rate_max`` for the thinning bound."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError("amplitude must be in [0, 1]")

    def rate(t: float) -> float:
        return base_qps * (1.0 + amplitude * math.sin(
            2.0 * math.pi * (t + phase_s) / period_s))

    rate.rate_max = base_qps * (1.0 + amplitude)
    return rate


def flash_crowd_rate(base_qps: float, peak_qps: float, t_start: float,
                     t_end: float) -> Callable[[float], float]:
    """Step burst: ``peak_qps`` inside [t_start, t_end), base elsewhere."""

    def rate(t: float) -> float:
        return peak_qps if t_start <= t < t_end else base_qps

    rate.rate_max = max(base_qps, peak_qps)
    return rate


def nhpp_arrivals(rate_fn: Callable[[float], float], duration_s: float,
                  rng: np.random.Generator,
                  rate_max: Optional[float] = None) -> List[float]:
    """Arrival times of a non-homogeneous Poisson process on
    [0, duration_s) by Lewis-Shedler thinning: draw candidates at the
    envelope rate, keep each with probability rate(t)/rate_max."""
    if rate_max is None:
        rate_max = getattr(rate_fn, "rate_max", None)
    if rate_max is None or rate_max <= 0:
        raise ValueError("rate_max must be positive (attach .rate_max to "
                         "rate_fn or pass it explicitly)")
    out: List[float] = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= duration_s:
            return out
        if rng.random() * rate_max <= rate_fn(t):
            out.append(t)


# ---------------------------------------------------------------------------
# multi-turn sessions and the multi-class trace generator
# ---------------------------------------------------------------------------


def _session_turns(wc: WorkloadClass, spec: TraceSpec, session_id: str,
                   start: float, duration_s: float,
                   rng: np.random.Generator) -> List[Request]:
    """One session's turn requests (rid=-1; assigned by the caller).

    Turn k's prompt is the whole conversation so far plus fresh user
    tokens; ``cached_prefix_len`` is the prior context — *optimistic*
    (the engine clamps it to what is actually still parked in the
    session-prefix cache at admission)."""
    n_turns = 1 + int(rng.geometric(1.0 / max(1.0, wc.mean_turns)))
    first = int(np.clip(
        _lognormal_mean(rng, spec.mean_prompt, spec.sigma_prompt, 1)[0],
        16, spec.max_prompt))
    out: List[Request] = []
    t, context = start, 0
    for _ in range(n_turns):
        if t >= duration_s:
            break
        fresh = first if context == 0 else int(np.clip(
            _lognormal_mean(rng, wc.mean_followup_prompt, 0.5, 1)[0],
            16, spec.max_prompt))
        prompt = min(context + fresh, spec.max_prompt)
        if prompt <= context:            # context hit the length ceiling
            break
        output = int(np.clip(
            _lognormal_mean(rng, spec.mean_output, spec.sigma_output, 1)[0],
            4, spec.max_output))
        out.append(Request(rid=-1, arrival=t, prompt_len=prompt,
                           max_new_tokens=output, slo_class=wc.name,
                           session_id=session_id,
                           cached_prefix_len=context))
        context = prompt + output
        t += rng.exponential(wc.think_time_s)
    return out


def generate_multiclass_trace(
        qps: float, duration_s: float, seed: int = 0,
        mix: Optional[Mapping[str, float]] = None,
        classes: Optional[Mapping[str, WorkloadClass]] = None,
        rate_fn: Optional[Callable[[float], float]] = None
) -> List[Request]:
    """A multi-tenant trace: arrivals at ``qps`` total (Poisson, or the
    non-homogeneous ``rate_fn`` — see ``diurnal_rate``), each assigned an
    SLO class by ``mix``.  Sessionful classes treat their arrivals as
    session STARTS and append follow-up turns (so the emitted request
    rate exceeds ``qps`` by roughly the sessionful share × mean_turns).
    Requests come back arrival-sorted with dense rids."""
    mix = dict(DEFAULT_MIX if mix is None else mix)
    classes = dict(WORKLOAD_CLASSES if classes is None else classes)
    total = sum(mix.values())
    if total <= 0:
        raise ValueError("mix must have positive total weight")
    names = sorted(mix)
    probs = np.array([mix[n] / total for n in names])
    rng = np.random.default_rng(seed)
    if rate_fn is None:
        starts: List[float] = []
        t = 0.0
        while True:
            t += rng.exponential(1.0 / qps)
            if t >= duration_s:
                break
            starts.append(t)
    else:
        starts = nhpp_arrivals(rate_fn, duration_s, rng)
    reqs: List[Request] = []
    n_sessions = 0
    for start in starts:
        name = names[int(rng.choice(len(names), p=probs))]
        wc = classes[name]
        spec = TRACES[wc.trace]
        if wc.sessions:
            sid = f"{name}-{n_sessions}"
            n_sessions += 1
            reqs.extend(_session_turns(wc, spec, sid, start, duration_s,
                                       rng))
        else:
            prompt = int(np.clip(
                _lognormal_mean(rng, spec.mean_prompt, spec.sigma_prompt,
                                1)[0], 16, spec.max_prompt))
            output = int(np.clip(
                _lognormal_mean(rng, spec.mean_output, spec.sigma_output,
                                1)[0], 4, spec.max_output))
            reqs.append(Request(rid=-1, arrival=start, prompt_len=prompt,
                                max_new_tokens=output, slo_class=name))
    reqs.sort(key=lambda r: r.arrival)
    for i, r in enumerate(reqs):
        r.rid = i
    return reqs
