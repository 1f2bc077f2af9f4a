"""RAPID-Serve's own engine serving a real model: one ``RapidEngine``
replica whose plans a ``KernelExecutor`` runs through the port's model
and CUDA kernels, with the ARM's ``f_decode`` in every fused step.

The port's counterpart of ``repro/launch/serve.py``, restricted to one
RAPID replica on a real model.  It runs a list of requests known in
advance (below), or, with ``--serve http``, the reference's online
gateway (``serving/gateway.py``, ``serving/http.py``): admission,
routing, NDJSON token streams with backpressure, heartbeats, failover
and cancellation, over one RAPID worker on the card.  It leaves out the
reference launcher's priced fleets (``--mix``, ``--replicas``, ``--mode
all``), its multi-class workloads, and the hybrid and disagg modes.

The online server.  The body of ``POST /v1/generate`` carries a prompt
length, not tokens: a request's prompt tokens are drawn with numpy from
(``--seed``, its rid) (``prompt_tokens``), so a client can recompute
them.  Its token events stream as the reference's (indices and times);
the tokens themselves stay on the server, in the executor.  The kernels
are built, and the model warmed up, before the server's clock starts: a
step blocks the event loop for its whole launch, and the first launches'
builds would outlast the gateway's heartbeat timeout.  A body with
``cached_prefix_len`` > 0 is refused, and so is ``--checkpoint-interval``
> 0 at start-up (both need a prefill after a cached prefix, ROADMAP A5),
and so is a model with recurrent layers, Mamba or xLSTM (its state rows,
ROADMAP A11).  Both modes refuse a model that takes no tokens
(``embed_stub``; ``serve_real.check_tokens``) before it loads.

The requests: with ``--trace`` (lmsys, arxiv or loogle) those of the
reference's synthetic trace at ``--qps`` for ``--duration`` seconds
(``serving/traces.py``), each entering the engine at its arrival time,
with prompt tokens drawn from ``--seed``.  Prompts are not capped: one
that can never fit the pool is rejected by the engine, as in the
reference.  Without ``--trace``, ``serve_real.make_requests``'s seeded
prompts, all arriving at t = 0, as ``serve_real`` serves them.

TTFT, ITL and tokens/s are on the engine's clock: virtual time that each
launch advances by its measured duration (``KernelExecutor``), and that
jumps to the next arrival when the card is idle.  The KV pool is the one
the scheduler sizes from the hardware spec (``H100`` on the card),
allocated whole.

    python -m repro_torch.launch.serve --full           # on the H100
    python -m repro_torch.launch.serve --full --arch llama3-70b \\
        --trace lmsys --qps 0.5 --duration 20           # on the H100
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --device cpu --dtype float32                   # reduced, CPU
    python -m repro_torch.launch.serve --full --serve http --port 8080
    curl -N -X POST http://127.0.0.1:8080/v1/generate \\
        -d '{"prompt_len": 512, "max_new_tokens": 64}'
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.config import (SLOConfig, ServeConfig, get_one_card_config,
                                get_reduced_config, replace)
from repro_torch.core.engines import RapidEngine, drive
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request
from repro_torch.launch import serve_real
from repro_torch.models.transformer import init_model
from repro_torch.perfmodel.hw import H100, HardwareSpec
from repro_torch.serving.admission import AdmissionPolicy
from repro_torch.serving.clock import RealTimeClock
from repro_torch.serving.cluster import ROUTERS
from repro_torch.serving.faults import RetryPolicy
from repro_torch.serving.gateway import Gateway, GatewayPolicy
from repro_torch.serving.http import run_http
from repro_torch.serving.traces import TRACES, generate_trace

# the memory a CPU run sizes its KV pool from, in place of the card's
# 80 GB (tens of GB of host memory even for a reduced model)
CPU_HBM_BYTES = 32 << 20


def serve_config(slo: Optional[SLOConfig] = None) -> ServeConfig:
    """One RAPID replica on one card with ``serve_real``'s decode slots
    and page size; every other field at its default."""
    return ServeConfig(mode="rapid", chips=1,
                       max_batch_slots=serve_real.SLOTS,
                       page_size=serve_real.PAGE, slo=slo or SLOConfig())


def trace_requests(cfg, trace: str, qps: float, duration: float,
                   seed: int) -> "tuple[List[serve_real.Request], dict]":
    """The requests of the reference's ``trace`` at ``qps`` for
    ``duration`` seconds (``generate_trace`` with ``seed``), each prompt's
    tokens drawn from ``seed`` with numpy as ``serve_real.make_requests``
    draws them.  Returns the requests and their arrivals (rid -> s)."""
    spec = generate_trace(TRACES[trace], qps, duration, seed)
    rng = np.random.default_rng(seed)
    reqs = [serve_real.Request(
        r.rid, rng.integers(0, cfg.vocab_size, size=r.prompt_len)
        .astype(np.int32), r.max_new_tokens) for r in spec]
    return reqs, {r.rid: r.arrival for r in spec}


def serve_engine(model, requests: List[serve_real.Request],
                 serve: ServeConfig, *, hw: HardwareSpec = H100,
                 arrivals: Optional[Dict[int, float]] = None) -> dict:
    """Serve ``requests`` (``serve_real.Request``s, each arriving at its
    ``arrivals`` time in seconds, or all at t = 0) through
    ``RapidEngine(cfg, serve, hw, executor=KernelExecutor(...))`` driven
    by ``drive``.  Returns the engine's ``RequestRecord``s, the
    executor's launch log, each request's tokens, the engine's requests,
    the decode graphs' counts, and what ended reclaimed."""
    if serve.mode != "rapid":
        raise NotImplementedError(f"mode {serve.mode!r}: the port serves "
                                  "the rapid engine only")
    serve_real.check_tokens(model.cfg)
    dev = model.tok.device
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in requests},
                        serve=serve, device=dev, hw=hw,
                        state_rows=len(requests))
    engine = RapidEngine(model.cfg, serve, hw, executor=ex)
    ex.bind(engine)
    mem = torch.cuda.mem_get_info(dev) if dev.type == "cuda" else None
    arrivals = arrivals or {}
    reqs = [Request(r.rid, arrivals.get(r.rid, 0.0), len(r.prompt),
                    r.max_new) for r in requests]
    t = time.perf_counter()
    records, span = drive(engine, reqs)
    wall = time.perf_counter() - t
    kv = engine.kv
    return {"records": records, "span_s": span, "wall_s": wall,
            "log": ex.log, "tokens": dict(ex.tokens),
            "decode_graphs": ex.graphs.stats(),
            "requests": sorted(engine.finished + engine.rejected,
                               key=lambda r: r.rid),
            "max_new": {r.rid: r.max_new for r in requests},
            "wakes": engine.loop.stats.dispatched,
            "arm_modes": dict(collections.Counter(
                a.mode for a in engine.arm.history)),
            "pool_blocks": ex.num_blocks,
            "spare_pages": serve.max_batch_slots,
            "pool_bytes": ex.pool_bytes,
            "mem_free_after_pool": None if mem is None else mem[0],
            "mem_total": None if mem is None else mem[1],
            "pool_reclaimed": (kv.num_requests == 0 and
                               kv.allocator.free_count ==
                               kv.allocator.num_blocks),
            "state_rows_reclaimed": ex.rows_free == ex.state_rows}


def prompt_tokens(vocab: int, seed: int, rid: int, n: int) -> np.ndarray:
    """The ``n`` prompt tokens of request ``rid`` on the online server,
    drawn with numpy from (``seed``, ``rid``) as ``trace_requests`` draws
    a trace's."""
    return np.random.default_rng((seed, rid)).integers(
        0, vocab, size=n).astype(np.int32)


class SeededPrompts(Mapping):
    """The online server's prompts, by rid: ``add(r)`` records a submitted
    request's length, and its tokens are ``prompt_tokens`` of it, drawn
    again at each read (a prefill, or a re-prefill on resume).  It refuses
    a request whose prompt starts with a cached prefix."""

    def __init__(self, vocab: int, seed: int):
        self.vocab = vocab
        self.seed = seed
        self._lens: Dict[int, int] = {}

    def add(self, r: Request) -> None:
        if r.cached_prefix_len > 0:
            raise ValueError(
                f"cached_prefix_len {r.cached_prefix_len}: a prefill after "
                f"a cached prefix is not run on the card yet (ROADMAP A5)")
        self._lens[r.rid] = r.prompt_len

    def __getitem__(self, rid: int) -> np.ndarray:
        return prompt_tokens(self.vocab, self.seed, rid, self._lens[rid])

    def __iter__(self):
        return iter(self._lens)

    def __len__(self) -> int:
        return len(self._lens)


def kernel_engines(model, prompts: Mapping, tokens: Dict[int, List[int]]):
    """The gateway's ``engine_factory`` for workers on the model's device:
    a ``RapidEngine`` whose plans a ``KernelExecutor`` runs, bound to it
    (its KV pool allocated whole).  Every worker's executor reads the
    prompts from ``prompts`` and keeps the generated tokens in
    ``tokens``, so a request that moves between workers keeps its own."""
    def build(mode, cfg, serve, hw, loop):
        if mode != "rapid":
            raise NotImplementedError(
                f"mode {mode!r}: the port's workers run the rapid engine "
                f"only (ROADMAP item 'hybrid and disagg real execution')")
        ex = KernelExecutor(model, prompts=prompts, serve=serve,
                            device=model.tok.device, hw=hw, tokens=tokens)
        engine = RapidEngine(cfg, serve, hw, loop=loop, executor=ex)
        ex.bind(engine)
        return engine
    return build


def check_online(cfg, checkpoint_interval: int = 0) -> None:
    """Raise ``NotImplementedError`` for what the online server does not
    run on the card: the gateway's KV checkpoints, which would resume a
    request after a cached prefix (ROADMAP A5); and a model with
    recurrent layers (Mamba, mLSTM, sLSTM), whose requests each hold a
    state row from their prefill on, which no admission bounds yet
    (ROADMAP A11)."""
    if checkpoint_interval > 0:
        raise NotImplementedError(
            "checkpoint_interval > 0: resuming from a KV checkpoint is a "
            "prefill after a cached prefix, not run on the card yet "
            "(ROADMAP A5)")
    recurrent = sorted(set(cfg.layer_pattern) & {"mamba", "mlstm", "slstm"})
    if recurrent:
        raise NotImplementedError(
            f"{cfg.name}: the online server does not serve recurrent "
            f"layers ({', '.join(recurrent)}) yet: each request holds a "
            f"state row from its prefill on, and no admission bounds the "
            f"rows (ROADMAP A11)")


def make_gateway(model, serve: ServeConfig, prompts: Mapping, *, clock,
                 hw: HardwareSpec = H100, workers: int = 1,
                 **gateway_kw) -> Gateway:
    """A ``Gateway`` on ``clock`` over ``workers`` RAPID workers, each a
    ``RapidEngine`` + ``KernelExecutor`` on the model's device, all
    reading their prompts from ``prompts`` and sharing one store of
    generated tokens; ``gateway_kw`` are the gateway's own (``router``,
    ``policy``, ``admission``, ``retry``, ...).

    What it does not run is refused (``check_online``)."""
    policy = gateway_kw.get("policy")
    check_online(model.cfg, policy.checkpoint_interval if policy else 0)
    return Gateway(model.cfg, serve, modes=["rapid"] * workers, hw=hw,
                   clock=clock, engine_factory=kernel_engines(
                       model, prompts, tokens={}),
                   **gateway_kw)


def warm_up(model) -> None:
    """Build the kernels and run two short requests through
    ``serve_real``, so that no launch of the online server waits for a
    build or a library's first call."""
    if model.tok.device.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()
    serve_real.serve(model, serve_real.make_requests(
        model.cfg, 2, 1, (32, 64), (3, 3)), slots=serve_real.SLOTS,
        page=serve_real.PAGE)


def serve_http(model, args, hw: HardwareSpec) -> None:
    """``--serve http``: the online gateway over one RAPID worker on the
    model's device, until interrupted."""
    prompts = SeededPrompts(model.cfg.vocab_size, args.seed)
    warm_up(model)
    gw = make_gateway(
        model, serve_config(SLOConfig(itl_ms=args.slo_itl_ms)), prompts,
        clock=RealTimeClock(), hw=hw, router=args.router,
        admission=AdmissionPolicy(
            kv_headroom=args.kv_headroom,
            max_wait_s=args.admission_max_wait,
            class_aware=args.class_aware_admission),
        session_affinity=args.session_affinity,
        policy=GatewayPolicy(checkpoint_interval=args.checkpoint_interval,
                             max_retries=args.max_retries),
        retry=RetryPolicy(max_retries=args.max_retries,
                          backoff_base_s=args.retry_backoff))
    run_http(gw, host=args.host, port=args.port, prompts=prompts)


# a TokenEvent's stamp after its lane's end on a real-time clock, net of
# the plans the host ran in between (``token_stamp_lags``): 99 % of them
# within STAMP_P99_S, every one within STAMP_MAX_S.  A lane completion
# waits behind whatever the event loop runs first (the HTTP handlers'
# steps), so a few tokens read late: 14.2 ms at worst on an H100 80GB HBM3
# at 700 W (``chip_smoke.py`` phase 9), and STAMP_MAX_S is about twice
# that.  A lane that ends a launch's duration after the launch returned
# (the launch waited twice) puts every token a whole launch late.
STAMP_P99_S = 5e-3
STAMP_MAX_S = 30e-3


def token_stamp_lags(log, events, offset: float
                     ) -> "tuple[List[float], List[float]]":
    """For each ``TokenEvent`` in ``events``: how long after its lane's
    end it was stamped, on the gateway's clock (``offset``: its time less
    the host's ``perf_counter``), from a ``KernelExecutor``'s ``log``.  A
    lane ends when its launch's tokens reached the host (``host_end``; a
    plan's prefill lane with its last launch).  Returns the lags raw, and
    net of the time the host thread spent in between on plans (from the
    engine's view of each to its last launch's end: it was busy
    scheduling and launching, its own plan's later launches included, not
    waiting)."""
    plans = collections.defaultdict(list)
    for e in log:
        plans[e["plan"]].append(e)
    span = {p: (min(e["t_start"] for e in es),
                max(e["host_end"] for e in es) + offset)
            for p, es in plans.items()}
    raw, net = [], []
    for ev in events:
        if type(ev).__name__ != "TokenEvent":
            continue
        cands = [e for e in log if ev.rid in e["rids"] and
                 e["host_end"] + offset <= ev.t + 1e-6]
        if not cands:
            continue
        e = cands[-1]
        prefill_token = e["kind"] == "prefill" or (
            e["kind"] == "fused" and e["rids"][0] == ev.rid)
        lane_end = span[e["plan"]][1] if prefill_token else \
            e["host_end"] + offset
        between = sum(max(0.0, min(b, ev.t) - max(a, lane_end))
                      for a, b in span.values())
        raw.append(ev.t - lane_end)
        net.append(ev.t - lane_end - between)
    return raw, net


def stamps_late(net: List[float]) -> Optional[str]:
    """Why the net lags of ``token_stamp_lags`` fail their limits, or
    None when they hold."""
    if not net:
        return "no TokenEvent after a launch"
    p99, worst = float(np.percentile(net, 99)), max(net)
    if p99 <= STAMP_P99_S and worst <= STAMP_MAX_S:
        return None
    return (f"TokenEvents stamped after their lane's end, net of the plans "
            f"run in between: p99 {p99 * 1e3:.2f} ms (limit "
            f"{STAMP_P99_S * 1e3}), max {worst * 1e3:.2f} ms (limit "
            f"{STAMP_MAX_S * 1e3})")


def summarize(result: dict) -> dict:
    """TTFT/ITL/throughput on the engine's clock, launches by kind, the
    ``f_decode`` the fused launches ran with, the decode graphs and the
    mean host time of the decode launches by how they ran ("capture",
    "replay", or "eager" on the CPU), the engine's own host time per wake
    (the scheduler, queues and the executor's bookkeeping: the run's wall
    time outside the launches, over the events the loop dispatched, one
    scheduler wake each), and the preemptions and rejections.  A request's
    token count is met when every request the engine did not reject
    generated its ``max_new`` tokens."""
    reqs = [r for r in result["requests"] if r.token_times]
    ttft = [r.ttft for r in reqs]
    itl = [x for r in reqs for x in r.itls]
    n_tok = sum(r.tokens_generated for r in reqs)
    log = result["log"]
    kinds = collections.Counter(e["kind"] for e in log)
    launch_s = sum(e["wall_s"] for e in log)
    decode_s = collections.defaultdict(list)
    for e in log:
        if e["kind"] == "decode":
            decode_s[e["graph"]].append(e["wall_s"])
    rejected = {r.rid for r in result["records"] if r.rejected}

    def stats(kind, key):
        vals = [e[key] for e in log if e["kind"] == kind and
                e[key] is not None]
        return {"mean": float(np.mean(vals)), "median": float(
            np.median(vals)), "min": min(vals), "max": max(vals)} \
            if vals else None

    return {"requests": len(result["requests"]), "tokens": n_tok,
            "span_s": result["span_s"], "wall_s": result["wall_s"],
            "tokens_per_s": n_tok / result["span_s"],
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "itl_mean_s": float(np.mean(itl)) if itl else None,
            "itl_p95_s": float(np.percentile(itl, 95)) if itl else None,
            "launches": dict(kinds),
            "launch_wall_s": {k: stats(k, "wall_s") for k in kinds},
            "launch_device_ms": {k: stats(k, "device_ms") for k in kinds},
            "decode_graphs": result["decode_graphs"],
            "decode_wall_s_mean": {k: float(np.mean(v))
                                   for k, v in decode_s.items()},
            "fused_f_decode": [e["f_decode"] for e in log
                               if e["kind"] == "fused"],
            "fused_arm_f_decode": [e["arm_f_decode"] for e in log
                                   if e["kind"] == "fused"],
            "arm_modes": result["arm_modes"],
            "wakes": result["wakes"],
            "engine_host_s_per_wake": (result["wall_s"] - launch_s) /
            max(1, result["wakes"]),
            "preemptions": sum(r.preemptions for r in result["requests"]),
            "rejected": len(rejected),
            "tokens_met": all(len(result["tokens"].get(rid, ())) == n
                              for rid, n in result["max_new"].items()
                              if rid not in rejected),
            "pool_blocks": result["pool_blocks"],
            "pool_bytes": result["pool_bytes"],
            "mem_free_after_pool": result["mem_free_after_pool"],
            "pool_reclaimed": result["pool_reclaimed"],
            "state_rows_reclaimed": result["state_rows_reclaimed"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths: the published config, or "
                    "its one-card cut where one card cannot hold it "
                    "(default: reduced)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="float32 or bfloat16 (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--trace", default=None, choices=sorted(TRACES),
                    help="requests from this synthetic trace, arriving "
                    "over time (default: --requests seeded requests, all "
                    "at t = 0)")
    ap.add_argument("--qps", type=float, default=8.0)
    ap.add_argument("--duration", type=float, default=60.0)
    ap.add_argument("--serve", default="offline", choices=["offline", "http"],
                    help="'http' starts the online gateway (streaming "
                    "NDJSON API, heartbeats, failover, cancellation) over "
                    "one RAPID worker, instead of serving a list of "
                    "requests")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--router", default="least_loaded",
                    choices=sorted(ROUTERS))
    ap.add_argument("--slo-itl-ms", type=float, default=100.0)
    ap.add_argument("--session-affinity", action="store_true",
                    help="route a session's turns to the worker that "
                    "served its last one")
    ap.add_argument("--class-aware-admission", action="store_true",
                    help="class-ordered admission headroom: sheds "
                    "best_effort first, never interactive")
    ap.add_argument("--kv-headroom", type=float, default=0.9,
                    help="admission: max projected pool occupancy")
    ap.add_argument("--admission-max-wait", type=float, default=60.0,
                    help="admission: queueing deadline before rejection "
                    "(s)")
    ap.add_argument("--checkpoint-interval", type=int, default=0,
                    help="gateway KV snapshot period in generated tokens; "
                    "only 0 (off) is run on the card (ROADMAP A5)")
    ap.add_argument("--max-retries", type=int, default=2,
                    help="failover re-dispatches per request before the "
                    "terminal worker_lost rejection")
    ap.add_argument("--retry-backoff", type=float, default=0.05,
                    help="base seconds of the exponential failover "
                    "backoff")
    args = ap.parse_args(argv)
    cfg = get_one_card_config(args.arch) if args.full else \
        get_reduced_config(args.arch)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    try:
        serve_real.check_tokens(cfg)
        if args.serve == "http":
            check_online(cfg, args.checkpoint_interval)
    except NotImplementedError as e:
        ap.error(str(e))

    device = serve_real.resolve_device(args.device)
    hw = H100 if device.type == "cuda" else \
        dataclasses.replace(H100, hbm_bytes=CPU_HBM_BYTES)
    model = init_model(cfg, seed=args.seed, device=device)
    if args.serve == "http":
        serve_http(model, args, hw)
        return 0
    arrivals = None
    if args.trace:
        reqs, arrivals = trace_requests(cfg, args.trace, args.qps,
                                        args.duration, args.seed)
        if not reqs:
            raise ValueError(f"trace {args.trace} at {args.qps} qps for "
                             f"{args.duration} s holds no request")
    elif args.full:
        reqs = serve_real.make_requests(cfg, args.requests, args.seed,
                                        (128, 2048), (16, 64))
    else:
        reqs = serve_real.make_requests(cfg, args.requests, args.seed)
    summary = summarize(serve_engine(model, reqs, serve_config(), hw=hw,
                                     arrivals=arrivals))
    print(json.dumps(summary))
    if not (summary["pool_reclaimed"] and summary["state_rows_reclaimed"]
            and summary["tokens_met"]):
        raise RuntimeError("a request's tokens were not all served, or the "
                           "KV pool or the state rows were not reclaimed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
