"""RAPID-Serve's own engine serving a real model: one ``RapidEngine``
replica whose plans a ``KernelExecutor`` runs through the port's model
and CUDA kernels, with the ARM's ``f_decode`` in every fused step.

The port's counterpart of ``repro/launch/serve.py``, restricted to one
RAPID replica on a real model.  It leaves out the reference launcher's
clusters and routers, its multi-class workloads, the online gateway and
its HTTP server, and the hybrid and disagg modes.

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
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import (ServeConfig, get_one_card_config,
                                get_reduced_config, replace)
from repro_torch.core.engines import RapidEngine, drive
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request
from repro_torch.launch import serve_real
from repro_torch.models.transformer import init_model
from repro_torch.perfmodel.hw import H100, HardwareSpec
from repro_torch.serving.traces import TRACES, generate_trace

# the memory a CPU run sizes its KV pool from, in place of the card's
# 80 GB (tens of GB of host memory even for a reduced model)
CPU_HBM_BYTES = 32 << 20


def serve_config() -> ServeConfig:
    """One RAPID replica on one card with ``serve_real``'s decode slots
    and page size; every other field at its default."""
    return ServeConfig(mode="rapid", chips=1,
                       max_batch_slots=serve_real.SLOTS,
                       page_size=serve_real.PAGE)


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
    dev = model.tok.device
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in requests},
                        serve=serve, device=dev, hw=hw)
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
    args = ap.parse_args(argv)

    device = serve_real.resolve_device(args.device)
    cfg = get_one_card_config(args.arch) if args.full else \
        get_reduced_config(args.arch)
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    hw = H100 if device.type == "cuda" else \
        dataclasses.replace(H100, hbm_bytes=CPU_HBM_BYTES)
    model = init_model(cfg, seed=args.seed, device=device)
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
