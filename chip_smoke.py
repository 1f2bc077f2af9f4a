#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only-mesh      # the build, then phase 13
    python3 chip_smoke.py --only-hybrid    # the build, then phase 14
    python3 chip_smoke.py --only-disagg    # the build, phase 6, phase 15
    python3 chip_smoke.py --gateway-runs N # phase 9 alone, N times

Phases, each reported on its own line; any failure exits non-zero before
the result line:
  1. device  — a CUDA device must exist; prints its name and power limit;
  2. build   — compiles every kernel under src/repro_torch/csrc (nvcc);
  3. kernels — each kernel against its plain PyTorch version on the card:
               float32 at the reference's test shapes, plus decode cases
               on the edges of the key splits (3e-5 for attention, 2e-4
               for ssm_scan); bfloat16 at the same attention shapes and at
               the serving path's (3e-2, and per output row 1e-2 of the
               row's largest value, a limit that planted faults — one key
               dropped, one key or page read from the wrong place, one
               split's keys never read — must exceed); and unified_pd
               against flash_prefill + paged_attention for several
               f_decode, within 1e-6 in float32 and bit for bit in
               bfloat16; ssm_scan also at ragged shapes, in two halves,
               the second from the first's final state (h0);
               paged_attention on two streams at once, each launch against
               its plain version, and unified_pd beside paged_attention on
               two streams; times each kernel, its plain version, one
               PyTorch library call where one computes the same function,
               and the least time the card could take (bound); and, at the
               fused step's shapes, the persistent unified_pd's grid, the
               SM ids its CTAs ran on, and at each f_decode its time and
               (from its trace) when its decode and prefill tiles finished,
               beside flash_prefill and paged_attention timed alone, summed
               and on two streams at once;
  4. serve   — full-width granite-8b (36 layers, random seeded weights,
               bf16) serves 8 requests through serve_real's loop; exactly
               its three attention kernels must have launched, the KV pool
               and the decode slots must end reclaimed, and the first
               prefill's and first concurrent step's logits must agree
               between the kernel path and the plain path; a profiled
               rerun of 3 requests gives the device busy share;
  5. jamba   — one full-width Jamba-1.5-Large period (8 layers: 7 Mamba,
               1 attention; dense FFNs in place of MoE; random seeded
               weights, bf16).  The attention kernels at its shapes as in
               phase 3 (64 query heads); ssm_scan against its plain version
               at the scan inputs of the first prompt's first Mamba layer,
               again with a random A, and in two halves from h0 (per output
               row 1e-3 of the row's largest value, which planted faults
               must exceed); then the same serving
               run as phase 4, which must launch all four kernels, the
               same kernel-vs-plain logits check, in bf16 (3e-2) and again
               with float32 weights (1e-3), and the same profiled rerun;
  6. engine  — the same 8 requests through RAPID-Serve's own engine:
               ``RapidEngine`` on the ``H100`` spec (one card, 4 decode
               slots, page 16) whose plans a ``KernelExecutor`` runs on
               the card, fused steps with the ARM's f_decode; for granite-8b
               after phase 4, for the Jamba period after phase 5 (before
               its float32 model).  The KV pool is the one the scheduler
               sizes, allocated whole; prints its size, the memory left,
               the launches by kind, TTFT/ITL/tokens per second on the
               engine's clock beside serve_real's, and the engine's host
               time per wake.  Exactly the path's kernels must launch, at
               least one fused step, every request's token count met, pool
               and state rows reclaimed, no preemption, no rejection; how
               many requests' tokens equal serve_real's is reported;
  7. mixtral — Mixtral-8x7B at every published width, cut to 24 layers
               (the config's one-card cut; random seeded weights, bf16,
               70 GB): the attention kernels at its windowed shapes
               (flash_prefill on a 6000-token prompt with the window 4096,
               beside SDPA with a sliding-window mask; paged_attention over
               ring tables, one sequence wrapped; unified_pd with both),
               with two more planted faults (the window ignored; a decode's
               K/V written at seq_lens, not seq_lens % W); one MoE layer
               timed at the decode batch and at prefills of the first
               prompt and of 2048 tokens against its bound, with the
               memory one call takes; then phases 4 and 6 on the smoke's
               8 requests plus a
               6000-token prompt (the window binds) and a 4090-token one
               (its ring wraps during decode), the kernel-vs-plain logits
               also on the 6000-token prompt and a decode of it (the plain
               path held to the kernel path's expert choices, of which it
               would have chosen others for under 5 %; a planted window
               fault in the plain path must move these logits past their
               limit), and the decode step's device-busy share from a
               profile;
  8. llama   — LLaMA-3.1-70B at every published width, cut to 38 layers
               (the config's one-card cut; random seeded weights, bf16,
               69 GB): phase 4 on the smoke's 8 requests, then the engine
               path of phase 6 on the reference's lmsys trace at 0.5 qps
               for 20 s (seed 0: 7 requests arriving over 12.9 s), each
               request entering the engine at its arrival;
  9. gateway — after phase 6 for granite-8b, on the same model: the online
               gateway's HTTP server (``GatewayHTTPServer``) in this process
               on 127.0.0.1, over one RAPID worker on the card
               (``RapidEngine`` + ``KernelExecutor``, the pool the scheduler
               sizes) on ``RealTimeClock``, with ``stream_buffer`` 8.  HTTP
               clients (``http.client``) send the reference's lmsys trace at
               1 qps for 20 s (seed 0: 13 requests) each at its arrival, one
               request that disconnects mid-stream, and one whose client
               stops reading until the gateway has paused it (evicted from
               the engine), then drains: it is prefilled again on the card
               over its prompt and generated tokens and resumes its stream.
               Every other stream must end ``finished`` with token indices
               0..max_new-1 once each, the disconnected one ``cancelled``;
               exactly the three attention kernels launched, a fused step
               and a re-prefill; no preemption but the pause and no
               rejection; pool, state rows and spare pages reclaimed;
               /healthz "up" at every poll and /metrics valid JSON; and
               99 % of the TokenEvents stamped within 5 ms after their
               lane's launch ended, every one within 30 ms, once the plans
               run in between are taken off (``launch/serve.py``
               ``stamps_late``), each lane completion due by its
               launch's end.  The clients and the /healthz monitor run in
               a child process (``smoke_clients.py``, no torch), on the
               same clock (checked), so none of their threads takes this
               process's GIL.  Reports
               client-side and engine-side TTFT/ITL, the longest gap
               between heartbeats, the first 64 tokens of each stream beside
               serve_real's, and the paused request's tokens beside an
               uninterrupted run of it.
 10. archs   — after phase 8: the reference's other token-frontend
               attention models, each at every published width with random
               seeded bf16 weights, one after the other: MiniCPM-2B (MHA,
               G = 1, D = 64, tied embeddings), Qwen2.5-14B (qkv bias,
               G = 5), StarCoder2-3B (qkv bias, GELU FFN, G = 12) and
               Qwen3-MoE-235B-A22B cut to 13 layers (the config's one-card
               cut; 128 experts top-8, G = 16).  For each: the three
               attention kernels at its serving shapes as in phase 3, where
               G > 8 with two more planted faults (the heads past the 8th
               of each group never written, or computed from the wrong kv
               head's K/V); Qwen3-MoE's MoE layer timed as in phase 7;
               then phase 4 on the smoke's 8 requests (Qwen3-MoE's logits
               check on held routing as Mixtral's, under 5 % flips), the
               graph check and decode profile, and phase 6's engine path.
               The result line's kernel records carry each model's as
               ``at_g1``, ``at_g5``, ``at_g12`` and ``at_g16``.
 11. train   — after phase 10, with its models freed: the training path
               (``launch/train.py``: ``lm_loss``, AdamW with the WSD
               schedule, microbatches, checkpoints, the supervisor), which
               runs the kernels' plain versions as the reference does, so
               no kernel may launch while it trains.  (a) the reduced
               granite-8b, Mixtral-8x7B, Jamba (with experts), MiniCPM-2B
               and xlstm-125m in float32: lm_loss and its gradients on the
               card against the CPU's on the same weights and batch (loss
               1e-5 relative, every gradient leaf 1e-4 of the gradient's
               largest); (b) MiniCPM-2B at every published width, all 40
               layers, 6 steps of 2 x 4096 tokens in 2 microbatches (bf16
               weights, float32 moments): losses and grad norms finite,
               the last loss below the first; seconds per step, tokens/s,
               peak memory and the model-FLOP share; (c) the trained model
               serves the smoke's first 2 requests through serve_real on
               the kernels (kernel-vs-plain logits within 3e-2, pool and
               slots reclaimed, memory back to the weights'); (d)
               xLSTM-125M at every published width, 8 steps of 8 x 512
               tokens with gradient compression: the step-8 checkpoint
               restored onto the card equals the live state bit for bit,
               and a checkpoint written from CPU tensors restores onto the
               card; (e) ``launch/train_small`` (60 steps, a failure at 30,
               one restart) prints OK; (f) a kernel wrapper called on an
               input that requires grad must raise.
 12. cells   — after phase 11: (a) xLSTM-125M at every published width
               (seeded bf16 weights) through serve_real and the engine
               path on the smoke's 8 requests: no kernel may launch (its
               mixers have none in the reference), pool and rows
               reclaimed; the graph check (rolled state rows as its
               second fault) and the decode profile; the decode step
               against the full forward within the reference's 0.25 of
               the forward's std, in bf16 and with float32 weights.
               (b) Qwen2-VL-72B's one-card cut (36 of 80
               layers, M-RoPE, stub patch embeddings) and MusicGen-large
               whole (stub frame embeddings): the attention kernels at
               their cells' shapes as in phase 10, then launch/steps.py's
               prefill (1 x 2048), decode (8 sequences of 1024-2032
               tokens, four steps through DecodeGraphs) and fused (1 x
               1024 + 8 decodes) cells on the kernels against the plain
               versions (3e-2), replays bit-equal to eager, and for
               Qwen2-VL planted position faults; each cut from the
               reference's shapes is printed as a ``reduced`` list.  The
               result line's kernel records carry the two models' as
               ``at_qwen2_vl`` and ``at_musicgen``.
 13. mesh    — after phase 12, with its models freed: the mesh half on a
               1x1 mesh over this card (``launch/mesh.py``
               ``make_host_mesh``: one rank of NCCL).  (a) ``long_500k``
               (batch 1, a pool of 524,288 tokens, the reference's shape;
               the sequence's length drawn from the seed, as every decode
               cell draws its lengths) through ``launch/steps.py``'s ``build_cell(..., mesh=)`` for
               the Jamba period, xLSTM-125M whole and Mixtral-8x22B's
               one-card cut (13 of 56 layers, 65.9 GB; its window's ring):
               three decode steps as CUDA graphs (one capture, two
               replays; the last one's wall time reported; on one chip the
               graphs run the program without a mesh), the last one again
               eagerly through the placed model's DTensor program, which
               must launch ``paged_attention`` once per attention layer
               and give the graph's logits bit for bit, the first on the
               plain versions within 3e-2 (an MoE model's routing held),
               exactly ``paged_attention`` launched where the model has
               attention (none for xLSTM),
               and ``paged_attention`` at the cell's shapes over all
               524,288 tokens (the window's 4,096 under a sliding window)
               against its plain version, with a page read from the wrong
               block and a split skipped planted (one key dropped moves a
               row over half a million keys too little), and its time,
               bound, splits and CTAs.
               (b) Mixtral-8x22B as phase 10 treats a model: the attention
               kernels at granite's serving shapes with its 48/8 heads (G
               6), its MoE layer timed, ``serve_real`` on the 8 requests
               (held-routing logits, flips under TOL_FLIP_SHARE), the graph
               check and the decode profile.  (c) One step of
               ``build_train_cell`` on the 1x1 mesh for MiniCPM-2B at every
               width cut to 4 layers, at phase 11's batch and optimizer,
               against phase 11's ``make_train_step`` on the same weights
               and batch (loss and grad norm within 1e-6).  The result
               line's kernel records carry ``at_g6``,
               ``at_long_500k_jamba`` and ``at_long_500k_mixtral_8x22b``.
 14. hybrid  — the hybrid-batching baseline, on granite-8b after phase 6
               (before phase 9) and on the Jamba period after its phase 6
               (before its float32 model): the paged, offset
               ``flash_prefill`` against its plain version (float32 cases
               to 3e-5; bf16 at the model's heads over chunks (0, 512),
               (512, 512), (1250, 512), (1536, 226) of the first prompt
               to 3e-2 and the row limit, which a wrong page and an offset
               moved by a page must exceed), timed beside its bound, its
               plain version and SDPA with a boolean mask; the 8 requests
               through ``HybridEngine`` + ``KernelExecutor`` (chunk 512,
               budget 2048), where only the paged form, ``paged_attention``
               and (Jamba) ``ssm_scan`` may launch, every token count met
               and pool and rows reclaimed, beside phase 6's RAPID run; the
               first step with chunks and decodes again on the kernel and
               plain paths from a copy of the cache it read (3e-2); the
               first prompt prefilled in chunks against ``forward`` (3e-2,
               and with Jamba's float32 weights 1e-3 with its state rows);
               granite-8b on phase 8's lmsys trace in both modes.
               ``--only-hybrid`` runs the build and this phase alone.
 15. disagg  — disaggregated serving on granite-8b, after phase 9:
               ``DisaggEngine`` + ``KernelExecutor`` over two KV pools on
               the card (``OneCardServeConfig``: half of what the card
               holds for KV after one copy of the weights each, the
               staging pages of the prefill pool), the 8 requests served
               and reclaimed, exactly ``flash_prefill`` and
               ``paged_attention`` launched; every transfer's staging
               equal to its prefill-pool pages and its landed decode-pool
               pages equal to the staging
               (``torch.equal``; the position the join's step writes again
               within 0.1 of the slot's largest value, layer by layer,
               which the slot before it planted in its place must exceed),
               the join step's
               logits (the first-token recompute) against the prefill's
               last position (3e-2); the transfers' measured ms, bytes and
               GB/s beside the perfmodel's charge, and the engine metrics
               beside phase 6's RAPID and phase 14's hybrid; then phase 8's
               lmsys trace in disagg beside phase 14's runs of it.
               ``--only-disagg`` runs the build, phase 6 and this phase.
Phase 9 also reports, read after each run (ROADMAP C8), the plans around
every token stamped over 30 ms late net of plans.
In phases 4, 5, 7, 8, 10, 12 and 13 the decode steps run as CUDA graphs,
one per (batch size, table width), captured at a shape's first step and
replayed after it (``models/decode_graph.py``).  For each model the graph check
compares, at the decode batch, three replayed steps (one crossing a page
boundary, one at a smaller batch) with the eager ``decode_forward`` on the
same inputs and cache (expected bit-equal; fails above TOL_LOGITS), and
requires a planted stale input (a replay whose lens were not refreshed)
to differ by more; then decode steps alone, eager and replayed, give each
one's host ms, CUDA-event ms and device-busy share, with the graphs
captured, their capture seconds and the memory their pool holds.  Each
phase prints its seconds.
The last two lines are the kernels' JSON record and the result line
(each kernel's ``launches_by_path`` also holds phase 11's runs: zero for
training, the attention kernels for the trained model's serving).
"""
import asyncio
import bisect
import collections
import contextlib
import copy
import dataclasses
import gc
import http.client
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.config import SHAPES, ShapeConfig, get_config, \
    get_one_card_config, get_reduced_config, replace  # noqa: E402
from repro_torch.data import TokenPipeline  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import unified_pd as up  # noqa: E402
from repro_torch.core.executor import KernelExecutor  # noqa: E402
from repro_torch.kvcache import kv_pages_for  # noqa: E402
from repro_torch.launch import serve as serve_engine  # noqa: E402
from repro_torch.launch import serve_real  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch import train_small  # noqa: E402
from repro_torch.models import attention as attn_mod  # noqa: E402
from repro_torch.models import decode_graph as dg  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import embed_tokens, rmsnorm  # noqa: E402
from repro_torch.perfmodel.hw import H100  # noqa: E402
from repro_torch.serving.clock import RealTimeClock  # noqa: E402
from repro_torch.serving.gateway import GatewayPolicy  # noqa: E402
from repro_torch.serving.http import GatewayHTTPServer  # noqa: E402
from repro_torch.training import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.training.optimizer import OptConfig, adamw_init  # noqa: E402
from repro_torch.training.train_lib import TrainState, \
    init_train_state, make_train_step  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet; dense, at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SERVE = dict(requests=8, prompts=(128, 2048), new_tokens=(16, 64), slots=4,
             page=16, f_decode=0.5, seed=0)
DEVICE = "cuda"
F_DECODES = (1.0, 0.5, 0.25, 0.1)
TOL_F32, TOL_BF16, TOL_FUSED, TOL_LOGITS = 3e-5, 3e-2, 1e-6, 3e-2
# the Jamba period's kernel path against its plain path in float32: the
# two differ only in summation order, far below one bf16 ulp (3.9e-3)
TOL_LOGITS_F32 = 1e-3
# An MoE model's kernel-vs-plain logits hold the plain path to the kernel
# path's expert choices (``routing``).  The experts the plain path would
# have chosen itself may differ from them only at near-ties, in at most
# this share of the routed (token, choice) pairs (a pair flips when its
# expert is not among the plain path's own top k); a fault in the
# attention kernels moves the router's inputs, and the choices with them,
# by more.
TOL_FLIP_SHARE = 0.05
# bf16, per output row: max|kernel - plain| <= TOL_ROW * max|plain row|.
# The plain version computes in float32 from the bf16 inputs and rounds
# once.  The tensor-core prefill tile also rounds P to bf16 before P.V (the
# decode tile keeps P in float32), so it may differ by a little more than
# one bf16 ulp (at most 2^-7 = 7.8e-3 of a value): an emulation of that
# tile on the CPU at granite's prefill shape (32 heads, S = 1762, D = 128,
# 64-key blocks, normal bf16 inputs) read a worst row of 7.8e-3 with P in
# bf16 and 7.7e-3 with P in float32.
TOL_ROW = 1e-2
# ssm_scan is float32 throughout (the reference's own scan tolerance at the
# test shapes); at the serving shape each output row of y (one (b, t)) and
# of the final state (one (b, d)) is held to TOL_SCAN_ROW of its largest
# value.  Kernel and plain version differ only in rounding order (fused
# multiply-adds, the order of the C sum), some 1e-6 of a value; a planted
# fault moves a row by a sizeable share of it.
TOL_SCAN, TOL_SCAN_ROW = 2e-4, 1e-3
# Special-function results per clock per SM on compute capability 9.0
# (exp2, the core of expf); NVIDIA CUDA C++ documentation, throughput of
# native arithmetic instructions.
SFU_PER_CLOCK_PER_SM = 16
SLEEP_CYCLES = 2_000_000      # about 1 ms of spinning at the H100's clock


class PhaseFailed(Exception):
    pass


def say(tag, **kw):
    print(f"[{tag}] " + json.dumps(kw, default=float), flush=True)


def require(ok, what):
    if not ok:
        raise PhaseFailed(what)


# ---------------------------------------------------------------------------
# inputs, errors, timing, bounds
# ---------------------------------------------------------------------------


def randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)


def tables(gen, B, N, max_pages):
    return torch.stack([torch.randperm(N, generator=gen, device=DEVICE)
                        [:max_pages] for _ in range(B)]).int()


def excess(got, want, tol):
    """max(|got - want| - tol * (1 + |want|)): <= 0 is within atol=rtol=tol
    (numpy allclose); also returns max |got - want|."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    over = (diff - tol * (1 + want.abs())).max().item()
    return over, diff.max().item()


def row_rel_err(got, want):
    """Max over output rows (last dim) of max|got - want| / max|want|."""
    got, want = got.float(), want.float()
    D = want.shape[-1]
    diff = (got - want).abs().reshape(-1, D).amax(1)
    scale = want.abs().reshape(-1, D).amax(1).clamp_min(1e-30)
    return (diff / scale).max().item()


def time_ms(fn, iters=10):
    """Mean device time of fn() in ms, each call timed alone by CUDA
    events after a 64 MB write that evicts the 50 MB L2 cache.  A spin
    kernel (``torch.cuda._sleep``) ahead of the start event keeps the card
    busy while the host enqueues fn's launches, so the window holds device
    time only; the spin doubles until the start event is still pending
    once everything is enqueued."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device=DEVICE)
    fn()
    cycles, total, n = SLEEP_CYCLES, 0.0, 0
    while n < iters:
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        late = start.query()          # the spin ended before fn was queued
        end.synchronize()
        if late:
            cycles *= 2
            require(cycles < 1 << 32, "host enqueue outran a 2 s spin")
            continue
        total += start.elapsed_time(end)
        n += 1
    return total / iters


def host_ms(fn, iters=3):
    """Mean wall time of fn() in ms, host dispatch included, from an idle
    card to its end.  For a function of more launches than the launch
    queue holds (the plain scan: a dozen per timestep), where the host
    waits on the card while it enqueues and no spin can run ahead."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / iters


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def prefill_work(q, k, window=None):
    """Bytes (q,k,v read once, o written once) and causal multiply-add
    operations (2 per MAC) of q (B,Hq,S,D) against k (B,Hkv,S,D): query i
    against its min(i + 1, window) keys."""
    B, Hq, S, D = q.shape
    W = window or S
    pairs = B * Hq * (min(S, W) * (min(S, W) + 1) // 2 + max(S - W, 0) * W)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4 * pairs * D


def decode_work(q, k_pages, lens):
    """Bytes of q, o, the valid K/V rows, tables and lens, and the
    operations of each query head against its sequence's valid keys."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    tokens = int(lens.sum())
    nbytes = (2 * q.numel() + 2 * tokens * Hkv * D) * q.element_size() \
        + 4 * (B + B * -(-int(lens.max()) // k_pages.shape[1]))
    return nbytes, 4 * tokens * Hq * D


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

FLASH_SHAPES = [(2, 4, 2, 128, 32, None), (1, 8, 2, 257, 64, None),
                (2, 4, 4, 256, 32, 96), (1, 2, 1, 64, 16, None),
                (1, 4, 1, 96, 32, 32)]
PAGED_SHAPES = [(2, 4, 2, 32, 8, 4, 16), (3, 8, 4, 64, 16, 6, 32),
                (1, 4, 1, 16, 8, 3, 8), (4, 2, 2, 32, 4, 5, 24)]
UNIFIED_SHAPES = [(1, 2, 4, 2, 128, 32, 8, 4, 16, 0.5, None),
                  (2, 3, 4, 4, 64, 16, 8, 3, 12, 0.25, None),
                  (1, 2, 8, 2, 96, 32, 16, 2, 8, 1.0, 48),
                  (2, 1, 4, 2, 64, 32, 8, 2, 8, 0.1, None),
                  (1, 3, 4, 2, 128, 32, 16, 24, 80, 0.5, None)]  # 2 splits
# decode on the edges of the key splits (SPLIT_KEYS = 256 keys a CTA):
# (B, Hq, Hkv, D, page, max_pages, N, lens)
SPLIT_EDGE_CASES = [
    (3, 8, 4, 64, 16, 40, 128, [1, 256, 257]),       # 1 key, 1 split, +1
    (4, 4, 2, 32, 8, 70, 300, [560, 300, 20, 513]),  # empty trailing splits
    (2, 8, 1, 128, 16, 33, 80, [528, 255])]          # G = 8, D = 128
SSM_SHAPES = [(2, 64, 32, 8), (1, 128, 64, 16), (2, 96, 48, 4),
              (1, 60, 40, 8)]          # (B, L, din, ds), the reference's
# din not a multiple of 4 (the kernel's 4-byte copy path) and L not a
# multiple of its 32-step chunk
SSM_RAGGED_SHAPES = [(2, 45, 37, 16), (1, 33, 70, 8), (3, 7, 5, 4)]


def prefill_inputs(gen, B, Hq, Hkv, S, D, dtype):
    return (randn(gen, B, Hq, S, D, dtype=dtype),
            randn(gen, B, Hkv, S, D, dtype=dtype),
            randn(gen, B, Hkv, S, D, dtype=dtype))


def decode_inputs(gen, lens, Hq, Hkv, D, page, dtype, spare_pages=4):
    """q, pages and scattered block tables for sequences of ``lens``, as
    wide as the serving path's (``table_width``)."""
    B = len(lens)
    mp = dg.table_width(-(-max(lens) // page), None, page)
    N = B * mp + spare_pages
    return (randn(gen, B, Hq, D, dtype=dtype),
            randn(gen, N, page, Hkv, D, dtype=dtype),
            randn(gen, N, page, Hkv, D, dtype=dtype),
            tables(gen, B, N, mp),
            torch.tensor(lens, dtype=torch.int32, device=DEVICE))


def scan_inputs(gen, B, L, din, ds):
    """The reference's scan test inputs: xs, softplus dt, A < 0, B, C."""
    return (randn(gen, B, L, din), F.softplus(randn(gen, B, L, din)),
            -torch.exp(randn(gen, din, ds) * 0.3), randn(gen, B, L, ds),
            randn(gen, B, L, ds))


def paged_case(gen, case, dtype):
    """Decode inputs of a (B, Hq, Hkv, D, page, max_pages, N, lens) case;
    random lens in [1, max_pages*page] where lens is None."""
    B, Hq, Hkv, D, page, mp, N, lens = case
    q = randn(gen, B, Hq, D, dtype=dtype)
    kp = randn(gen, N, page, Hkv, D, dtype=dtype)
    vp = randn(gen, N, page, Hkv, D, dtype=dtype)
    tabs = tables(gen, B, N, mp)
    lens = torch.tensor(lens, device=DEVICE, dtype=torch.int32) \
        if lens else torch.randint(1, mp * page + 1, (B,), generator=gen,
                                   device=DEVICE, dtype=torch.int32)
    return q, kp, vp, tabs, lens


def unified_case(gen, shape, dtype):
    Bp, Bd, Hq, Hkv, Sp, D, page, mp, N, f, win = shape
    return (prefill_inputs(gen, Bp, Hq, Hkv, Sp, D, dtype)
            + paged_case(gen, (Bd, Hq, Hkv, D, page, mp, N, None), dtype))


def check_test_shapes(gen, dtype):
    """Every kernel against its plain version at the reference's test
    shapes and the split-edge decode cases: float32 within TOL_F32
    (TOL_SCAN for the scan); bf16 (attention only) within TOL_BF16 and
    every output row within TOL_ROW.  Returns the worst errors by kernel."""
    f32 = dtype == torch.float32
    worst = {}

    def note(name, got, want, what):
        if f32:
            tol = TOL_SCAN if name == "ssm_scan" else TOL_F32
            over, err = excess(got, want, tol)
            require(over <= 0, f"{name} f32 {what}: max err {err}")
            worst[name] = max(worst.get(name, 0.0), err)
            return
        r = within_bf16(f"{name} {what}", got, want, {})
        w = worst.setdefault(name, {"max_abs_err": 0.0,
                                    "max_row_rel_err": 0.0})
        for k in w:
            w[k] = max(w[k], r[k])

    if f32:
        for shape in SSM_SHAPES + SSM_RAGGED_SHAPES:
            args = scan_inputs(gen, *shape)
            want = ref.ssm_scan(*args)
            for g, w in zip(ss.ssm_scan(*args), want):
                note("ssm_scan", g, w, shape)
            for g, w in zip(scan_halves(*args), want):
                note("ssm_scan", g, w, (shape, "from h0"))
    for B, Hq, Hkv, S, D, win in FLASH_SHAPES:
        q, k, v = prefill_inputs(gen, B, Hq, Hkv, S, D, dtype)
        note("flash_prefill", fp.flash_prefill(q, k, v, window=win),
             ref.causal_attention(q, k, v, window=win),
             (B, Hq, Hkv, S, D, win))
    cases = [c + (None,) for c in PAGED_SHAPES]
    cases.append((2, 4, 2, 32, 8, 3, 8, [1, 24]))      # len == 1
    for case in cases + SPLIT_EDGE_CASES:
        dec = paged_case(gen, case, dtype)
        note("paged_attention", pa.paged_attention(*dec),
             ref.paged_attention(*dec), case)
    for shape in UNIFIED_SHAPES:
        args = unified_case(gen, shape, dtype)
        f, win = shape[-2:]
        got = up.unified_pd(*args, f_decode=f, window=win)
        want = ref.unified_pd(*args, window=win)
        if f32:
            for g, w in zip(got, want):
                note("unified_pd", g, w, shape)
        else:
            note("unified_pd", got, want, shape)
    return worst


def scan_halves(xs, dt, A, Bm, Cm):
    """The kernel over the first half of the steps, then over the second
    half from the first half's final state: (y, final h) of the whole."""
    m = xs.shape[1] // 2
    y0, h = ss.ssm_scan(xs[:, :m], dt[:, :m], A, Bm[:, :m], Cm[:, :m])
    y1, h = ss.ssm_scan(xs[:, m:], dt[:, m:], A, Bm[:, m:], Cm[:, m:], h)
    return torch.cat([y0, y1], dim=1), h


def main_path_shapes(cfg, reqs):
    """The attention shapes the serving run gives each kernel: the first
    prefill; a full decode batch of 4 slots; the concurrent step that
    admits request 4 while requests 1-3 decode."""
    plen = [len(r.prompt) for r in reqs]
    return {"prefill_S": plen[0],
            "decode_lens": [n + 8 for n in plen[:4]],
            "fused_S": plen[4],
            "fused_lens": [n + 8 for n in plen[1:4]],
            "Hq": cfg.num_heads, "Hkv": cfg.num_kv_heads, "D": cfg.head_dim,
            "page": SERVE["page"]}


def prefill_faults(q, k, v, window=None):
    """The plain prefill under planted faults: the last key never read;
    key BK (the first of the second k-block) read as key BK-1."""
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64], v2[:, :, 64] = k[:, :, 63], v[:, :, 63]
    return {"last_key_dropped": ref.causal_attention(
                q, k[:, :, :-1], v[:, :, :-1], window=window),
            "key_64_read_as_63": ref.causal_attention(q, k2, v2,
                                                      window=window)}


def decode_faults(q, k_pages, v_pages, tabs, lens):
    """The plain decode under planted faults: each sequence's last key
    never read; its first page read from its second page's block; and the
    keys of its first split never read (that split's pages cut out of the
    table, the length cut by SPLIT_KEYS) where it has a second split, when
    one has."""
    tabs2 = tabs.clone()
    tabs2[:, 0] = tabs[:, 1]
    page = k_pages.shape[1]
    require(pa.SPLIT_KEYS % page == 0, f"page {page} does not divide a split")
    cut = pa.SPLIT_KEYS // page
    long = lens > pa.SPLIT_KEYS
    tabs3 = torch.where(long[:, None], tabs.roll(-cut, dims=1), tabs)
    lens3 = torch.where(long, lens - pa.SPLIT_KEYS, lens)
    faults = {"last_key_dropped": ref.paged_attention(q, k_pages, v_pages,
                                                      tabs, lens - 1),
              "page_0_read_as_page_1": ref.paged_attention(
                  q, k_pages, v_pages, tabs2, lens)}
    if bool(long.any()):
        faults["split_0_skipped"] = ref.paged_attention(q, k_pages, v_pages,
                                                        tabs3, lens3)
    return {**faults, **head_group_faults(q, k_pages, v_pages, tabs, lens)}


def head_group_faults(q, k_pages, v_pages, tabs, lens):
    """Where G = Hq/Hkv > 8, the plain decode as a tile that held only 8
    heads of a group would compute it: the heads past the 8th of each group
    never written (zero), or computed from the next kv head's K/V (the
    pages with their kv heads rolled by one).  None for G <= 8."""
    B, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    G = Hq // Hkv
    if G <= 8:
        return {}
    require(Hkv > 1, "the wrong-K/V fault needs two kv heads")
    sound = ref.paged_attention(q, k_pages, v_pages, tabs, lens)
    other = ref.paged_attention(q, k_pages.roll(1, dims=2),
                                v_pages.roll(1, dims=2), tabs, lens)
    unwritten, wrong = sound.clone(), sound.clone()
    unwritten.view(B, Hkv, G, D)[:, :, 8:] = 0
    wrong.view(B, Hkv, G, D)[:, :, 8:] = other.view(B, Hkv, G, D)[:, :, 8:]
    return {"heads_past_8_unwritten": unwritten,
            "heads_past_8_from_wrong_kv": wrong}


def within_bf16(name, got, want, faults):
    """Errors of ``got`` against ``want`` (a tensor or a tuple of them).
    Fails the phase beyond atol=rtol=TOL_BF16, beyond TOL_ROW of any output
    row, or when a planted fault (``faults``: name -> the plain outputs
    under that fault) does not exceed TOL_ROW, i.e. would go unseen."""
    def rows(a, b):
        return max(row_rel_err(x, y) for x, y in zip(a, b))

    got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
    abs_err = 0.0
    for g, w in zip(got, want):
        over, err = excess(g, w, TOL_BF16)
        require(over <= 0, f"{name} bf16 max err {err}")
        abs_err = max(abs_err, err)
    row = rows(got, want)
    require(row <= TOL_ROW, f"{name} bf16 row error {row} > {TOL_ROW}")
    seen = {f: rows(out if isinstance(out, tuple) else (out,), want)
            for f, out in faults.items()}
    require(all(e > TOL_ROW for e in seen.values()),
            f"{name}: a planted fault stays within {TOL_ROW}: {seen}")
    return {"max_abs_err": abs_err, "max_row_rel_err": row,
            "fault_row_rel_err": seen}


def kernel_record(check, run, plain, library, work, shape):
    """``check``'s errors; times of the kernel, its plain version and the
    library call (if any); and the bound of the work (bytes, operations)
    in bf16."""
    bound, by = bound_ms(*work, torch.bfloat16)
    return {**check, "ms": time_ms(run), "plain_ms": time_ms(plain),
            "library_ms": time_ms(library) if library else None,
            "bound_ms": bound, "bound_by": by, "shape": shape}


def check_main_path_shapes(gen, shapes):
    """bf16 accuracy and timings at the serving shapes; the fused kernel
    against the standalone kernels in f32.  Returns per-kernel records."""
    Hq, Hkv, D, page = (shapes[k] for k in ("Hq", "Hkv", "D", "page"))
    bf16, f_dec = torch.bfloat16, SERVE["f_decode"]
    recs = {}

    q, k, v = prefill_inputs(gen, 1, Hq, Hkv, shapes["prefill_S"], D, bf16)
    recs["flash_prefill"] = kernel_record(
        within_bf16("flash_prefill", fp.flash_prefill(q, k, v),
                    ref.causal_attention(q, k, v), prefill_faults(q, k, v)),
        lambda: fp.flash_prefill(q, k, v),
        lambda: ref.causal_attention(q, k, v),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True),
        prefill_work(q, k), f"q{list(q.shape)} k{list(k.shape)} bf16")

    dec = decode_inputs(gen, shapes["decode_lens"], Hq, Hkv, D, page, bf16)
    recs["paged_attention"] = kernel_record(
        within_bf16("paged_attention", pa.paged_attention(*dec),
                    ref.paged_attention(*dec), decode_faults(*dec)),
        lambda: pa.paged_attention(*dec), lambda: ref.paged_attention(*dec),
        None, decode_work(dec[0], dec[1], dec[4]),
        f"q{list(dec[0].shape)} lens{shapes['decode_lens']} page {page} bf16")
    recs["paged_attention"]["splits"] = pa.split_count(dec[3].shape[1], page)
    recs["paged_attention"]["ctas"] = (recs["paged_attention"]["splits"]
                                       * Hkv * dec[0].shape[0])

    def fused_args(dtype):
        return (prefill_inputs(gen, 1, Hq, Hkv, shapes["fused_S"], D, dtype)
                + decode_inputs(gen, shapes["fused_lens"], Hq, Hkv, D, page,
                                dtype))

    args = fused_args(bf16)
    got, want = up.unified_pd(*args, f_decode=f_dec), ref.unified_pd(*args)
    faults = {**{f"prefill_{n}": (o, want[1])
                 for n, o in prefill_faults(*args[:3]).items()},
              **{f"decode_{n}": (want[0], o)
                 for n, o in decode_faults(*args[3:]).items()}}
    check = within_bf16("unified_pd", got, want, faults)
    pb, pf = prefill_work(args[0], args[1])
    db, df = decode_work(args[3], args[4], args[7])
    recs["unified_pd"] = kernel_record(
        check, lambda: up.unified_pd(*args, f_decode=f_dec),
        lambda: ref.unified_pd(*args), None, (pb + db, pf + df),
        f"prefill q{list(args[0].shape)} + decode q{list(args[3].shape)} "
        f"lens{shapes['fused_lens']} bf16")
    recs["unified_pd"]["splits"] = pa.split_count(args[6].shape[1], page)

    # bf16: the fused kernel runs the standalone kernels' tiles, so its
    # outputs are theirs bit for bit, whatever f_decode is
    alone = (fp.flash_prefill(*args[:3]), pa.paged_attention(*args[3:]))
    for f in F_DECODES:
        for got, want in zip(up.unified_pd(*args, f_decode=f), alone):
            require(torch.equal(got, want), f"unified_pd bf16 != standalone "
                    f"at f_decode={f}: max err {excess(got, want, 0)[1]}")
    recs["unified_pd"]["fused_vs_standalone_bf16_bit_equal"] = True

    # float32: the fused kernel == the standalone kernels, any f_decode
    args = fused_args(torch.float32)
    alone = (fp.flash_prefill(*args[:3]), pa.paged_attention(*args[3:]))
    fused_err = 0.0
    for f in F_DECODES:
        for got, want in zip(up.unified_pd(*args, f_decode=f), alone):
            over, err = excess(got, want, TOL_FUSED)
            require(over <= 0, f"unified_pd != standalone at f_decode={f}: "
                    f"max err {err}")
            fused_err = max(fused_err, err)
    recs["unified_pd"]["fused_vs_standalone_f32_max_err"] = fused_err
    recs["unified_pd"]["persistent"] = persistent_sweep(fused_args(bf16))
    return recs


def traced_ms(run, iters=10):
    """``run(trace)`` launches unified_pd with a trace.  Over ``iters``
    launches, each after an L2 flush: the mean times from the first CTA's
    start to the last decode tile's end and to the last prefill tile's end
    (ms, the card's global clock), %nsmid, and the SM ids that ran a
    CTA."""
    trace = up.new_trace(DEVICE)
    fresh = trace.clone()
    flush = torch.empty(64 << 20, dtype=torch.int8, device=DEVICE)
    run(trace)
    dec = pre = 0.0
    sms, nsmid = set(), 0
    for _ in range(iters):
        trace.copy_(fresh)
        flush.zero_()
        run(trace)
        tr = trace.tolist()
        dec += (tr[up.TRACE_DECODE_END] - tr[up.TRACE_START]) / 1e6
        pre += (tr[up.TRACE_PREFILL_END] - tr[up.TRACE_START]) / 1e6
        nsmid = max(nsmid, tr[up.TRACE_NSMID])
        sms |= {64 * w + b for w in range(up.TRACE_LEN - up.TRACE_SM_SET)
                for b in range(64) if tr[up.TRACE_SM_SET + w] >> b & 1}
    return dec / iters, pre / iters, nsmid, sms


def concurrent_ms(fns):
    """Device time of the calls ``fns`` launched together, one stream
    each, from one start event to the end of the last."""
    streams = [torch.cuda.Stream() for _ in fns]

    def run():
        go = torch.cuda.Event()
        go.record()
        here = torch.cuda.current_stream()
        for st, fn in zip(streams, fns):
            st.wait_event(go)
            with torch.cuda.stream(st):
                fn()
        for st in streams:
            here.wait_stream(st)
    return time_ms(run)


def persistent_sweep(args):
    """The persistent unified_pd at the fused step's bf16 inputs: its grid
    and CTAs an SM; at each f_decode in F_DECODES the SMs that take decode
    first, the kernel's time, and from its trace the decode-done and
    prefill-done times after its first CTA starts; the SM ids its CTAs ran
    on (they must be 0 .. SMs-1, which the share is cut from); and the
    yardsticks at the same inputs: flash_prefill alone on the prefill,
    paged_attention alone on the decodes, their sum, and the two launched
    together on two streams."""
    q_p, q_d, kp, tabs = args[0], args[3], args[4], args[6]
    Bp, Hq, Sp, D = q_p.shape
    Hkv, page = kp.shape[2], kp.shape[1]
    G, splits = Hq // Hkv, pa.split_count(tabs.shape[1], page)
    tiles = Bp * Hq * -(-Sp // fp.BLOCK_Q) + q_d.shape[0] * Hkv * splits
    ctas = up.ctas_per_sm(build.dtype_code(q_p), D, G, splits)
    sms = up.sm_count(q_p.device)
    sweep, seen, nsmid = {}, set(), 0
    for f in F_DECODES:
        dec, pre, n, ids = traced_ms(
            lambda tr: up.unified_pd(*args, f_decode=f, trace=tr))
        seen |= ids
        nsmid = max(nsmid, n)
        sweep[str(f)] = {"decode_sms": up.decode_sms(f, sms),
                         "time_ms": time_ms(
                             lambda: up.unified_pd(*args, f_decode=f)),
                         "decode_done_ms": dec, "prefill_done_ms": pre}
    require(seen == set(range(sms)), f"unified_pd's CTAs ran on SM ids "
            f"{sorted(seen)}, not 0..{sms - 1}")
    flash = time_ms(lambda: fp.flash_prefill(*args[:3]))
    paged = time_ms(lambda: pa.paged_attention(*args[3:]))
    both = concurrent_ms([lambda: fp.flash_prefill(*args[:3]),
                          lambda: pa.paged_attention(*args[3:])])
    at = sweep[str(SERVE["f_decode"])]["time_ms"]
    return {"grid": up.grid_size(tiles, ctas, sms), "tiles": tiles,
            "ctas_per_sm": ctas, "sms": sms, "nsmid": nsmid,
            "smid_span": [min(seen), max(seen), len(seen)],
            "f_decode": sweep,
            "flash_prefill_alone_ms": flash, "paged_attention_alone_ms": paged,
            "alone_sum_ms": flash + paged, "two_streams_ms": both,
            "no_slower_than_sum": at <= flash + paged,
            "decode_done_1_below_0_1": sweep["1.0"]["decode_done_ms"]
            < sweep["0.1"]["decode_done_ms"]}


def spin_gated(launchers, launches):
    """Each (stream, fn) of ``launchers`` called ``launches`` times,
    interleaved, every call on its stream, all queued behind a spin on
    every stream so that the queues drain together.  The spin starts at
    about 20 ms and doubles until it is still running on every stream once
    everything is queued.  Returns each launcher's outputs."""
    cycles = 20 * SLEEP_CYCLES
    while True:
        outs = [[] for _ in launchers]
        torch.cuda.synchronize()
        spun = []
        for st, _ in launchers:
            with torch.cuda.stream(st):
                torch.cuda._sleep(cycles)
                spun.append(torch.cuda.Event())
                spun[-1].record()
        for _ in range(launches):
            for (st, fn), out in zip(launchers, outs):
                with torch.cuda.stream(st):
                    out.append(fn())
        overlapped = not any(ev.query() for ev in spun)
        torch.cuda.synchronize()
        if overlapped:
            return outs
        cycles *= 2
        require(cycles < 1 << 32, "host enqueue outran a 2 s spin")


def rows_and_repeats(what, outs, want):
    """The worst row error of the outputs ``outs`` (a list of tensors or
    of tuples of them) against ``want``; fails beyond TOL_ROW or when two
    of them differ."""
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    want = want if isinstance(want, tuple) else (want,)
    err = max(row_rel_err(g, w) for o in outs for g, w in zip(o, want))
    require(err <= TOL_ROW, f"{what}: row error {err} > {TOL_ROW}")
    require(all(torch.equal(g, g0) for o in outs for g, g0 in zip(o, outs[0])),
            f"{what}: repeated launches differ")
    return err


def check_two_streams(gen, shapes, launches=20):
    """paged_attention on two streams at once, each with its own inputs
    (the serving decode batch, and one of about half its lengths),
    ``launches`` times each (``spin_gated``).  Every output within TOL_ROW
    of its plain version and equal to its stream's first (the merge order
    is fixed), and each stream with its own arrival counters.  Then the
    same run with one counter buffer planted for both streams, the fault
    that per-stream counters repair: its errors are recorded, not
    required, since whether the two launches race on one (sequence, kv
    head) counter depends on how the card schedules them.  Then
    unified_pd, the persistent kernel, on one stream beside
    paged_attention on the other, which holds some of its SMs while it
    runs: both within TOL_ROW, repeats equal.  Returns the errors."""
    Hq, Hkv, D, page = (shapes[k] for k in ("Hq", "Hkv", "D", "page"))
    lens = shapes["decode_lens"]
    decs = [decode_inputs(gen, ls, Hq, Hkv, D, page, torch.bfloat16)
            for ls in (lens, [n // 2 + 1 for n in lens])]
    wants = [ref.paged_attention(*dec) for dec in decs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]

    def run():
        return spin_gated([(st, lambda dec=dec: pa.paged_attention(*dec))
                           for st, dec in zip(streams, decs)], launches)

    outs = run()
    bufs = {pa.counters(decs[0][0].device, 1, st.cuda_stream).data_ptr()
            for st in streams}
    require(len(bufs) == 2, "two streams share one counter buffer")
    errs = [rows_and_repeats("paged_attention on two streams", out, want)
            for out, want in zip(outs, wants)]
    shared = torch.zeros(4096, dtype=torch.int32, device=DEVICE)
    per_stream, pa.counters = pa.counters, lambda device, n, stream: shared
    try:
        fault_outs = run()
    finally:
        pa.counters = per_stream
    fault_errs = [max(row_rel_err(o, want) for o in out)
                  for out, want in zip(fault_outs, wants)]

    fused = (prefill_inputs(gen, 1, Hq, Hkv, shapes["fused_S"], D,
                            torch.bfloat16)
             + decode_inputs(gen, shapes["fused_lens"], Hq, Hkv, D, page,
                             torch.bfloat16))
    u_outs, p_outs = spin_gated(
        [(streams[0], lambda: up.unified_pd(*fused,
                                            f_decode=SERVE["f_decode"])),
         (streams[1], lambda: pa.paged_attention(*decs[0]))], launches)
    beside = {"unified_pd": rows_and_repeats(
                  "unified_pd beside paged_attention", u_outs,
                  ref.unified_pd(*fused)),
              "paged_attention": rows_and_repeats(
                  "paged_attention beside unified_pd", p_outs, wants[0])}
    return {"launches_per_stream": launches, "max_row_rel_err": errs,
            "tolerance_row": TOL_ROW,
            "shared_buffer_fault": {
                "max_row_rel_err": fault_errs,
                "beyond_tolerance": [not e <= TOL_ROW for e in fault_errs],
                "repeats_differ": [not all(torch.equal(o, out[0])
                                           for o in out)
                                   for out in fault_outs]},
            "unified_pd_beside_paged_attention": beside}


def kernel_scaling(gen, shapes):
    """Where the two redesigned kernels' time goes at the serving widths:
    paged_attention over the serving table width with 1-token sequences
    (its fixed cost: launch, table, merges), at the serving lengths, and
    over twice the lengths and table width (its marginal cost per byte);
    flash_prefill at 4096 tokens and at D = 64, beside SDPA on the same
    inputs."""
    Hq, Hkv, D, page = (shapes[k] for k in ("Hq", "Hkv", "D", "page"))
    bf16, lens = torch.bfloat16, shapes["decode_lens"]
    B, mp = len(lens), -(-max(lens) // page)
    out = {}
    for name, ls, width in (("decode_len_1", [1] * B, mp),
                            ("decode_serving", lens, mp),
                            ("decode_2x", [2 * n for n in lens], 2 * mp)):
        dec = paged_case(gen, (B, Hq, Hkv, D, page, width, B * width + 4,
                               ls), bf16)
        nbytes = decode_work(dec[0], dec[1], dec[4])[0]
        ms = time_ms(lambda: pa.paged_attention(*dec))
        out[name] = {"ms": ms, "bytes": nbytes, "gb_per_s": nbytes / ms / 1e6,
                     "splits": pa.split_count(width, page)}
    for name, S, d in (("prefill_4096", 4096, D),
                       ("prefill_d64", shapes["prefill_S"], 64)):
        q, k, v = prefill_inputs(gen, 1, Hq, Hkv, S, d, bf16)
        ms = time_ms(lambda: fp.flash_prefill(q, k, v))
        out[name] = {"ms": ms, "tflop_per_s": prefill_work(q, k)[1] / ms / 1e9,
                     "sdpa_ms": time_ms(lambda: F.scaled_dot_product_attention(
                         q, k, v, is_causal=True, enable_gqa=True)),
                     "shape": f"q{list(q.shape)} k{list(k.shape)} bf16"}
    return out


# ---------------------------------------------------------------------------
# phase 4: serving at full width
# ---------------------------------------------------------------------------


def rel_err(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


@contextlib.contextmanager
def routing(mode, log):
    """Hold the plain path to the kernel path's expert choices.  With
    ``mode`` "record", each MoE layer's choices (``moe.choose_experts``)
    are appended to ``log["choices"]``; with "replay", each call takes the
    next recorded choices, in the same order, with its own gates at them,
    and counts in ``log["flips"]`` the (token, choice) pairs whose expert
    it would not have chosen among its own top k, and in
    ``log["order_flips"]`` those it would have put at another rank (a
    swap of two chosen experts counts two there and none in ``flips``:
    the same experts serve the token).  A router's near-tie flips under
    any rounding, and
    one flipped choice moves a token's output by its gate times an
    expert's, far past the logits limit whichever side is right; with the
    choices held, the logits differ by the attention kernels alone.  A
    model without MoE layers makes no call."""
    choose = moe_mod.choose_experts

    def record(probs, k):
        gates, experts = choose(probs, k)
        log["choices"].append(experts)
        return gates, experts

    def replay(probs, k):
        experts = log["choices"].pop(0)
        mine = choose(probs, k)[1]
        chosen = (mine[:, :, None] == experts[:, None, :]).any(-1)
        log["flips"] += int((~chosen).sum())
        log["order_flips"] += int((mine != experts).sum())
        log["pairs"] += experts.numel()
        return probs.gather(1, experts), experts

    moe_mod.choose_experts = record if mode == "record" else replay
    try:
        yield
    finally:
        moe_mod.choose_experts = choose


def first_steps_kernel_vs_plain(model, reqs, page, pair=(0, 1)):
    """The run's first prefill (request ``pair[0]``) and first concurrent
    step (prefill request ``pair[1]`` + decode request ``pair[0]``),
    through the kernel path and the plain path on the same inputs and
    cache contents (a ring of the first W / page blocks under a window),
    the plain path on the kernel path's expert choices (``routing``).
    Both paths prefill as the serving run does (``return_aux``: an MoE
    layer's inference capacity policy).  Returns the errors and the
    routing flips."""
    cfg = model.cfg
    window = cfg.sliding_window
    log = {"choices": [], "flips": 0, "order_flips": 0, "pairs": 0}
    r0, r1 = reqs[pair[0]], reqs[pair[1]]
    n0 = len(r0.prompt)
    blocks = len(attn_mod.ring_table(range(kv_pages_for(n0 + 1, page)),
                                     window, page))
    cache = tf.init_cache(cfg, blocks, page, 1, device=DEVICE)
    tab = torch.arange(blocks, device=DEVICE, dtype=torch.int32)[None]
    slot = torch.zeros(1, device=DEVICE, dtype=torch.int64)
    p0 = torch.tensor(r0.prompt[None], device=DEVICE)
    pos0 = torch.arange(n0, device=DEVICE)[None]
    with routing("record", log):
        lk, aux = tf.forward(model, p0, pos0, impl="kernel", return_aux=True,
                             last_only=True)
    with routing("replay", log):
        lr = tf.forward(model, p0, pos0, impl="ref", return_aux=True,
                        last_only=True)[0]
    tf.write_prefill_to_cache(cache, aux, tab, slot, window=window)
    del aux
    tok = tf.greedy_sample(lk, cfg.vocab_size)
    lens = torch.tensor([n0], device=DEVICE, dtype=torch.int32)
    p1 = torch.tensor(r1.prompt[None], device=DEVICE)
    pos1 = torch.arange(len(r1.prompt), device=DEVICE)[None]
    outs = {}
    for impl, mode in (("kernel", "record"), ("ref", "replay")):
        c = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        with routing(mode, log):
            p_logits, _, d_logits, _ = tf.fused_pd_forward(
                model, p1, pos1, tok, lens[:, None], c, tab, lens, slot,
                f_decode=SERVE["f_decode"], impl=impl)
        outs[impl] = (p_logits, d_logits)
        del c
    return {"first_prefill": rel_err(lk, lr),
            "fused_prefill": rel_err(outs["kernel"][0], outs["ref"][0]),
            "fused_decode": rel_err(outs["kernel"][1], outs["ref"][1])}, \
        {"routing_flips": log["flips"], "order_flips": log["order_flips"],
         "routed_pairs": log["pairs"]}


def logits_fault(model, prompt):
    """How far a planted scan fault moves the prompt's last logits on the
    plain path: the plain scan of the first Mamba layer skips the update
    of the last timestep (dt = 0 there), as a kernel whose loop ends one
    step early would.  A limit on kernel-vs-plain logits that this stays
    within could not see such a kernel."""
    pos = torch.arange(len(prompt), device=DEVICE)[None]
    toks = torch.tensor(prompt[None], device=DEVICE)
    sound = tf.forward(model, toks, pos, impl="ref", last_only=True)
    scan, calls = ref.ssm_scan, []

    def skip_last_update(xs, dt, A, Bm, Cm, h0=None):
        if not calls:
            dt = dt.clone()
            dt[:, -1] = 0
        calls.append(1)
        return scan(xs, dt, A, Bm, Cm, h0)

    ref.ssm_scan = skip_last_update
    try:
        faulted = tf.forward(model, toks, pos, impl="ref", last_only=True)
    finally:
        ref.ssm_scan = scan
    require(len(calls) == sum(b.kind == "mamba" for b in model.layers),
            "the planted fault did not reach the plain scan")
    return rel_err(faulted, sound)


def window_logits_fault(model, prompt):
    """The held-routing check of ``first_steps_kernel_vs_plain`` on
    ``prompt``'s prefill, with a planted fault in the plain path: its
    causal attention ignores the window in every layer, as a prefill
    kernel whose window culling was lost would.  Returns how far the
    faulted plain logits lie from the kernel path's, and the routing
    flips of the faulted run; a limit on kernel-vs-plain logits that this
    stays within could not see such a kernel."""
    cfg = model.cfg
    log = {"choices": [], "flips": 0, "order_flips": 0, "pairs": 0}
    pos = torch.arange(len(prompt), device=DEVICE)[None]
    toks = torch.tensor(prompt[None], device=DEVICE)
    with routing("record", log):
        lk = tf.forward(model, toks, pos, impl="kernel", return_aux=True,
                        last_only=True)[0]
    attn, windows = ref.causal_attention, []

    def window_ignored(q, k, v, *, window=None):
        windows.append(window)
        return attn(q, k, v)

    ref.causal_attention = window_ignored
    try:
        with routing("replay", log):
            faulted = tf.forward(model, toks, pos, impl="ref",
                                 return_aux=True, last_only=True)[0]
    finally:
        ref.causal_attention = attn
    require(len(windows) == cfg.num_layers and
            set(windows) == {cfg.sliding_window},
            f"the planted fault reached windows {windows}")
    return rel_err(lk, faulted), {"routing_flips": log["flips"],
                                  "order_flips": log["order_flips"],
                                  "routed_pairs": log["pairs"]}


def path_kernels(cfg):
    """The kernels a serving run of ``cfg`` launches: the three attention
    kernels, and ssm_scan when it has Mamba layers; none for xLSTM, whose
    mixers have no kernel in the reference."""
    kinds = {cfg.mixer_at(i) for i in range(cfg.num_layers)}
    names = set()
    if "attn" in kinds:
        names |= {"flash_prefill", "paged_attention", "unified_pd"}
    if "mamba" in kinds:
        names.add("ssm_scan")
    return names


def serving_requests(cfg):
    return serve_real.make_requests(cfg, SERVE["requests"], SERVE["seed"],
                                    SERVE["prompts"], SERVE["new_tokens"])


def init_full(cfg):
    """Random weights of ``cfg``, in its dtype, on the card from a seeded
    generator; prints the weights' bytes and the peak memory of the init
    (each weight is drawn in float32 and cast alone)."""
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    model = tf.init_model(cfg, seed=SERVE["seed"], device=DEVICE)
    torch.cuda.synchronize()
    say("serve", phase="init", config=cfg.name, layers=cfg.num_layers,
        layer_pattern=cfg.layer_pattern, ffn_pattern=cfg.ffn_pattern,
        d_model=cfg.d_model, dtype=cfg.dtype,
        weights_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
        init_peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        init_s=time.perf_counter() - t)
    return model


def serve_full(model, reqs=None, pairs=((0, 1),)):
    """The serving run: ``reqs`` (default: ``serving_requests``) after a
    warm-up, with the launch counts of the run alone; then kernel path
    against plain path on the first steps of each (prefill, then fused)
    request pair of ``pairs``.  Returns the launch counts, the run's
    summary and each request's tokens."""
    cfg = model.cfg
    # warm-up: two short requests exercise prefill, fused and decode steps
    warm = serve_real.make_requests(cfg, 2, SERVE["seed"] + 1, (32, 64),
                                    (3, 3))
    serve_real.serve(model, warm, slots=SERVE["slots"], page=SERVE["page"],
                     f_decode=SERVE["f_decode"])
    reqs = reqs or serving_requests(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=SERVE["slots"],
                              page=SERVE["page"], f_decode=SERVE["f_decode"])
    torch.cuda.synchronize()
    launches = ops.launches()
    summary = serve_real.summarize(result)
    say("serve", phase="run", config=cfg.name, launches=launches, **summary,
        prompt_lens=[len(r.prompt) for r in reqs],
        max_new=[r.max_new for r in reqs],
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    require(summary["requests"] == len(reqs), "not every request was "
            "served")
    require(all(len(r.tokens) == r.max_new and
                all(0 <= x < cfg.vocab_size for x in r.tokens)
                for r in result["requests"]), "bad generated tokens")
    require(result["pool_reclaimed"], "KV pool not fully reclaimed")
    require(result["state_slots_reclaimed"], "decode slots not reclaimed")
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == path_kernels(cfg),
            f"{cfg.name}: launched {sorted(launched)}, its path runs "
            f"{sorted(path_kernels(cfg))}: {launches}")
    for pair in pairs:
        errs, flips = first_steps_kernel_vs_plain(model, reqs, SERVE["page"],
                                                  pair)
        share = flips["routing_flips"] / max(flips["routed_pairs"], 1)
        say("serve", phase="kernel_vs_plain_logits", config=cfg.name,
            requests=list(pair),
            prompt_lens=[len(reqs[i].prompt) for i in pair],
            metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS,
            plain_path_on_kernel_path_expert_choices=bool(flips[
                "routed_pairs"]), flip_share=share,
            flip_share_limit=TOL_FLIP_SHARE, **flips, **errs)
        require(all(e < TOL_LOGITS for e in errs.values()),
                f"logits differ between kernel and plain paths: {errs}")
        require(share < TOL_FLIP_SHARE, f"the plain path would have chosen "
                f"other experts for {share:.2%} of the routed pairs")
    return launches, summary, {r.rid: r.tokens for r in reqs}


def jamba_period():
    """One full-width Jamba-1.5-Large period without experts, the
    config's one-card cut (``configs/jamba_1_5_large_398b.py``): depth
    72 -> 8 (one whole period: 7 Mamba layers and the attention layer at
    position 4), and the MoE FFN of odd layers -> Jamba's dense FFN (d_ff
    24576) on every layer; one period with its 4 MoE layers would be 90.5
    GB of bf16.  9.0 B parameters, 18 GB."""
    return get_one_card_config("jamba-1.5-large-398b")


def first_scan_inputs(model, prompt):
    """The scan inputs of ``prompt`` at the model's first layer, a Mamba
    layer, through ``mamba.scan_args`` as the prefill computes them: xs, dt,
    A, Bm, Cm."""
    cfg, blk = model.cfg, model.layers[0]
    require(blk.kind == "mamba", f"{cfg.name}: layer 0 is not Mamba")
    x = embed_tokens(model, torch.tensor(prompt[None], device=DEVICE))
    xz = rmsnorm(x, blk.norm1, cfg.norm_eps) @ blk.mixer.in_proj
    return mamba_mod.scan_args(blk.mixer, cfg, xz)


def scan_faults(xs, dt, A, Bm, Cm, y):
    """The plain scan under planted faults at t = L/2: that step's update
    skipped (dt = 0 there: decay 1, input 0); the state reset to zero
    before it; and the final state taken one step early (``y`` is the
    sound plain output)."""
    m = xs.shape[1] // 2
    dt2 = dt.clone()
    dt2[:, m] = 0
    y0, _ = ref.ssm_scan(xs[:, :m], dt[:, :m], A, Bm[:, :m], Cm[:, :m])
    y1, h1 = ref.ssm_scan(xs[:, m:], dt[:, m:], A, Bm[:, m:], Cm[:, m:])
    _, h_early = ref.ssm_scan(xs[:, :-1], dt[:, :-1], A, Bm[:, :-1],
                              Cm[:, :-1])
    return {"update_skipped": ref.ssm_scan(xs, dt2, A, Bm, Cm),
            "state_reset": (torch.cat([y0, y1], dim=1), h1),
            "final_state_early": (y, h_early)}


def scan_work(xs, A, sfu_per_s):
    """Bytes (xs, dt, y; Bm, Cm; A; h, each once, float32) and the time of
    the L*din*ds exponentials at the special-function rate."""
    B, L, din = xs.shape
    ds = A.shape[1]
    nbytes = 4 * (3 * B * L * din + 2 * B * L * ds + din * ds + B * din * ds)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_exp = B * L * din * ds / sfu_per_s
    return 1e3 * max(t_bytes, t_exp), ("bytes" if t_bytes >= t_exp
                                       else "operations")


def sfu_rate():
    """exp2 results per second: SMs x SFU_PER_CLOCK_PER_SM x max SM clock
    (nvidia-smi)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60).stdout.split()
    require(out, "nvidia-smi gave no max SM clock")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SFU_PER_CLOCK_PER_SM * float(out[0]) * 1e6, sms, float(out[0])


def scan_errors(what, got, want, faults):
    """Errors of the scan outputs ``got`` against ``want`` (y, final h):
    fails beyond TOL_SCAN_ROW of any output row, or when a planted fault
    (``faults``: name -> the plain outputs under it) stays within it."""
    abs_err = max(excess(g, w, TOL_SCAN)[1] for g, w in zip(got, want))
    row = max(row_rel_err(g, w) for g, w in zip(got, want))
    require(row <= TOL_SCAN_ROW,
            f"ssm_scan {what}: row error {row} > {TOL_SCAN_ROW}")
    seen = {f: max(row_rel_err(g, w) for g, w in zip(out, want))
            for f, out in faults.items()}
    require(all(e > TOL_SCAN_ROW for e in seen.values()), f"ssm_scan {what}: "
            f"a planted fault stays within {TOL_SCAN_ROW}: {seen}")
    return {"max_abs_err": abs_err, "max_row_rel_err": row,
            "fault_row_rel_err": seen}


def check_scan_serving_shape(gen, model, prompt):
    """ssm_scan against its plain version at the first prompt's scan
    inputs, and again with a random A (as ``scan_inputs`` draws it): whole,
    and in two halves, the second from the first's final state; every
    output row within TOL_SCAN_ROW, every planted fault beyond it (for the
    halves: h0 ignored, the state reset to zero).  Times the kernel and
    the plain scan; the bound, the kernel's share of it, and the lane and
    stage counts of the instance that ran."""
    args = first_scan_inputs(model, prompt)
    ds = args[2].shape[1]
    rand_a = -torch.exp(randn(gen, *args[2].shape) * 0.3)
    rec = {}
    for name, a in (("model_A", args), ("random_A", args[:2] + (rand_a,)
                                        + args[3:])):
        want = ref.ssm_scan(*a)
        faults = scan_faults(*a, want[0])
        rec[name] = {**scan_errors(name, ss.ssm_scan(*a), want, faults),
                     "from_h0": scan_errors(
                         f"{name} from h0", scan_halves(*a), want,
                         {"h0_ignored": faults["state_reset"]}),
                     "ms": time_ms(lambda: ss.ssm_scan(*a))}
    rate, sms, mhz = sfu_rate()
    bound, by = scan_work(args[0], args[2], rate)
    main = rec.pop("model_A")
    return {**main, **rec, "plain_ms": host_ms(lambda: ref.ssm_scan(*args)),
            "library_ms": None, "bound_ms": bound, "bound_by": by,
            "bound_share": bound / main["ms"], "lanes": ss.LANES[ds],
            "stages": ss.STAGES,
            "sfu_per_s": rate, "sms": sms, "max_sm_mhz": mhz,
            "shape": f"xs{list(args[0].shape)} ds {ds} f32"}


# ---------------------------------------------------------------------------
# phase 6: RAPID-Serve's engine on the card
# ---------------------------------------------------------------------------

ENGINE_KEYS = ("tokens", "span_s", "wall_s", "tokens_per_s", "ttft_mean_s",
               "ttft_p95_s", "itl_mean_s", "itl_p95_s")


def engine_full(model, real, reqs=None, arrivals=None, keep=None):
    """The serving run's requests (default: ``serving_requests``, all at
    t = 0; or arriving at ``arrivals``, rid -> s) through ``RapidEngine``
    + ``KernelExecutor`` with the pool the scheduler sizes from ``H100``;
    ``real`` is serve_real's (summary, tokens by rid) of the same
    requests, or None.  Returns the launch counts of the run, and puts
    the run's summary and tokens into ``keep`` when it is given."""
    cfg = model.cfg
    reqs = reqs or serving_requests(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    result = serve_engine.serve_engine(model, reqs,
                                       serve_engine.serve_config(),
                                       arrivals=arrivals)
    torch.cuda.synchronize()
    launches = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    s = serve_engine.summarize(result)
    say("engine", phase="pool", config=cfg.name,
        pool_blocks=s["pool_blocks"], spare_pages=result["spare_pages"],
        pool_gb=s["pool_bytes"] / 1e9,
        mem_free_gb_after_pool=s["mem_free_after_pool"] / 1e9,
        mem_total_gb=result["mem_total"] / 1e9, peak_gb=peak / 1e9)
    say("engine", phase="run", config=cfg.name, kernel_launches=launches,
        **{k: v for k, v in s.items()
           if k not in ("pool_blocks", "pool_bytes", "mem_free_after_pool")})
    if arrivals:
        say("engine", phase="arrivals", config=cfg.name,
            arrivals_s=[arrivals[r.rid] for r in reqs],
            prompt_lens=[len(r.prompt) for r in reqs],
            max_new=[r.max_new for r in reqs],
            first_launch_s={e["rids"][0]: e["t_start"]
                            for e in reversed(result["log"])},
            ttft_s=[r.ttft for r in result["requests"]])
        require(all(e["t_start"] >= arrivals[e["rids"][0]]
                    for e in result["log"] if e["kind"] != "decode"),
                f"engine {cfg.name}: a prompt ran before it arrived")
    if real is not None:
        real_summary, real_tokens = real
        same = sum(result["tokens"].get(r.rid) == real_tokens[r.rid]
                   for r in reqs)
        say("engine", phase="beside_serve_real", config=cfg.name,
            clock={"engine": "engine clock (measured launches)",
                   "serve_real": "host wall clock"},
            engine={k: s[k] for k in ENGINE_KEYS},
            serve_real={k: real_summary[k] for k in ENGINE_KEYS
                        if k in real_summary},
            tokens_per_s_ratio=s["tokens_per_s"] /
            real_summary["tokens_per_s"],
            requests_tokens_equal_serve_real=same, requests=len(reqs))
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == path_kernels(cfg),
            f"engine {cfg.name}: launched {sorted(launched)}, its path runs "
            f"{sorted(path_kernels(cfg))}: {launches}")
    require(s["launches"].get("fused", 0) >= 1,
            f"engine {cfg.name}: no fused step: {s['launches']}")
    require(s["tokens_met"], f"engine {cfg.name}: a request's token count "
            f"was not met")
    require(all(0 <= x < cfg.vocab_size for t in result["tokens"].values()
                for x in t), f"engine {cfg.name}: bad generated tokens")
    require(s["pool_reclaimed"], f"engine {cfg.name}: KV pool not reclaimed")
    require(s["state_rows_reclaimed"],
            f"engine {cfg.name}: state rows not reclaimed")
    require(s["preemptions"] == 0 and s["rejected"] == 0,
            f"engine {cfg.name}: {s['preemptions']} preemptions, "
            f"{s['rejected']} rejections")
    if keep is not None:
        keep.update(summary=s, tokens=result["tokens"])
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return launches


KERNEL_FAMILIES = {"flash_kernel": "flash_prefill",
                   "paged_kernel": "paged_attention",
                   "unified_kernel": "unified_pd",
                   "ssm_kernel": "ssm_scan"}
MATMUL_MARKS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")
# the host calls that launch a kernel (cuBLAS's GEMMs use the driver's)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")


def device_time(prof):
    """Device seconds of a profile by kernel family, and its 8 most
    expensive device operations by name."""
    by_family, by_name = {}, {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        fam = next((v for k, v in KERNEL_FAMILIES.items() if k in e.name),
                   None)
        if fam is None:
            fam = "matmul" if any(m in e.name.lower()
                                  for m in MATMUL_MARKS) else "other"
        s = e.time_range.elapsed_us() / 1e6
        by_family[fam] = by_family.get(fam, 0.0) + s
        by_name[e.name[:80]] = by_name.get(e.name[:80], 0.0) + s
    return by_family, sorted(by_name.items(), key=lambda kv: -kv[1])[:8]


def profile_serving(model, cfg):
    """Device busy share, and device time by kernel family, of the first 3
    requests of the serving stream run again under torch.profiler (whose
    own host overhead lowers the busy share it reports)."""
    from torch.profiler import ProfilerActivity, profile
    reqs = serving_requests(cfg)[:3]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")     # one warning per sync
        t = time.perf_counter()
        try:
            result = serve_real.serve(model, reqs, slots=SERVE["slots"],
                                      page=SERVE["page"],
                                      f_decode=SERVE["f_decode"])
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    host_ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    host_top = [(e.key, e.count, e.self_cpu_time_total / 1e6)
                for e in host_ops[:10]]
    by_family, top = device_time(prof)
    busy = sum(by_family.values())
    sync_msgs = [str(w.message) for w in syncs
                 if "synchroniz" in str(w.message)]
    return {"requests": len(reqs), "steps": result["steps"], "wall_s": wall,
            "device_busy_s": busy,
            "busy_share": busy / wall if busy else "not measured",
            "device_s_by_family": by_family, "top_kernels_s": top,
            "host_self_s_top": host_top, "host_syncs": len(sync_msgs),
            "host_sync_kinds": sorted(set(m[:100] for m in sync_msgs))}


# ---------------------------------------------------------------------------
# phase 7: Mixtral-8x7B — the MoE FFN and the sliding-window ring cache
# ---------------------------------------------------------------------------

# the longest prompt of the smoke's traffic: an MoE layer's capacity
# buffers are also recorded at it
LONGEST_PROMPT = SERVE["prompts"][1]
# (prompt tokens, new tokens) of the two fixed requests after the smoke's
# 8: a prefill past the window (the window binds, and only the last W
# tokens are written), and a prompt whose ring wraps during decode at
# position 4096, a page boundary
MIXTRAL_FIXED = ((6000, 32), (4090, 32))


def mixtral():
    """Mixtral-8x7B at every published width, cut to the 24 layers one
    card holds (the config's one-card cut, ``configs/mixtral_8x7b.py``)."""
    return get_one_card_config("mixtral-8x7b")


def mixtral_requests(cfg):
    """The smoke's 8 seeded requests, then MIXTRAL_FIXED's two (rids 8
    and 9, prompts from a seeded generator)."""
    reqs = serving_requests(cfg)
    rng = np.random.default_rng(SERVE["seed"] + 2)
    for n, new in MIXTRAL_FIXED:
        reqs.append(serve_real.Request(
            len(reqs), rng.integers(0, cfg.vocab_size, size=n)
            .astype(np.int32), new))
    return reqs


def ring_decode_inputs(gen, ns, Hq, Hkv, D, page, W, dtype):
    """Decode inputs over ring tables: sequence b has ``ns[b]`` tokens
    cached and reads min(ns[b] + 1, W) keys through W / page pages of a
    shuffled pool.  Also the same inputs under the planted fault that the
    ring repairs: each wrapped sequence's newest K/V, at ring slot n % W,
    replaced by other values, which is what a write at position n (not
    n % W) leaves there."""
    B, mp = len(ns), W // page
    N = B * mp + 4
    q = randn(gen, B, Hq, D, dtype=dtype)
    kp = randn(gen, N, page, Hkv, D, dtype=dtype)
    vp = randn(gen, N, page, Hkv, D, dtype=dtype)
    tabs = tables(gen, B, N, mp)
    lens = torch.tensor([min(n + 1, W) for n in ns], dtype=torch.int32,
                        device=DEVICE)
    kf, vf = kp.clone(), vp.clone()
    for b, n in enumerate(ns):
        if n >= W:
            blk = int(tabs[b, n % W // page])
            kf[blk, n % page] = randn(gen, Hkv, D, dtype=dtype)
            vf[blk, n % page] = randn(gen, Hkv, D, dtype=dtype)
    return (q, kp, vp, tabs, lens), (q, kf, vf, tabs, lens)


def check_window_shapes(gen, cfg, reqs):
    """bf16 at Mixtral's windowed shapes, before its model is loaded:
    flash_prefill on the 6000-token prompt with the window (beside SDPA
    with a boolean sliding-window mask); paged_attention over ring tables
    of W / page pages, its first sequence wrapped (the 4090-token prompt
    16 tokens into its decode); unified_pd with that prefill and the first
    3 of those decodes.  Each within TOL_BF16 and TOL_ROW of its plain
    version, and planted faults beyond TOL_ROW: the window ignored
    (prefill), the wrapped sequence's K/V written at seq_lens rather than
    seq_lens % W (decode), and phase 3's faults.  unified_pd must equal
    the standalone kernels bit for bit at every f_decode.  Returns
    per-kernel records."""
    W, page, f_dec = cfg.sliding_window, SERVE["page"], SERVE["f_decode"]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bf16 = torch.bfloat16
    S = len(reqs[8].prompt)
    ns = [len(reqs[9].prompt) + 16] + [len(r.prompt) + 8 for r in reqs[1:4]]
    require(ns[0] >= W > max(ns[1:]), f"decode batch {ns}: one wrapped")
    recs = {}

    q, k, v = prefill_inputs(gen, 1, Hq, Hkv, S, D, bf16)
    pos = torch.arange(S, device=DEVICE)
    mask = (pos[None] <= pos[:, None]) & (pos[None] > pos[:, None] - W)
    want_p = ref.causal_attention(q, k, v, window=W)
    p_faults = {"window_ignored": ref.causal_attention(q, k, v),
                **prefill_faults(q, k, v, window=W)}
    recs["flash_prefill"] = kernel_record(
        within_bf16("flash_prefill windowed",
                    fp.flash_prefill(q, k, v, window=W), want_p, p_faults),
        lambda: fp.flash_prefill(q, k, v, window=W),
        lambda: ref.causal_attention(q, k, v, window=W),
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                               enable_gqa=True),
        prefill_work(q, k, W),
        f"q{list(q.shape)} k{list(k.shape)} window {W} bf16")
    recs["flash_prefill"]["library"] = "SDPA, boolean sliding-window " \
        "mask, enable_gqa"
    del mask

    dec, dec_fault = ring_decode_inputs(gen, ns, Hq, Hkv, D, page, W, bf16)
    want_d = ref.paged_attention(*dec)
    recs["paged_attention"] = kernel_record(
        within_bf16("paged_attention ring", pa.paged_attention(*dec), want_d,
                    {**decode_faults(*dec), "kv_written_at_seq_lens":
                     ref.paged_attention(*dec_fault)}),
        lambda: pa.paged_attention(*dec), lambda: ref.paged_attention(*dec),
        None, decode_work(dec[0], dec[1], dec[4]),
        f"q{list(dec[0].shape)} cached {ns} lens {dec[4].tolist()} ring of "
        f"{W // page} pages of {page} bf16")
    recs["paged_attention"]["splits"] = pa.split_count(W // page, page)

    udec, udec_fault = ring_decode_inputs(gen, ns[:3], Hq, Hkv, D, page, W,
                                          bf16)
    args = (q, k, v) + udec
    got = up.unified_pd(*args, f_decode=f_dec, window=W)
    want = ref.unified_pd(*args, window=W)
    faults = {**{f"prefill_{n}": (o, want[1]) for n, o in p_faults.items()},
              **{f"decode_{n}": (want[0], o)
                 for n, o in decode_faults(*udec).items()},
              "decode_kv_written_at_seq_lens": (
                  want[0], ref.paged_attention(*udec_fault))}
    check = within_bf16("unified_pd windowed", got, want, faults)
    pb, pf = prefill_work(q, k, W)
    db, df = decode_work(udec[0], udec[1], udec[4])
    recs["unified_pd"] = kernel_record(
        check, lambda: up.unified_pd(*args, f_decode=f_dec, window=W),
        lambda: ref.unified_pd(*args, window=W), None, (pb + db, pf + df),
        f"prefill q{list(q.shape)} window {W} + decode q"
        f"{list(udec[0].shape)} cached {ns[:3]} ring bf16")
    recs["unified_pd"]["splits"] = pa.split_count(W // page, page)
    alone = (fp.flash_prefill(q, k, v, window=W), pa.paged_attention(*udec))
    for f in F_DECODES:
        for g, w in zip(up.unified_pd(*args, f_decode=f, window=W), alone):
            require(torch.equal(g, w), f"windowed unified_pd bf16 != "
                    f"standalone at f_decode={f}: {excess(g, w, 0)[1]}")
    recs["unified_pd"]["fused_vs_standalone_bf16_bit_equal"] = True
    return recs


def device_ops(fn):
    """The device operations (kernels, copies, fills) one call of fn runs,
    counted by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def moe_layer_record(gen, model, reqs):
    """Layer 0's MoE FFN at the decode batch (4 tokens, dropless) and at
    the first prompt's prefill and a ``LONGEST_PROMPT``-token one (the
    inference capacity policy), on unit-variance bf16 inputs
    (what rmsnorm hands it): its time after an L2 flush, its bound (expert
    bytes touched at 3.35 TB/s; the kept pairs' operations at 989
    TFLOP/s), the capacity buffers' padding factor (rows computed over
    pairs kept), the device operations of one call and the memory one
    call takes above its input (capacity buffers and products)."""
    cfg = model.cfg
    m, ffn = cfg.moe, model.layers[0].ffn
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    out = {}
    for name, T, policy in (
            ("decode", SERVE["slots"], {"dropless": True}),
            ("prefill", len(reqs[0].prompt), {"inference": True}),
            (f"prefill_{LONGEST_PROMPT}", LONGEST_PROMPT,
             {"inference": True})):
        x = randn(gen, 1, T, d, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        moe_mod.moe_ffn(ffn, cfg, x, **policy)
        torch.cuda.synchronize()
        call_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        _, rows, (g, N, C) = moe_mod.route(ffn, cfg, x, **policy)
        kept = rows < E * N * C
        pairs = int(kept.sum())
        touched = int(torch.unique(rows[kept] // (N * C)).numel())
        nbytes = 2 * (d * E + touched * 3 * d * f + 2 * T * d)
        flops = 2 * T * d * E + pairs * 6 * d * f
        bound, by = bound_ms(nbytes, flops, torch.bfloat16)
        ms = time_ms(lambda: moe_mod.moe_ffn(ffn, cfg, x, **policy))
        out[name] = {
            "tokens": T, "policy": sorted(policy), "group": g, "groups": N,
            "capacity": C, "pairs": T * m.top_k, "pairs_kept": pairs,
            "rows_computed": E * N * C, "padding_factor": E * N * C / pairs,
            "experts_touched": touched, "ms": ms, "bound_ms": bound,
            "bound_by": by, "bound_share": bound / ms,
            "device_ops": device_ops(
                lambda: moe_mod.moe_ffn(ffn, cfg, x, **policy)),
            "call_gb": call_gb}
    return out


def timed_steps(step, steps):
    """``step()`` (one decode step; returns its tokens on the device)
    after two warm-ups: per step the mean host wall time to the sampled
    tokens and the mean CUDA-event time; then ``steps`` steps under
    torch.profiler: the device-busy share (device time over wall time, and
    over the event time of the unprofiled steps), device time by family,
    and host calls a step that launch a kernel or a graph."""
    for _ in range(2):
        step().tolist()
    wall = dev = 0.0
    for _ in range(steps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        out = step()
        e1.record()
        out.tolist()
        wall += time.perf_counter() - t
        dev += e0.elapsed_time(e1)
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step().tolist()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t
    by_family, top = device_time(prof)
    busy = sum(by_family.values())
    names = [e.name for e in prof.events()]
    return {"step_wall_ms": 1e3 * wall / steps,
            "step_event_ms": dev / steps, "profiled_wall_s": prof_wall,
            "device_busy_s": busy, "device_ms_per_step": 1e3 * busy / steps,
            "busy_share": busy / prof_wall if busy else "not measured",
            # the profile's device time over the unprofiled steps' event
            # time: the profiler's own host cost lowers ``busy_share``
            "busy_share_of_event_ms": 1e3 * busy / dev if busy and dev else
            "not measured",
            "device_s_by_family": by_family, "top_kernels_s": top,
            "launches_per_step": sum(n in LAUNCH_CALLS for n in names)
            / steps,
            "graph_launches_per_step": names.count("cudaGraphLaunch")
            / steps}


def profile_decode(model, reqs, steps=5):
    """Decode steps alone at the serving decode batch (4 sequences with
    the first 4 prompts' lengths + 8 cached, zeroed K/V, ring tables
    padded to ``table_width``), eager and through ``DecodeGraphs`` (its
    first step captures), on the same inputs: ``timed_steps`` of each,
    and the graphs' captures, capture seconds and pool memory.  Whether
    the step follows the weights or the host."""
    cfg, page = model.cfg, SERVE["page"]
    ns = [len(r.prompt) + 8 for r in reqs[:SERVE["slots"]]]
    mp = len(attn_mod.ring_table(range(kv_pages_for(max(ns) + 1, page)),
                                 cfg.sliding_window, page))
    width = dg.table_width(mp, cfg.sliding_window, page)
    B = len(ns)
    cache = tf.init_cache(cfg, B * mp, page, B, device=DEVICE)
    tabs = F.pad(torch.arange(B * mp, dtype=torch.int32, device=DEVICE)
                 .view(B, mp), (0, width - mp))
    lens = torch.tensor(ns, dtype=torch.int32, device=DEVICE)
    toks = torch.tensor([[int(r.prompt[-1])] for r in reqs[:B]],
                        dtype=torch.int32, device=DEVICE)
    slots = torch.arange(B, device=DEVICE)
    graphs = dg.DecodeGraphs(model, cache, max_batch=B)

    def eager():
        logits, _ = tf.decode_forward(model, toks, lens[:, None], cache, tabs,
                                      lens, slots)
        return tf.greedy_sample(logits, cfg.vocab_size)

    out = {"batch": B, "cached": ns, "table_pages": mp, "table_width": width,
           "steps": steps,
           "eager": timed_steps(eager, steps),
           "graph": timed_steps(lambda: graphs.step(toks, lens, tabs,
                                                    slots), steps)}
    out["graph"]["decode_graphs"] = graphs.stats()
    out["graph_over_eager"] = {
        k: out["graph"][k] / out["eager"][k] if out["eager"][k] else
        "not measured"
        for k in ("step_wall_ms", "step_event_ms", "device_ms_per_step")}
    return out


def state_rows(cache):
    """A copy of every recurrent layer's state rows (Mamba, mLSTM,
    sLSTM)."""
    return [{k: t.clone() for k, t in c.items()} for c in cache
            if "k" not in c]


def put_state_rows(cache, rows):
    for c, saved in zip([c for c in cache if "k" not in c], rows):
        for k, t in saved.items():
            c[k].copy_(t)


def decode_graph_check(model, reqs, gen):
    """The captured decode step against the eager ``decode_forward`` on
    the same inputs and cache, at the serving decode batch: 4 sequences
    with the first 4 prompts' lengths cached (the first one a token short
    of a page boundary), random K/V and recurrent state, scattered blocks,
    and random input tokens at every step.
    Each shape is captured first (its first step runs eagerly; the state
    rows are put back after it, and the K/V it wrote lie where no later
    step reads before writing).  Then three replayed steps: the batch of
    4; the batch of 4 again, the first sequence now writing into a new
    page (a new table entry); the first 3 (the batch size changes).  Each
    is compared with the eager step from the same state, and must agree
    within TOL_LOGITS (max|graph - eager| / max|eager|, expected 0).  Two
    planted faults at the next step of the smaller batch, against its
    eager step: a replay with no input refreshed (the graph's inputs still
    the step before's) must differ by more than TOL_LOGITS; a replay whose
    ``lens`` alone were not refreshed must differ by more than any sound
    step (it moves one attention position by one, which a model with one
    attention layer in eight, as the Jamba period, may see by less than
    TOL_LOGITS); in a model without attention, whose step reads no lens
    (xLSTM), a replay whose state rows were rolled by one in place of
    it."""
    cfg, page, W = model.cfg, SERVE["page"], model.cfg.sliding_window
    B = SERVE["slots"]
    ns = [len(r.prompt) for r in reqs[:B]]
    ns[0] += (page - 1 - ns[0]) % page
    need = [kv_pages_for(n + 5, page) for n in ns]
    perm = torch.randperm(sum(need), generator=gen, device=DEVICE).tolist()
    blocks = [perm[sum(need[:i]):sum(need[:i + 1])] for i in range(B)]
    cache = tf.init_cache(cfg, sum(need), page, B, device=DEVICE)
    for c in cache:
        for t in c.values():
            t.normal_(generator=gen)
    plan = [ns, [n + 1 for n in ns], [n + 2 for n in ns[:B - 1]]]
    fault_lens = [n + 3 for n in ns[:B - 1]]

    toks = [torch.randint(0, cfg.vocab_size, (B, 1), generator=gen,
                          device=DEVICE, dtype=torch.int32)
            for _ in range(len(plan) + 1)]

    def inputs(i, lens):
        tabs = [attn_mod.ring_table(blocks[i][:kv_pages_for(n + 1, page)],
                                    W, page) for i, n in enumerate(lens)]
        width = dg.table_width(max(map(len, tabs)), W, page)
        return (toks[i][:len(lens)],
                torch.tensor(lens, dtype=torch.int32, device=DEVICE),
                torch.tensor([t + [0] * (width - len(t)) for t in tabs],
                             dtype=torch.int32, device=DEVICE),
                torch.arange(len(lens), device=DEVICE))

    def eager(args):
        """The eager step's logits from the current state; the state rows
        are put back after it."""
        saved = state_rows(cache)
        toks, lens, tabs, rows = args
        logits = tf.decode_forward(model, toks, lens[:, None], cache, tabs,
                                   lens, rows)[0].clone()
        put_state_rows(cache, saved)
        return logits

    graphs = dg.DecodeGraphs(model, cache, max_batch=B)
    shapes = {}
    for i, lens in enumerate(plan + [fault_lens]):
        args = inputs(i, lens)
        shapes.setdefault(tuple(args[2].shape), args)
    for args in shapes.values():
        saved = state_rows(cache)
        graphs.step(*args)
        require(graphs.ran == "capture", f"{cfg.name}: shape "
                f"{tuple(args[2].shape)} was not captured at its first step")
        put_state_rows(cache, saved)
    steps = []
    for i, lens in enumerate(plan):
        args = inputs(i, lens)
        want = eager(args)
        nxt = graphs.step(*args)
        require(graphs.ran == "replay", f"{cfg.name}: step {i} did not "
                f"replay")
        got = graphs.logits
        steps.append({
            "step": i, "batch": len(lens), "cached": lens,
            "table_width": args[2].shape[1],
            "table_entries_first": kv_pages_for(lens[0] + 1, page),
            "max_abs_diff": (got.float() - want.float()).abs().max().item(),
            "rel_err": rel_err(got, want),
            "bit_equal": torch.equal(got, want),
            "tokens_equal": torch.equal(
                nxt, tf.greedy_sample(want, cfg.vocab_size)[:, 0])})
    worst = max(s["rel_err"] for s in steps)
    require(worst <= TOL_LOGITS,
            f"{cfg.name}: the graph's logits differ from eager: {steps}")
    args = inputs(len(plan), fault_lens)
    require(tuple(args[2].shape) == (B - 1, steps[-1]["table_width"]),
            f"{cfg.name}: the fault step's shape is not the last step's")
    want = eager(args)
    g = graphs.graphs[tuple(args[2].shape)]
    saved = state_rows(cache)
    g.replay()                          # no input refreshed
    faults = {"stale_inputs": rel_err(g.logits, want)}
    put_state_rows(cache, saved)
    g.fill(*args)
    if any(blk.kind == "attn" for blk in model.layers):
        g.inputs[1].copy_(torch.tensor(plan[-1], dtype=torch.int32,
                                       device=DEVICE))
        planted = "stale_lens"          # lens alone not refreshed
    else:
        # no layer reads lens: each sequence reads another's state row
        g.inputs[3].copy_(g.inputs[3].roll(1))
        planted = "rows_rolled"
    g.replay()
    faults[planted] = rel_err(g.logits, want)
    require(faults["stale_inputs"] > TOL_LOGITS, f"{cfg.name}: a replay of "
            f"stale inputs moves the logits by {faults}, within {TOL_LOGITS}")
    require(faults[planted] > worst, f"{cfg.name}: the planted {planted} "
            f"moves the logits by {faults}, no more than the sound steps' "
            f"{worst}")
    del cache
    return {"steps": steps, "fault_rel_err": faults,
            "decode_graphs": graphs.stats()}


def graph_phase(model, reqs, gen):
    """The graph check and the decode profile, eager beside graph."""
    cfg = model.cfg
    say("graph", phase="graph_vs_eager", config=cfg.name,
        metric="max|graph-eager|/max|eager|", limit=TOL_LOGITS,
        **decode_graph_check(model, reqs, gen))
    say("profile", phase="decode_steps", config=cfg.name,
        **profile_decode(model, reqs))
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------


def mixtral_phase(gen):
    """Phase 7: Mixtral's windowed kernel checks, then its model (70 GB)
    through both entry points.  Returns (kernel records at its shapes,
    launch counts by path)."""
    cfg = mixtral()
    reqs = mixtral_requests(cfg)
    recs = check_window_shapes(gen, cfg, reqs)
    say("kernels", phase="window_shapes", config=cfg.name,
        window=cfg.sliding_window, tolerance_bf16=TOL_BF16,
        tolerance_bf16_row=TOL_ROW, **recs)
    gc.collect()
    torch.cuda.empty_cache()
    model = init_full(cfg)
    say("moe", config=cfg.name, layer=0, **moe_layer_record(gen, model, reqs))
    launches = {}
    launches[cfg.name], summary, tokens = serve_full(
        model, reqs, pairs=((0, 1), (8, 9)))
    fault, flips = window_logits_fault(model, reqs[8].prompt)
    say("serve", phase="kernel_vs_plain_logits_fault", config=cfg.name,
        request=8, prompt_len=len(reqs[8].prompt),
        metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS,
        fault_window_ignored=fault, **flips)
    require(fault > TOL_LOGITS, f"a planted window fault moves the held-"
            f"routing logits by {fault}, within {TOL_LOGITS}")
    say("profile", config=cfg.name, **profile_serving(model, cfg))
    graph_phase(model, reqs, gen)
    gc.collect()
    torch.cuda.empty_cache()
    launches[f"{cfg.name}-engine"] = engine_full(model, (summary, tokens),
                                                 reqs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return recs, launches


def kernels_phase(gen):
    """Phase 3: every kernel against its plain version.  Returns the worst
    errors at the test shapes (float32, bf16) and the records at the
    serving shapes."""
    worst_f32 = check_test_shapes(gen, torch.float32)
    say("kernels", phase="f32_test_shapes", tolerance=TOL_F32,
        max_abs_err=worst_f32)
    worst_bf16 = check_test_shapes(gen, torch.bfloat16)
    say("kernels", phase="bf16_test_shapes", tolerance=TOL_BF16,
        tolerance_row=TOL_ROW, **worst_bf16)
    cfg = get_config("granite-8b")
    shapes = main_path_shapes(cfg, serving_requests(cfg))
    recs = check_main_path_shapes(gen, shapes)
    say("kernels", phase="main_path_shapes", tolerance_bf16=TOL_BF16,
        tolerance_bf16_row=TOL_ROW, tolerance_fused_f32=TOL_FUSED,
        f_decodes=F_DECODES, **recs)
    say("kernels", phase="two_streams",
        kernels=["paged_attention", "unified_pd"],
        **check_two_streams(gen, shapes))
    say("kernels", phase="scaling", config=cfg.name,
        **kernel_scaling(gen, shapes))
    return worst_f32, worst_bf16, recs


def granite_phase(gen):
    """Phases 4, 6, 14, 9 and 15 for granite-8b.  Returns the launch
    counts by path and phase 14's record of the paged, offset
    flash_prefill."""
    cfg = get_config("granite-8b")
    model = init_full(cfg)
    launches = {}
    launches["granite-8b"], summary, tokens = serve_full(model)
    say("profile", config=cfg.name, **profile_serving(model, cfg))
    graph_phase(model, serving_requests(cfg), gen)
    rapid, hybrid = {}, {}
    launches["granite-8b-engine"] = engine_full(model, (summary, tokens),
                                                keep=rapid)
    with timed("hybrid"):
        paged, hybrid_launches = hybrid_phase(model, gen, rapid, hybrid)
    launches.update(hybrid_launches)
    with timed("gateway"):
        launches["granite-8b-gateway"] = gateway_phase(model)[0]
    with timed("disagg"):
        launches.update(disagg_phase(model, rapid, hybrid))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, paged


def jamba_phase(gen):
    """Phases 5 and 6 for the Jamba period, then its kernel-vs-plain
    logits with float32 weights.  Returns the attention kernels' records
    at its shapes, ssm_scan's record and the launch counts by path."""
    cfg = jamba_period()
    jamba_attn = check_main_path_shapes(
        gen, main_path_shapes(cfg, serving_requests(cfg)))
    say("kernels", phase="main_path_shapes", config="jamba-period",
        **jamba_attn)
    model = init_full(cfg)
    scan = check_scan_serving_shape(
        gen, model, serving_requests(cfg)[0].prompt)
    say("kernels", phase="ssm_scan_serving_shape",
        tolerance_row=TOL_SCAN_ROW, **scan)
    launches = {}
    launches["jamba-period"], summary, tokens = serve_full(model)
    say("profile", config=cfg.name, **profile_serving(model, cfg))
    graph_phase(model, serving_requests(cfg), gen)
    rapid = {}
    launches["jamba-period-engine"] = engine_full(model, (summary, tokens),
                                                  keep=rapid)
    with timed("hybrid jamba-period"):
        jamba_attn["flash_prefill_paged"], hybrid_launches = hybrid_phase(
            model, gen, rapid)
    launches.update(hybrid_launches)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    # the same comparison with float32 weights (36 GB), where only the
    # order of float32 sums separates the two paths
    model = init_full(replace(cfg, dtype="float32"))
    hybrid_f32(model)
    errs, _ = first_steps_kernel_vs_plain(model, serving_requests(cfg),
                                          SERVE["page"])
    fault = logits_fault(model, serving_requests(cfg)[0].prompt)
    say("serve", phase="kernel_vs_plain_logits_f32", config=cfg.name,
        metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS_F32,
        fault_last_update_skipped=fault, **errs)
    require(all(e < TOL_LOGITS_F32 for e in errs.values()),
            f"float32 logits differ between kernel and plain: {errs}")
    require(fault > TOL_LOGITS_F32, f"a planted scan fault moves the "
            f"float32 logits by {fault}, within {TOL_LOGITS_F32}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return jamba_attn, scan, launches


# ---------------------------------------------------------------------------
# phase 14: the hybrid-batching baseline (chunked prefill) on the card
# ---------------------------------------------------------------------------

HYBRID_CHUNK = 512              # the reference's --chunk default
# a packed launch of chunks over the first prompt (1762 tokens), as four
# requests at four points of their prefill: (offset, tokens) each
HYBRID_CHUNKS = ((0, 512), (512, 512), (1250, 512), (1536, 226))
# float32 cases (3e-5), the first launches of the kernel: (G, Hkv, D,
# page, chunks); ragged q-blocks, chunks of one token, offsets off pages
HYBRID_F32_CASES = [
    (1, 2, 64, 16, ((0, 37), (100, 64), (7, 5))),
    (4, 2, 128, 16, ((0, 130), (70, 1), (200, 65))),
    (8, 1, 32, 8, ((33, 64), (0, 64), (5, 100))),
    (2, 2, 16, 16, ((0, 20), (17, 90)))]


def hybrid_case(gen, chunks, Hq, Hkv, D, page, dtype, spare=8):
    """Packed queries of ``chunks`` ((offset, tokens), one request each),
    random pages, each chunk's table of distinct random blocks covering its
    offset + tokens keys (padded with block 0), and their ``Chunks``."""
    need = [-(-(o + n) // page) for o, n in chunks]
    N = sum(need) + spare
    perm = torch.randperm(N, generator=gen, device=DEVICE)
    width, at, rows = max(need), 0, []
    for m in need:
        rows.append(torch.cat([perm[at:at + m], perm.new_zeros(width - m)]))
        at += m
    layout = fp.Chunks([n for _, n in chunks], [o for o, _ in chunks])
    return (randn(gen, layout.rows, Hq, D, dtype=dtype),
            randn(gen, N, page, Hkv, D, dtype=dtype),
            randn(gen, N, page, Hkv, D, dtype=dtype),
            torch.stack(rows).int().contiguous(), layout)


def paged_prefill_plain(q, k_pages, v_pages, tabs, layout):
    return ref.paged_prefill(q, k_pages, v_pages, tabs, layout.starts,
                             layout.lens, layout.offsets)


def paged_prefill_faults(q, k_pages, v_pages, tabs, layout):
    """The plain paged form under planted faults: chunk 2's page 1 read
    from its page 2's block; chunk 1's offset moved down a page."""
    tabs2 = tabs.clone()
    tabs2[2, 1] = tabs[2, 2]
    offs = list(layout.offsets)
    offs[1] -= k_pages.shape[1]
    return {"chunk_2_page_1_read_as_page_2": paged_prefill_plain(
                q, k_pages, v_pages, tabs2, layout),
            "chunk_1_offset_moved_a_page": paged_prefill_plain(
                q, k_pages, v_pages, tabs, fp.Chunks(layout.lens, offs))}


def paged_prefill_work(q, k_pages, layout):
    """Bytes (q read and o written once, each chunk's offset + tokens K/V
    rows read once, its table entries and the layout) and operations (each
    query against the keys up to its position)."""
    Hq, D = q.shape[1:]
    page, Hkv = k_pages.shape[1:3]
    keys = [o + n for o, n in zip(layout.offsets, layout.lens)]
    nbytes = (2 * q.numel() + 2 * sum(keys) * Hkv * D) * q.element_size() \
        + 4 * (sum(-(-k // page) for k in keys) + 3 * len(layout))
    pairs = sum(n * o + n * (n + 1) // 2
                for o, n in zip(layout.offsets, layout.lens))
    return nbytes, 4 * pairs * Hq * D


def paged_prefill_library(q, k_pages, v_pages, tabs, layout):
    """The same function in ``scaled_dot_product_attention``, one call per
    chunk over its own offset + tokens keys, gathered contiguous before
    (not timed), with an explicit boolean mask causal at its offset: the
    work the function needs, unpadded.  Returns the calls (timed together)
    and their largest error against the plain version."""
    page = k_pages.shape[1]
    args = []
    for c, (s0, n, o) in enumerate(zip(layout.starts, layout.lens,
                                       layout.offsets)):
        blocks = tabs[c, :-(-(o + n) // page)].long()
        kk, vv = (pages[blocks].flatten(0, 1)[:o + n].transpose(0, 1)
                  .contiguous()[None] for pages in (k_pages, v_pages))
        mask = (torch.arange(o + n, device=DEVICE)[None] <=
                o + torch.arange(n, device=DEVICE)[:, None])
        args.append((q[s0:s0 + n].transpose(0, 1).contiguous()[None], kk,
                     vv, mask))

    def call():
        return [F.scaled_dot_product_attention(qc, kc, vc, attn_mask=m,
                                               enable_gqa=True)
                for qc, kc, vc, m in args]
    want = paged_prefill_plain(q, k_pages, v_pages, tabs, layout)
    err = max(excess(out[0].transpose(0, 1), want[s0:s0 + n], 0)[1]
              for out, s0, n in zip(call(), layout.starts, layout.lens))
    return call, err


def check_paged_prefill(gen, cfg):
    """The paged, offset flash_prefill against its plain version: float32
    at ``HYBRID_F32_CASES`` (3e-5), then bf16 at ``cfg``'s heads over
    ``HYBRID_CHUNKS`` (3e-2 and the row limit, with two planted faults);
    its times, bound and library time.  Returns its record."""
    f32 = 0.0
    for G, hkv, d, pg, chunks in HYBRID_F32_CASES:
        args = hybrid_case(gen, chunks, G * hkv, hkv, d, pg, torch.float32)
        over, err = excess(fp.flash_prefill_paged(*args),
                           paged_prefill_plain(*args), TOL_F32)
        require(over <= 0, f"flash_prefill_paged f32 max err {err} at "
                f"G {G} D {d} chunks {chunks}")
        f32 = max(f32, err)
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    args = hybrid_case(gen, HYBRID_CHUNKS, Hq, Hkv, D, SERVE["page"],
                       torch.bfloat16)
    library, library_err = paged_prefill_library(*args)
    rec = kernel_record(
        within_bf16("flash_prefill_paged", fp.flash_prefill_paged(*args),
                    paged_prefill_plain(*args), paged_prefill_faults(*args)),
        lambda: fp.flash_prefill_paged(*args),
        lambda: paged_prefill_plain(*args), library,
        paged_prefill_work(args[0], args[1], args[4]),
        f"q{list(args[0].shape)} chunks (offset, tokens) "
        f"{list(HYBRID_CHUNKS)} pages{list(args[1].shape)} bf16")
    rec.update(f32_test_shapes_max_abs_err=f32,
               library_max_abs_err=library_err,
               library="scaled_dot_product_attention once per chunk over "
               "its own keys, gathered contiguous (not timed), boolean "
               "offset mask; the calls timed together",
               ctas=sum(-(-n // fp.BLOCK_Q) for _, n in HYBRID_CHUNKS) * Hq)
    return rec


def hybrid_kernels(cfg):
    """The kernels a hybrid serving run of ``cfg`` launches: the paged,
    offset flash_prefill and paged_attention, and ssm_scan for Mamba."""
    names = {"flash_prefill_paged", "paged_attention"}
    if "mamba" in cfg.layer_pattern:
        names.add("ssm_scan")
    return names


def engine_run(model, mode, reqs, arrivals=None):
    """``serve_engine`` in ``mode`` with the pool the scheduler sizes from
    ``H100``: (summary, kernel launches of the run, tokens by rid)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    ops.reset_launches()
    result = serve_engine.serve_engine(
        model, reqs, serve_engine.serve_config(mode=mode,
                                               chunk=HYBRID_CHUNK),
        arrivals=arrivals)
    torch.cuda.synchronize()
    launches = ops.launches()
    s = serve_engine.summarize(result)
    tokens = result["tokens"]
    del result
    gc.collect()
    torch.cuda.empty_cache()
    return s, launches, tokens


def require_served(s, what):
    require(s["tokens_met"], f"{what}: a request's token count was not met")
    require(s["pool_reclaimed"] and s["state_rows_reclaimed"],
            f"{what}: KV pool or state rows not reclaimed")
    require(s["rejected"] == 0, f"{what}: {s['rejected']} rejections")


@contextlib.contextmanager
def first_mixed_step(store):
    """Wrap ``hybrid_forward``: at the first step with both chunks and
    decodes, keep its inputs and a compact copy of the cache it reads (the
    pages of its tables, renumbered, and its state rows) from before it
    ran, and its logits."""
    real = tf.hybrid_forward

    def wrapped(model, *args, **kw):
        mixed = "args" not in store and len(args[2]) and args[5].shape[0]
        if mixed:
            store["args"] = compact_step(args[:-1], args[-1])
        out = real(model, *args, **kw)
        if mixed:
            store["out"] = (out[0].clone(), out[1].clone())
        return out

    tf.hybrid_forward = wrapped
    try:
        yield
    finally:
        tf.hybrid_forward = real


def compact_step(args, cache):
    """``hybrid_forward``'s step inputs over a compact cache: the pages its
    tables name and its state rows, copied and renumbered."""
    c_in, c_pos, chunks, c_tab, c_rows, d_in, d_lens, d_tab, d_rows = args
    pages = torch.unique(torch.cat([c_tab.flatten(),
                                    d_tab.flatten()]).long())
    rows = torch.unique(torch.cat([c_rows, d_rows]))
    page_id = torch.full((int(pages.max()) + 1,), -1, dtype=torch.long,
                         device=DEVICE)
    page_id[pages] = torch.arange(len(pages), device=DEVICE)
    row_id = torch.full((int(rows.max()) + 1,), -1, dtype=torch.long,
                        device=DEVICE)
    row_id[rows] = torch.arange(len(rows), device=DEVICE)
    small = [{n: t[pages].clone() for n, t in c.items()} if "k" in c else
             {n: t[rows].clone() for n, t in c.items()} for c in cache]
    return ((c_in.clone(), c_pos.clone(), chunks,
             page_id[c_tab.long()].int().contiguous(), row_id[c_rows],
             d_in.clone(), d_lens.clone(),
             page_id[d_tab.long()].int().contiguous(), row_id[d_rows]),
            small)


def mixed_step_kernel_vs_plain(model, store):
    """The captured step on the kernel path and on the plain path, each
    from its own copy of the compact cache: chunk and decode logits
    against each other, and the kernel path against the logits the
    serving run computed over the whole pool."""
    args, small = store["args"]

    def copy_of():
        return [{n: t.clone() for n, t in c.items()} for c in small]

    got = tf.hybrid_forward(model, *args, copy_of())
    want = tf.hybrid_forward(model, *args, copy_of(), impl="ref")
    return {"chunks": len(args[2]), "decodes": int(args[5].shape[0]),
            "chunk_logits": rel_err(got[0], want[0]),
            "decode_logits": rel_err(got[1], want[1]),
            "compact_vs_served_max_abs_diff": max(
                excess(got[0], store["out"][0], 0)[1],
                excess(got[1], store["out"][1], 0)[1])}


def chunked_first_token(model, prompt, chunk=HYBRID_CHUNK):
    """``prompt`` prefilled in chunks through ``hybrid_forward`` (kernel
    path) into a pool of its own pages (a random table) and one state row:
    its last chunk's logits against ``forward``'s at the last position
    (kernel path), and each recurrent layer's state row against the whole
    prefill's final state (max|a-b|/max|b| of each)."""
    cfg, page = model.cfg, SERVE["page"]
    S = len(prompt)
    n_pages = -(-S // page)
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    table = torch.randperm(n_pages, generator=gen,
                           device=DEVICE).int()[None].contiguous()
    cache = tf.init_cache(cfg, n_pages, page, 1, device=DEVICE,
                          dtype=model.tok.dtype)
    toks = torch.from_numpy(prompt).to(DEVICE)
    row = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    none = torch.zeros((0, 1), dtype=torch.int32, device=DEVICE)
    for o in range(0, S, chunk):
        n = min(chunk, S - o)
        logits, _, _ = tf.hybrid_forward(
            model, toks[o:o + n], torch.arange(o, o + n, device=DEVICE),
            fp.Chunks([n], [o]), table, row, none, none[:, 0], none,
            row[:0], cache)
    whole, aux = tf.forward(model, toks[None],
                            torch.arange(S, device=DEVICE)[None],
                            return_aux=True, last_only=True)
    out = {"prompt": S, "chunks": -(-S // chunk),
           "first_token_logits": rel_err(logits[0], whole[0]),
           "same_first_token": bool(torch.equal(
               tf.greedy_sample(logits, cfg.vocab_size),
               tf.greedy_sample(whole, cfg.vocab_size)))}
    states = [rel_err(c[k][0], a[k][0]) for c, a in zip(cache, aux)
              if "k" not in c for k in ("conv", "ssm")]
    if states:
        out["state_rows"] = max(states)
    del cache, aux
    return out


def hybrid_phase(model, gen, rapid, keep=None):
    """Phase 14 on ``model``: the paged, offset flash_prefill at its
    shapes; hybrid serving of the smoke's 8 requests through
    ``HybridEngine`` + ``KernelExecutor`` beside ``rapid`` (phase 6's
    summary and tokens); the first mixed step and the first request's
    first token held to the plain path and to a whole-prompt prefill; and,
    for granite-8b, the reference's lmsys trace in both modes.  Returns
    the kernel's record and the launch counts by path, and puts the
    hybrid run's summary and the lmsys runs' into ``keep`` when it is
    given."""
    cfg = model.cfg
    rec = check_paged_prefill(gen, cfg)
    say("kernels", phase="paged_prefill", config=cfg.name,
        tolerance_bf16=TOL_BF16, tolerance_bf16_row=TOL_ROW,
        tolerance_f32=TOL_F32, **rec)
    reqs = serving_requests(cfg)
    store = {}
    with first_mixed_step(store):
        s, launches, tokens = engine_run(model, "hybrid", reqs)
    serve = serve_engine.serve_config(mode="hybrid", chunk=HYBRID_CHUNK)
    say("hybrid", phase="run", config=cfg.name, chunk=serve.chunk_size,
        token_budget=serve.token_budget, slots=serve.max_batch_slots,
        kernel_launches=launches, **{k: v for k, v in s.items() if k not in (
            "pool_bytes", "mem_free_after_pool", "fused_f_decode",
            "fused_arm_f_decode", "arm_modes")})
    same = sum(tokens.get(r.rid) == rapid["tokens"][r.rid] for r in reqs)
    say("hybrid", phase="beside_rapid", config=cfg.name,
        clock="engine clock (measured launches)",
        hybrid={k: s[k] for k in ENGINE_KEYS},
        rapid={k: rapid["summary"][k] for k in ENGINE_KEYS},
        requests_tokens_equal_rapid=same, requests=len(reqs))
    require_served(s, f"hybrid {cfg.name}")
    require(s["launches"].get("hybrid", 0) >= 1,
            f"hybrid {cfg.name}: no hybrid step: {s['launches']}")
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == hybrid_kernels(cfg),
            f"hybrid {cfg.name}: launched {sorted(launched)}, its path runs "
            f"{sorted(hybrid_kernels(cfg))}: {launches}")
    require("args" in store, f"hybrid {cfg.name}: no step held both a "
            f"chunk and decodes")
    mixed = mixed_step_kernel_vs_plain(model, store)
    del store
    first = chunked_first_token(model, reqs[0].prompt)
    say("hybrid", phase="answers", config=cfg.name,
        metric="max|a-b|/max|b|", limit=TOL_LOGITS,
        mixed_step_kernel_vs_plain=mixed, chunked_vs_whole_prompt=first)
    require(mixed["chunk_logits"] < TOL_LOGITS and
            mixed["decode_logits"] < TOL_LOGITS,
            f"hybrid {cfg.name}: kernel and plain logits of the first mixed "
            f"step differ: {mixed}")
    require(first["first_token_logits"] < TOL_LOGITS,
            f"hybrid {cfg.name}: chunked and whole-prompt first-token logits "
            f"differ: {first}")
    by_path = {f"{cfg.name}-hybrid": launches}
    if cfg.name == "granite-8b":
        trace, arrivals = serve_engine.trace_requests(cfg, **LLAMA_TRACE)
        modes = {}
        for mode in ("rapid", "hybrid"):
            modes[mode], by_path[f"{cfg.name}-{mode}-lmsys"], _ = engine_run(
                model, mode, trace, arrivals)
            require_served(modes[mode], f"{mode} {cfg.name} on lmsys")
        say("hybrid", phase="lmsys", config=cfg.name, **LLAMA_TRACE,
            requests=len(trace), clock="engine clock (measured launches)",
            **{m: {k: v[k] for k in ENGINE_KEYS + ("launches",
                                                   "preemptions")}
               for m, v in modes.items()})
        if keep is not None:
            keep["lmsys"] = modes
    if keep is not None:
        keep["summary"] = s
    return rec, by_path


def hybrid_f32(model):
    """Phase 14 with the Jamba period's float32 weights: chunked against
    whole-prompt first-token logits and state rows, within 1e-3."""
    first = chunked_first_token(model, serving_requests(model.cfg)[0].prompt)
    say("hybrid", phase="answers_f32", config=model.cfg.name,
        metric="max|a-b|/max|b|", limit=TOL_LOGITS_F32,
        chunked_vs_whole_prompt=first)
    require(first["first_token_logits"] < TOL_LOGITS_F32 and
            first["state_rows"] < TOL_LOGITS_F32,
            f"hybrid float32: chunked and whole-prompt prefills differ: "
            f"{first}")


def only_hybrid(gen):
    """``--only-hybrid``: phase 14 alone, after phase 6's RAPID engine run
    of each model, on granite-8b and then the Jamba period (float32 too).
    Returns the records of the paged form and the launch counts."""
    recs, launches = {}, {}
    for cfg in (get_config("granite-8b"), jamba_period()):
        model = init_full(cfg)
        serve_engine.warm_up(model)     # as phase 4 runs before phase 6
        rapid = {}
        launches[f"{cfg.name}-engine"] = engine_full(model, None, keep=rapid)
        recs[cfg.name], got = hybrid_phase(model, gen, rapid)
        launches.update(got)
        del model
        gc.collect()
        torch.cuda.empty_cache()
    model = init_full(replace(jamba_period(), dtype="float32"))
    hybrid_f32(model)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return recs, launches


# ---------------------------------------------------------------------------
# phase 15: disaggregated serving on one card
# ---------------------------------------------------------------------------

DISAGG_KERNELS = {"flash_prefill", "paged_attention"}
# the recomputed position's K/V against the prefill's, by layer,
# max|a-b|/max|b| of the slot: it comes from the decode path's hidden
# state, which drifts from the prefill's layer by layer in bf16 (2.9e-2
# at granite-8b's worst layer on an H100 80GB HBM3 at 700 W); a K/V of a
# wrong position or token differs by the slot's magnitude, which the
# neighbouring position's slot, planted in its place, must show
TOL_RECOMPUTE = 0.1


def transfer_checks(ex, engine, found):
    """Wrap a split-pool ``KernelExecutor``'s ``transfer_seconds``,
    ``_decode`` and ``_prefill`` from outside.  After a transfer (the
    prefill pool's pages still held) it holds the staging, pages of the
    same pool, to them (read layer by layer through the engine's block
    list).  After a join's decode launch it holds the decode pool's pages
    to the staging (its blocks, released by the launch, are written by no
    prefill before the next plan), bit for bit but at the position the
    join's step wrote again (``context_len - 1``), whose slot it holds
    within TOL_RECOMPUTE, by layer, and against which it plants the slot
    before it.  It keeps the last-position logits of each prefill and of
    each join's step.  Appends to ``found``'s lists."""
    page = engine.serve.page_size
    real_t, real_d, real_p = ex.transfer_seconds, ex._decode, ex._prefill

    def gather(cache, blocks):
        idx = torch.tensor(blocks, dtype=torch.int64, device=DEVICE)
        return [c[n].index_select(0, idx) for c in cache for n in "kv"]

    def transfer_seconds(r, serve):
        seconds = real_t(r, serve)
        src = gather(ex.cache_p, engine.kv_p.blocks_of(r.rid))
        staged = gather(ex.cache_p, ex.staged[r.rid])
        found["staged"].append((r.rid, all(map(torch.equal, src, staged))))
        found["transfers"].append(dict(ex.log[-1]))
        return seconds

    def landed(rid, n, staged):
        p, slot = divmod(n, page)
        q, before = divmod(n - 1, page)
        got_all = gather(ex.cache, engine.kv.blocks_of(rid)[:len(staged)])
        bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
        errs, faults = [], []
        for i, (got, want) in enumerate(zip(got_all,
                                            gather(ex.cache_p, staged))):
            ne = got != want
            ne[p, slot] = False
            bad += ne.sum()
            err = rel_err(got[p, slot], want[p, slot])
            if i % 2:
                errs[-1] = max(errs[-1], err)
            else:
                errs.append(err)
            if n >= 1:
                faults.append(rel_err(got[q, before], want[p, slot]))
        found["landed"].append((rid, int(bad) == 0))
        found["recompute_slot"].append(errs)
        if faults:
            found["slot_fault"].append(min(faults))

    def decode(batch, arm_f, kv):
        joins = [(i, r.rid, r.context_len - 1, list(ex.staged[r.rid]))
                 for i, r in enumerate(batch) if r.rid in ex.staged]
        wall = real_d(batch, arm_f, kv)
        for i, rid, n, staged in joins:
            found["logits"].setdefault(rid, {})["join"] = \
                ex.graphs.logits[i, -1].float().clone()
            landed(rid, n, staged)
        return wall

    def prefill(r, kv):
        forward = tf.forward

        def last(*args, **kw):
            logits, aux = forward(*args, **kw)
            found["logits"].setdefault(r.rid, {})["prefill"] = \
                logits[0, -1].float().clone()
            return logits, aux
        tf.forward = last
        try:
            return real_p(r, kv)
        finally:
            tf.forward = forward

    ex.transfer_seconds, ex._decode, ex._prefill = \
        transfer_seconds, decode, prefill


@contextlib.contextmanager
def checked_transfers(found):
    """Every split-pool ``KernelExecutor`` bound meanwhile checks its
    transfers and keeps its first logits (the prefill's last position,
    the join's step) in ``found`` (``transfer_checks``)."""
    for k in ("staged", "landed", "transfers", "recompute_slot",
              "slot_fault"):
        found[k] = []
    found["logits"] = {}
    real = KernelExecutor.bind

    def bind(ex, engine):
        real(ex, engine)
        if ex.cache_p is not None:
            transfer_checks(ex, engine, found)
    KernelExecutor.bind = bind
    try:
        yield
    finally:
        KernelExecutor.bind = real


def transfer_rows(transfers):
    """Each transfer: rid, tokens, pages, MB staged, ms measured (CUDA
    events) and GB/s (staged bytes over it), the perfmodel's ms."""
    return [{"rid": e["rids"][0], "tokens": e["tokens"],
             "pages": e["pages"], "mb": e["bytes"] / 1e6, "ms": e["ms"],
             "gb_per_s": e["bytes"] / e["ms"] / 1e6,
             "priced_ms": e["priced_ms"]} for e in transfers]


def disagg_phase(model, rapid, hybrid):
    """Phase 15 on ``model`` (granite-8b): the smoke's 8 requests through
    ``DisaggEngine`` + ``KernelExecutor`` on the one-card split, each
    transfer and each first-token recompute checked, beside ``rapid``
    (phase 6's summary) and ``hybrid`` (phase 14's summary and lmsys
    runs; empty under ``--only-disagg``); then the lmsys trace in disagg.
    Returns the launch counts by path."""
    cfg = model.cfg
    serve = serve_engine.serve_config(mode="disagg")
    reqs = serving_requests(cfg)
    found = {}
    with checked_transfers(found):
        s, launches, tokens = engine_run(model, "disagg", reqs)
    say("disagg", phase="run", config=cfg.name, chips=serve.chips,
        disagg_split=serve.disagg_split, slots=serve.max_batch_slots,
        kernel_launches=launches, **{k: v for k, v in s.items() if k not in (
            "fused_f_decode", "fused_arm_f_decode", "arm_modes",
            "transfers")})
    say("disagg", phase="transfers", config=cfg.name,
        clock="CUDA events after a synchronize; charged on the engine's "
        "clock", summary=s["transfers"],
        transfers=transfer_rows(found["transfers"]))
    logits = {rid: rel_err(got["join"], got["prefill"])
              for rid, got in found["logits"].items()}
    by_layer = [max(e) for e in zip(*found["recompute_slot"])]
    say("disagg", phase="checks", config=cfg.name,
        staged_equal=sum(ok for _, ok in found["staged"]),
        landed_equal=sum(ok for _, ok in found["landed"]),
        transfers=len(found["staged"]), joins=len(found["landed"]),
        metric="max|a-b|/max|b|",
        recompute_slot_by_layer=by_layer, recompute_slot_limit=TOL_RECOMPUTE,
        fault_slot_before=min(found["slot_fault"], default=None),
        recompute_logits=logits, logits_limit=TOL_LOGITS)
    same = sum(tokens.get(r.rid) == rapid["tokens"][r.rid] for r in reqs)
    say("disagg", phase="beside", config=cfg.name,
        clock="engine clock (measured launches and transfers)",
        disagg={k: s[k] for k in ENGINE_KEYS},
        rapid={k: rapid["summary"][k] for k in ENGINE_KEYS},
        hybrid={k: hybrid["summary"][k] for k in ENGINE_KEYS}
        if "summary" in hybrid else "not run",
        requests_tokens_equal_rapid=same, requests=len(reqs))
    require_served(s, f"disagg {cfg.name}")
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == DISAGG_KERNELS,
            f"disagg {cfg.name}: launched {sorted(launched)}, its path runs "
            f"{sorted(DISAGG_KERNELS)}: {launches}")
    require(s["launches"].get("transfer", 0) == len(reqs) and
            len(found["staged"]) == len(found["landed"]) == len(reqs),
            f"disagg {cfg.name}: {s['launches']}, {len(found['staged'])} "
            f"staged, {len(found['landed'])} landed, {len(reqs)} requests")
    require(all(ok for _, ok in found["staged"] + found["landed"]),
            f"disagg {cfg.name}: a transfer's pages differ: staged "
            f"{found['staged']}, landed {found['landed']}")
    require(max(by_layer) < TOL_RECOMPUTE,
            f"disagg {cfg.name}: the recomputed position's K/V differs "
            f"from the prefill's: {by_layer}")
    require(min(found["slot_fault"]) > TOL_RECOMPUTE,
            f"disagg {cfg.name}: the slot before the recomputed one, planted "
            f"in its place, moves it by {min(found['slot_fault'])}, within "
            f"{TOL_RECOMPUTE}")
    require(sorted(logits) == sorted(r.rid for r in reqs) and
            all(e < TOL_LOGITS for e in logits.values()),
            f"disagg {cfg.name}: the first-token recompute's logits differ "
            f"from the prefill's: {logits}")
    by_path = {f"{cfg.name}-disagg": launches}
    trace, arrivals = serve_engine.trace_requests(cfg, **LLAMA_TRACE)
    lmsys, by_path[f"{cfg.name}-disagg-lmsys"], _ = engine_run(
        model, "disagg", trace, arrivals)
    require_served(lmsys, f"disagg {cfg.name} on lmsys")
    launched = {k for k, n in by_path[f"{cfg.name}-disagg-lmsys"].items()
                if n > 0}
    require(launched == DISAGG_KERNELS,
            f"disagg {cfg.name} on lmsys: launched {sorted(launched)}")
    keys = ENGINE_KEYS + ("launches", "preemptions")
    say("disagg", phase="lmsys", config=cfg.name, **LLAMA_TRACE,
        requests=len(trace), clock="engine clock (measured launches and "
        "transfers)", disagg={k: lmsys[k] for k in keys},
        transfers=lmsys["transfers"],
        **{m: {k: v[k] for k in keys}
           for m, v in hybrid.get("lmsys", {}).items()})
    return by_path


def only_disagg():
    """``--only-disagg``: phase 15 alone on granite-8b, after phase 6's
    RAPID engine run.  Returns the launch counts by path."""
    model = init_full(get_config("granite-8b"))
    serve_engine.warm_up(model)     # as phase 4 runs before phase 6
    rapid = {}
    launches = {"granite-8b-engine": engine_full(model, None, keep=rapid)}
    launches.update(disagg_phase(model, rapid, {}))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 8: LLaMA-3.1-70B — the paper's dense model, on a trace
# ---------------------------------------------------------------------------

# the reference's lmsys trace (``serving/traces.py``) the engine path
# serves: 7 requests arriving at 0.0-12.9 s, 9,379 prompt and 1,680 new
# tokens, all of which fit the cut's 43,472-token pool at once
LLAMA_TRACE = dict(trace="lmsys", qps=0.5, duration=20.0, seed=0)


def llama():
    """LLaMA-3.1-70B at every published width, cut to the 38 layers one
    card holds (the config's one-card cut, ``configs/llama3_70b.py``)."""
    return get_one_card_config("llama3-70b")


def llama_phase(gen):
    """Phase 8: LLaMA through ``serve_real`` on the smoke's requests, the
    graph check, then the engine path on ``LLAMA_TRACE``.  Returns the
    launch counts by path."""
    cfg = llama()
    model = init_full(cfg)
    launches = {}
    launches[cfg.name], _, _ = serve_full(model)
    graph_phase(model, serving_requests(cfg), gen)
    reqs, arrivals = serve_engine.trace_requests(cfg, **LLAMA_TRACE)
    say("engine", phase="trace", config=cfg.name, **LLAMA_TRACE,
        requests=len(reqs), prompt_tokens=sum(len(r.prompt) for r in reqs),
        new_tokens=sum(r.max_new for r in reqs))
    launches[f"{cfg.name}-engine-lmsys"] = engine_full(model, None, reqs,
                                                       arrivals)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: the reference's other token-frontend attention models
# ---------------------------------------------------------------------------

# (arch, the key of its kernel records in the result line): G = Hq / Hkv
# query heads per kv head, 1 (MHA, D = 64), 5, 12 and 16 (the decode
# tile's 16-head bucket)
PHASE_10 = (("minicpm-2b", "at_g1"), ("qwen2.5-14b", "at_g5"),
            ("starcoder2-3b", "at_g12"), ("qwen3-moe-235b-a22b", "at_g16"))


def arch_phase(gen, arch):
    """Phase 10 for one model at every published width (Qwen3-MoE at its
    one-card cut): the attention kernels at its serving shapes (with the
    planted head-group faults where G > 8); its model through
    ``serve_real`` (with the held-routing logits check for an MoE model),
    the graph check and the decode profile, then the engine path.
    Returns (kernel records at its shapes, launch counts by path)."""
    cfg = get_one_card_config(arch)
    reqs = serving_requests(cfg)
    recs = check_main_path_shapes(gen, main_path_shapes(cfg, reqs))
    say("kernels", phase="main_path_shapes", config=cfg.name,
        G=cfg.num_heads // cfg.num_kv_heads, D=cfg.head_dim,
        tolerance_bf16=TOL_BF16, tolerance_bf16_row=TOL_ROW, **recs)
    gc.collect()
    torch.cuda.empty_cache()
    model = init_full(cfg)
    if cfg.moe is not None:
        say("moe", config=cfg.name, layer=0,
            **moe_layer_record(gen, model, reqs))
    launches = {}
    launches[cfg.name], summary, tokens = serve_full(model, reqs)
    graph_phase(model, reqs, gen)
    launches[f"{cfg.name}-engine"] = engine_full(model, (summary, tokens),
                                                 reqs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return recs, launches


def archs_phase(gen):
    """Phase 10: every model of ``PHASE_10``, one after the other, each
    freed before the next loads.  Returns {record key: kernel records} and
    the launch counts by path."""
    recs, launches = {}, {}
    for arch, key in PHASE_10:
        with timed(arch):
            recs[key], by_path = arch_phase(gen, arch)
        launches.update(by_path)
    return recs, launches


# ---------------------------------------------------------------------------
# phase 12: xLSTM-125M served; Qwen2-VL-72B and MusicGen-large through the
# cells of launch/steps.py
# ---------------------------------------------------------------------------

XLSTM_ARCH = "xlstm-125m"
# (arch, the key of its kernel records in the result line)
CELL_ARCHS = (("qwen2-vl-72b", "at_qwen2_vl"),
              ("musicgen-large", "at_musicgen"))
# the cells on one card, cut from the reference's shapes (``reduced``)
CELL_PREFILL = ShapeConfig("prefill_32k", 2048, 1, "prefill")
CELL_DECODE = ShapeConfig("decode_32k", 2048, 8, "decode")
CELL_FUSED = dict(prefill_batch=1, prefill_seq=1024, decode_batch=8,
                  decode_ctx=2048)
CELL_DECODE_STEPS = 4          # the first captures, the other three replay
CELL_SEED = 12
# decode after a prefill against the full forward, max|d - f| / std(f):
# the reference's own limit for bf16 models (tests/test_models.py)
TOL_DECODE_VS_FORWARD = 0.25


def decode_vs_forward(model, prompt, steps=1):
    """The reference's decode check (``tests/test_models.py``) on the
    card: ``prompt`` prefilled into a cache, then ``steps`` greedy decode
    steps, each step's logits against ``forward``'s last position over
    the prompt and the tokens fed so far; max|decode - forward| over the
    forward's standard deviation, per step."""
    cfg, page = model.cfg, SERVE["page"]
    n = len(prompt)
    blocks = kv_pages_for(n + steps, page)
    cache = tf.init_cache(cfg, blocks, page, 1, device=DEVICE)
    tab = torch.arange(blocks, device=DEVICE, dtype=torch.int32)[None]
    slot = torch.zeros(1, device=DEVICE, dtype=torch.int64)
    seq = torch.tensor(prompt[None], device=DEVICE)
    logits, aux = tf.forward(model, seq, torch.arange(n, device=DEVICE)[None],
                             return_aux=True, last_only=True)
    tf.write_prefill_to_cache(cache, aux, tab, slot,
                              window=cfg.sliding_window)
    del aux
    cur, errs, V = tf.greedy_sample(logits, cfg.vocab_size), [], \
        cfg.vocab_size
    for i in range(steps):
        lens = torch.tensor([n + i], device=DEVICE, dtype=torch.int32)
        d, _ = tf.decode_forward(model, cur, lens[:, None], cache, tab, lens,
                                 slot)
        seq = torch.cat([seq, cur], dim=1)
        f = tf.forward(model, seq, torch.arange(n + i + 1, device=DEVICE)
                       [None], return_aux=True, last_only=True)[0]
        a, b = d[0, 0, :V].float(), f[0, 0, :V].float()
        errs.append(((a - b).abs().max() / (b.std() + 1e-6)).item())
        cur = tf.greedy_sample(d, V)
    return errs


def xlstm_phase(gen):
    """Phase 12 (a): xLSTM-125M at every published width served through
    ``serve_real`` and the engine path, which launch no kernel (the
    reference has none for either mixer); the graph check (with rolled
    state rows as its second fault) and the decode profile; the decode
    step against the full forward, in bf16 and with float32 weights.
    Returns the launch counts by path."""
    cfg = get_one_card_config(XLSTM_ARCH)
    require(not path_kernels(cfg), f"{cfg.name}: its path runs no kernel")
    model = init_full(cfg)
    reqs = serving_requests(cfg)
    launches = {}
    # no kernel on the path: the kernel-vs-plain logits would compare the
    # plain path with itself
    launches[cfg.name], summary, tokens = serve_full(model, reqs, pairs=())
    graph_phase(model, reqs, gen)
    launches[f"{cfg.name}-engine"] = engine_full(model, (summary, tokens),
                                                 reqs)
    # decode against forward, in bf16 and with float32 weights
    prompt = min(reqs, key=lambda r: len(r.prompt)).prompt
    errs = {"bfloat16": decode_vs_forward(model, prompt)}
    del model
    gc.collect()
    torch.cuda.empty_cache()
    model = init_full(replace(cfg, dtype="float32"))
    errs["float32"] = decode_vs_forward(model, prompt)
    say("serve", phase="decode_vs_forward", config=cfg.name,
        metric="max|decode-forward|/std(forward)",
        limit=TOL_DECODE_VS_FORWARD, prompt_len=len(prompt), errs=errs)
    require(max(map(max, errs.values())) < TOL_DECODE_VS_FORWARD,
            f"{cfg.name}: decode and forward logits differ by {errs} of "
            f"the forward's std")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def cell_cuts(full, cut):
    """The cuts of the reference's serving cells on one card."""
    pool = SHAPES["decode_32k"].global_batch * SHAPES["decode_32k"].seq_len \
        * cut.kv_bytes_per_token()
    out = []
    if cut.num_layers != full.num_layers:
        out.append(f"layers {full.num_layers} -> {cut.num_layers} (bf16 "
                   f"weights {2 * full.param_count() / 1e9:.2f} -> "
                   f"{2 * cut.param_count() / 1e9:.2f} GB)")
    p, d = SHAPES["prefill_32k"], SHAPES["decode_32k"]
    f = CELL_FUSED
    return out + [
        f"prefill_32k: batch {p.global_batch} -> {CELL_PREFILL.global_batch}"
        f", seq {p.seq_len} -> {CELL_PREFILL.seq_len}",
        f"decode_32k: batch {d.global_batch} -> {CELL_DECODE.global_batch}, "
        f"cache {d.seq_len} -> {CELL_DECODE.seq_len} tokens (the "
        f"reference's pool: {pool / 1e9:.0f} GB at {cut.num_layers} layers)",
        f"fused_pd: prefill 2 x 4096 -> {f['prefill_batch']} x "
        f"{f['prefill_seq']}, decode 64 x 8192 -> {f['decode_batch']} x "
        f"{f['decode_ctx']}"]


def cell_phase(gen, arch, seed=CELL_SEED):
    """Phase 12 (b) for one model (its one-card cut): the attention
    kernels at its cells' shapes as in phase 10; then, with the counts
    set to 0, its cells on the kernels: the prefill cell, four decode
    steps through ``DecodeGraphs`` (fresh seeded inputs each; the first
    captures) and the fused cell; then each against the same cell on the
    plain versions (logits within TOL_LOGITS), each decode step against
    the eager step from the same cache (bit-equal), a fresh step replayed
    first (the K/V rows it writes and its logits the eager step's, bit
    for bit), and under M-RoPE two planted faults: the fresh step
    replayed with stale positions, and the prefill's streams swapped
    (``mrope_faults``).  ``seed`` draws the decode lengths and every
    input.  Returns (kernel records at its shapes, launch counts by
    path)."""
    full, cfg = get_config(arch), get_one_card_config(arch)
    rng = np.random.default_rng(seed)
    lens = sorted(rng.integers(CELL_DECODE.seq_len // 2,
                               CELL_DECODE.seq_len - steps_mod.DECODE_ROOM
                               + 1, size=CELL_DECODE.global_batch).tolist())
    recs = check_main_path_shapes(gen, {
        "prefill_S": CELL_PREFILL.seq_len, "decode_lens": lens,
        "fused_S": CELL_FUSED["prefill_seq"], "fused_lens": lens,
        "Hq": cfg.num_heads, "Hkv": cfg.num_kv_heads, "D": cfg.head_dim,
        "page": steps_mod.PAGE})
    say("kernels", phase="main_path_shapes", config=cfg.name,
        G=cfg.num_heads // cfg.num_kv_heads, D=cfg.head_dim,
        tolerance_bf16=TOL_BF16, tolerance_bf16_row=TOL_ROW, **recs)
    gc.collect()
    torch.cuda.empty_cache()
    model = init_full(cfg)
    say("cells", phase="cut", config=cfg.name, reduced=cell_cuts(full, cfg),
        frontend=cfg.frontend, rope_type=cfg.rope_type)
    prefill = steps_mod.build_prefill_cell(model, CELL_PREFILL)
    decode = steps_mod.build_decode_cell(model, CELL_DECODE)
    fused = steps_mod.build_fused_pd_cell(model, f_decode=SERVE["f_decode"],
                                          **CELL_FUSED)
    p_args = prefill.materialize(seed, DEVICE)
    d_args = decode.materialize(seed + 1, DEVICE)
    f_args = fused.materialize(seed + 2, DEVICE)
    for cell, args in ((prefill, p_args), (decode, d_args),
                       (fused, f_args)):
        require({k: (tuple(v.shape), v.dtype) for k, v in args.items()} ==
                {k: (x.shape, x.dtype) for k, x in cell.args.items()},
                f"{cfg.name}: the {cell.shape} cell drew other inputs than "
                f"its specs")
    torch.cuda.synchronize()
    ops.reset_launches()
    p_logits = prefill(**p_args)[0]
    d_steps = steps_mod.decode_steps(decode, d_args, CELL_DECODE_STEPS,
                                     seed)
    fp_logits, _, fd_logits = fused(**f_args)
    torch.cuda.synchronize()
    launches = {f"{cfg.name}-cells": ops.launches()}
    captured = decode.graphs.stats()
    require((captured["graphs"], captured["replays"]) ==
            (1, CELL_DECODE_STEPS - 1), f"{cfg.name}: the decode steps "
            f"did not capture once and replay: {captured}")
    launched = {k for k, n in launches[f"{cfg.name}-cells"].items() if n}
    require(launched == path_kernels(cfg),
            f"{cfg.name} cells: launched {sorted(launched)}, the path runs "
            f"{sorted(path_kernels(cfg))}")
    # the comparisons: each rewrites the K/V its step wrote, bit for bit
    errs = {"prefill": rel_err(p_logits, tf.forward(
        model, **p_args, impl="ref", last_only=True))}
    graph = []
    for i, (args, got) in enumerate(d_steps):
        c = decode.cache
        call = (model, args["inputs"], args["positions"], c.layers, c.tables,
                args["seq_lens"], c.slots)
        # the plain step first: it writes this step's K/V from its own
        # hidden states; the eager kernel step then writes the kernel
        # path's back, which the next step reads, as the replays did
        errs[f"decode_step_{i}"] = rel_err(got, tf.decode_forward(
            *call, impl="ref")[0])
        eager = tf.decode_forward(*call)[0]
        graph.append({"step": i, "ran": "capture" if i == 0 else "replay",
                      "bit_equal": torch.equal(got, eager),
                      "rel_err": rel_err(got, eager)})
    # a fresh step, replayed first: the K/V rows it writes (layer 0's)
    # must be the eager step's, and so must its logits; then a planted
    # fault, the same step replayed with the first step's positions
    args = d_steps[-1][0]
    nxt = dict(args, positions=args["positions"] + 1,
               seq_lens=args["seq_lens"] + 1)
    rows = attn_mod.pool_rows(c.tables, nxt["seq_lens"][:, None], c.page)
    k0 = next(x["k"] for x in c.layers if "k" in x)
    k0 = k0.view(-1, *k0.shape[2:])
    before = k0[rows].clone()
    replayed = decode(**nxt).clone()
    after = k0[rows].clone()
    eager = tf.decode_forward(model, nxt["inputs"], nxt["positions"],
                              c.layers, c.tables, nxt["seq_lens"],
                              c.slots)[0]
    fresh = {"replay_wrote_rows": not torch.equal(before, after),
             "rows_equal_eager": torch.equal(after, k0[rows]),
             "bit_equal": torch.equal(replayed, eager)}
    g = next(iter(decode.graphs.graphs.values()))
    g.fill(nxt["inputs"], nxt["seq_lens"], c.tables, c.slots,
           d_steps[0][0]["positions"])
    g.replay()
    fresh["stale_positions_rel_err"] = rel_err(g.logits, eager)
    c = fused.cache
    ref_p, _, ref_d, _ = tf.fused_pd_forward(
        model, f_args["p_inputs"], f_args["p_positions"], f_args["d_inputs"],
        f_args["d_positions"], c.layers, c.tables, f_args["seq_lens"],
        c.slots, impl="ref")
    errs["fused_prefill"] = rel_err(fp_logits, ref_p)
    errs["fused_decode"] = rel_err(fd_logits, ref_d)
    # a whole step's launches outnumber the launch queue: host_ms, from an
    # idle card to the step's end; one replayed graph: time_ms
    times = {"prefill_ms": host_ms(lambda: prefill(**p_args)),
             "prefill_plain_ms": host_ms(lambda: tf.forward(
                 model, **p_args, impl="ref", last_only=True), 1),
             "decode_step_graph_ms": time_ms(
                 lambda: decode(**d_steps[-1][0]), 10),
             "fused_ms": host_ms(lambda: fused(**f_args))}
    say("cells", phase="kernel_vs_plain", config=cfg.name,
        metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS, **errs,
        seed=seed, graph_vs_eager=graph, fresh_step=fresh,
        decode_graphs=captured, seq_lens=d_args["seq_lens"]
        .tolist(), launches=launches[f"{cfg.name}-cells"], **times)
    require(all(e < TOL_LOGITS for e in errs.values()),
            f"{cfg.name}: cells differ between kernel and plain: {errs}")
    require(all(g["bit_equal"] for g in graph) and fresh["bit_equal"] and
            fresh["replay_wrote_rows"] and fresh["rows_equal_eager"],
            f"{cfg.name}: a replayed decode step differs from eager: "
            f"{graph}, {fresh}")
    require(cfg.rope_type == "none" or
            fresh["stale_positions_rel_err"] > TOL_LOGITS,
            f"{cfg.name}: a replay of stale positions moves the logits by "
            f"{fresh}, within {TOL_LOGITS}")
    del decode, fused, d_steps
    gc.collect()
    torch.cuda.empty_cache()
    if cfg.rope_type == "mrope":
        say("cells", phase="mrope_faults", config=cfg.name,
            **mrope_faults(model, p_args))
    del model, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return recs, launches


def mrope_faults(model, args):
    """Planted faults in the prefill cell's 3-D positions, on the kernel
    path, against its own logits at every position: the h and w streams
    swapped, and the t and h streams swapped.  Under M-RoPE's sections
    (2, 1, 1) the t stream turns the highest frequencies of the rotary
    half and h and w the lowest (theta^(-1/2) and below), so an image
    token's h/w swap turns its keys and queries by at most (g - 1) x
    1e-3 rad (g the grid's side): the logits move, by little.  The h/w
    swap must move them at all (the kernel path is deterministic: a port
    that dropped the h or w stream would give the same bits); the t/h
    swap must move them past TOL_LOGITS."""
    cfg = model.cfg
    want = tf.forward(model, **args)
    out = {}
    for name, order in (("h_w_swapped", [0, 2, 1]),
                        ("t_h_swapped", [1, 0, 2])):
        got = tf.forward(model, args["inputs"],
                         args["positions"][..., order].contiguous())
        out[name] = {"rel_err": rel_err(got, want),
                     "last_position_rel_err": rel_err(got[:, -1], want[:, -1]),
                     "bit_equal": torch.equal(got, want)}
        del got
    a, g = steps_mod.mrope_layout(args["positions"].shape[1])
    out.update(limit=TOL_LOGITS, image_grid=[g, g], text_prefix=a,
               metric="max|fault-sound|/max|sound|, every position")
    require(not out["h_w_swapped"]["bit_equal"], f"{cfg.name}: swapping the "
            f"h and w streams changes no logit: {out}")
    require(out["t_h_swapped"]["rel_err"] > TOL_LOGITS, f"{cfg.name}: "
            f"swapping the t and h streams moves the logits by {out}, within "
            f"{TOL_LOGITS}")
    return out


def cells_phase(gen, seeds=(CELL_SEED,)):
    """Phase 12: xLSTM-125M, then the two embedding-input models' cells
    once for each of ``seeds``, each model freed before the next loads.
    Returns {record key: kernel records} and the launch counts by path
    (of the last seed)."""
    with timed(XLSTM_ARCH):
        launches = xlstm_phase(gen)
    recs = {}
    for seed in seeds:
        for arch, key in CELL_ARCHS:
            with timed(arch):
                recs[key], by_path = cell_phase(gen, arch, seed)
            launches.update(by_path)
    return recs, launches


class ModelCut:
    """The first ``layers`` layers of ``model`` with its embedding and
    head, sharing its weights: what the entry points of
    ``models/transformer.py`` read of a model."""

    def __init__(self, model, layers):
        self.cfg = dataclasses.replace(model.cfg, num_layers=layers)
        self.tok, self.final_norm = model.tok, model.final_norm
        self.lm_head = getattr(model, "lm_head", None)
        self.layers = model.layers[:layers]


class Float32Layers:
    """Iterates over ``layers`` with each block's parameters in float32
    while the caller holds it, and back in their own dtype after: a
    float32 model one layer at a time, on the memory of one layer."""

    def __init__(self, layers):
        self.layers = layers

    def __len__(self):
        return len(self.layers)

    def __iter__(self):
        for blk in self.layers:
            saved = [(p, p.data) for p in blk.parameters()]
            try:
                for p, d in saved:
                    p.data = d.float()
                yield blk
            finally:
                for p, d in saved:
                    p.data = d


class Float32Cut:
    """``cut`` (a ``ModelCut`` of an ``embed_stub`` model) in float32: its
    head and final norm copied, its layers through ``Float32Layers``.
    ``tok`` is an empty float32 tensor: an ``embed_stub`` model reads it
    for its dtype and device only."""

    def __init__(self, cut):
        assert cut.cfg.frontend == "embed_stub" and \
            not cut.cfg.tie_embeddings
        self.cfg = cut.cfg
        self.tok = torch.empty(0, device=cut.tok.device)
        self.final_norm = cut.final_norm.float()
        self.lm_head = cut.lm_head.float()
        self.layers = Float32Layers(cut.layers)


DEPTH_ARCH = "qwen2-vl-72b"
DEPTHS = (4, 12, 24, 36)
DEPTH_SEEDS = (12, 13, 14, 15)


def logits_depths(depths=DEPTHS, seeds=DEPTH_SEEDS):
    """``--logits-depths`` (ROADMAP C9): Qwen2-VL-72B's one-card cut at
    each depth of ``depths`` (its first layers), the prefill cell and the
    first decode step of the decode cell (inputs and cache drawn as phase
    12 draws them at each seed), on three paths: the kernel path and the
    plain path in bf16, and the plain path in float32 on the same weights
    (cast one layer at a time) and the same cache.  Returns one record per
    depth and seed: max|a - b| / max|b| for kernel vs plain, kernel vs
    float32 and plain vs float32."""
    cfg = get_one_card_config(DEPTH_ARCH)
    model = init_full(cfg)
    model.tok = torch.nn.Parameter(torch.empty(0, device=DEVICE,
                                               dtype=model.tok.dtype),
                                   requires_grad=False)   # embed_stub
    gc.collect()
    torch.cuda.empty_cache()
    out = []
    for depth in depths:
        cut = ModelCut(model, depth)
        f32 = Float32Cut(cut)
        for seed in seeds:
            prefill = steps_mod.build_prefill_cell(cut, CELL_PREFILL)
            p_args = prefill.materialize(seed, DEVICE)
            p = {impl: tf.forward(cut, **p_args, impl=impl, last_only=True)
                 for impl in ("kernel", "ref")}
            p["f32"] = tf.forward(f32, **p_args, impl="ref", last_only=True)
            decode = steps_mod.build_decode_cell(cut, CELL_DECODE,
                                                 impl="ref")
            a = decode.materialize(seed + 1, DEVICE)
            c = decode.cache
            call = (a["inputs"], a["positions"], c.layers, c.tables,
                    a["seq_lens"], c.slots)
            d = {impl: tf.decode_forward(cut, *call, impl=impl)[0]
                 for impl in ("kernel", "ref")}
            for layer in c.layers:       # the same cache, in float32
                for k in list(layer):
                    layer[k] = layer[k].float()
            d["f32"] = tf.decode_forward(f32, *call, impl="ref")[0]
            rec = {"depth": depth, "seed": seed}
            for name, r in (("prefill", p), ("decode_step_0", d)):
                rec[name] = {
                    "kernel_vs_plain": rel_err(r["kernel"], r["ref"]),
                    "kernel_vs_f32": rel_err(r["kernel"], r["f32"]),
                    "plain_vs_f32": rel_err(r["ref"], r["f32"])}
            say("depths", **rec)
            out.append(rec)
            del prefill, decode, c, p, d, call, a
            gc.collect()
            torch.cuda.empty_cache()
        del f32
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 13: the mesh half: long_500k through the 1x1 mesh, Mixtral-8x22B
# served, one train-cell step
# ---------------------------------------------------------------------------

LONG = SHAPES["long_500k"]
LONG_STEPS = 3          # the first captures, the others replay
LONG_SEED = 21
MIXTRAL_22B = "mixtral-8x22b"
TRAIN_CELL_LAYERS = 4   # MiniCPM-2B's depth cut for (c); every width kept


def long_attention_record(cell, args):
    """``paged_attention`` at the cell's shapes (its first attention
    layer's pool, a random query) over the whole sequence the shape holds,
    524,288 tokens (the window under a sliding window): against its plain
    version, its time beside its bound, and the splits and CTAs the
    wrapper chose."""
    cfg, c = cell.cfg, cell.cache
    pool = next(x for x in c.whole if "k" in x)
    gen = torch.Generator(device=DEVICE).manual_seed(LONG_SEED)
    q = randn(gen, 1, cfg.num_heads, cfg.head_dim, dtype=torch.bfloat16)
    lens = attn_mod.ring_lens(torch.full_like(args["seq_lens"], LONG.seq_len),
                              cfg.sliding_window).to(torch.int32)
    dec = (q, pool["k"], pool["v"], c.tables, lens)
    # over half a million random keys attention is near uniform: one key
    # dropped moves a row by less than TOL_ROW, so that fault is left out;
    # a page read from the wrong block and a split skipped still show
    faults = {k: v for k, v in decode_faults(*dec).items()
              if k != "last_key_dropped"}
    rec = kernel_record(
        within_bf16("paged_attention", pa.paged_attention(*dec),
                    ref.paged_attention(*dec), faults),
        lambda: pa.paged_attention(*dec), lambda: ref.paged_attention(*dec),
        None, decode_work(q, pool["k"], lens),
        f"q{list(q.shape)} lens{lens.tolist()} pages {c.tables.shape[1]} "
        f"of {c.page} bf16")
    rec["splits"] = pa.split_count(c.tables.shape[1], c.page)
    rec["ctas"] = rec["splits"] * cfg.num_kv_heads
    rec["kv_gb"] = 2 * pool["k"].numel() * pool["k"].element_size() / 1e9
    return rec


def long_500k_check(model, mesh):
    """(a) for one model: ``long_500k`` (batch 1, 524,288 tokens) through
    ``build_cell(model, long_500k, mesh=1x1)``, beside its plain version,
    each cache drawn from LONG_SEED.  With the counts at 0, LONG_STEPS
    decode steps as CUDA graphs (the first captures; on one chip the
    graphs run the program without a mesh, on the same tensors); then,
    with the counts at 0 again, the last step taken again eagerly through
    the placed model's DTensor program on the same cache: it launches
    ``paged_attention`` once per attention layer (on each chip's local
    shards, ``sharding.on_shards``) and gives the graph's logits bit for
    bit, so the 1x1 mesh computes what the program without one does.  The
    first step on the plain versions (an MoE model's expert choices held
    to the kernel path's, ``routing``) is within TOL_LOGITS.  Returns (its
    record, the steps' launches, the mesh cell, its args)."""
    cfg = model.cfg
    cells = {"mesh": steps_mod.build_cell(model, LONG, mesh=mesh, hw=H100),
             "plain": steps_mod.build_decode_cell(model, LONG, impl="ref")}
    args = {k: c.materialize(LONG_SEED, DEVICE) for k, c in cells.items()}
    require(torch.equal(args["plain"]["seq_lens"],
                        args["mesh"]["seq_lens"]),
            f"{cfg.name}: long_500k cells drew other lengths")
    torch.cuda.synchronize()
    ops.reset_launches()
    got = steps_mod.decode_steps(cells["mesh"], args["mesh"], LONG_STEPS - 1,
                                 LONG_SEED)
    # the state rows the last step starts from: its eager run through the
    # DTensor program must start there too (K/V rows it rewrites alike)
    before = state_rows(cells["mesh"].cache.whole)
    torch.cuda.synchronize()
    t = time.perf_counter()
    last_args, last = _last_step(cells["mesh"], got[-1][0], LONG_STEPS - 1)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t
    launches = ops.launches()
    put_state_rows(cells["mesh"].cache.whole, before)
    ops.reset_launches()
    eager = steps_mod.gather(steps_mod.eager_decode_step(cells["mesh"],
                                                         **last_args))
    torch.cuda.synchronize()
    eager_launches = ops.launches()
    log = {"choices": [], "flips": 0, "order_flips": 0, "pairs": 0}
    c, a = cells["plain"].cache, args["plain"]
    call = (a["inputs"], a["positions"], c.layers, c.tables, a["seq_lens"],
            c.slots)
    rows = state_rows(c.layers)
    with routing("record", log):
        kern = tf.decode_forward(model, *call, impl="kernel")[0].clone()
    put_state_rows(c.layers, rows)       # the plain step's from the same
    with routing("replay", log):
        plain = tf.decode_forward(model, *call, impl="ref")[0]
    graphs = cells["mesh"].graphs.stats()
    n_attn = sum(cfg.mixer_at(i) == "attn" for i in range(cfg.num_layers))
    want_eager = {k: (n_attn if k == "paged_attention" else 0)
                  for k in eager_launches}
    rec = {"mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "cache_len": int(args["mesh"]["seq_lens"][0]),
           "steps": LONG_STEPS, "graphs": graphs,
           "mesh_dtensor_vs_no_mesh_graph_bit_equal": torch.equal(eager,
                                                                  last),
           "mesh_dtensor_vs_no_mesh_graph_rel_err": rel_err(eager, last),
           "mesh_dtensor_launches": eager_launches,
           "attention_layers": n_attn,
           "kernel_vs_plain_rel_err": rel_err(kern, plain),
           "routing_flips": log["flips"], "routed_pairs": log["pairs"],
           "replayed_step_ms": step_s * 1e3, "launches": launches,
           "kv_pages": cells["mesh"].cache.whole_blocks}
    require((graphs["graphs"], graphs["replays"]) == (1, LONG_STEPS - 1),
            f"{cfg.name} long_500k: the steps did not capture once and "
            f"replay: {graphs}")
    require(eager_launches == want_eager, f"{cfg.name} long_500k: the "
            f"eager DTensor step launched {eager_launches}, its {n_attn} "
            f"attention layers launch paged_attention once each")
    require(rec["mesh_dtensor_vs_no_mesh_graph_bit_equal"], f"{cfg.name} "
            f"long_500k: the 1x1 mesh's DTensor step differs from the "
            f"graph of the program without a mesh: "
            f"{rec['mesh_dtensor_vs_no_mesh_graph_rel_err']}")
    require(rec["kernel_vs_plain_rel_err"] < TOL_LOGITS, f"{cfg.name} "
            f"long_500k: kernel vs plain logits {rec}")
    launched = {k for k, n in launches.items() if n}
    want = {"paged_attention"} if "attn" in cfg.layer_pattern else set()
    require(launched == want, f"{cfg.name} long_500k: launched "
            f"{sorted(launched)}, its decode runs {sorted(want)}")
    del cells["plain"], got
    return rec, launches, cells["mesh"], args["mesh"]


def _last_step(cell, args, i):
    """``decode_steps``' step i after the step that took ``args``: fresh
    inputs drawn from (LONG_SEED, i), one more position and cached token.
    Returns (its args, its logits (a copy))."""
    x = args["inputs"]
    nxt = dict(args, inputs=steps_mod.draw_inputs(
        cell.cfg, np.random.default_rng((LONG_SEED, i)), x.shape[0], 1,
        x.device, x.dtype), positions=args["positions"] + 1,
        seq_lens=args["seq_lens"] + 1)
    return nxt, cell(**nxt).clone()


def long_phase(model, mesh, key):
    """(a) for one loaded model: ``long_500k_check`` and, where it has an
    attention layer, ``paged_attention`` at the cell's shapes.  Returns
    ({key: kernel record} or {}, the launches by path)."""
    cfg = model.cfg
    rec, launches, cell, args = long_500k_check(model, mesh)
    attn = {}
    if "attn" in cfg.layer_pattern:
        attn[key] = {"paged_attention": long_attention_record(cell, args)}
        rec["paged_attention"] = attn[key]["paged_attention"]
    say("mesh", phase="long_500k", config=cfg.name, layers=cfg.num_layers,
        window=cfg.sliding_window, limit=TOL_LOGITS,
        reduced=[f"layers {get_config(cfg.name).num_layers} -> "
                 f"{cfg.num_layers}"] if cfg.num_layers != get_config(
                     cfg.name).num_layers else [], **rec)
    del cell, args
    gc.collect()
    torch.cuda.empty_cache()
    return attn, {f"{cfg.name}-long_500k": launches}


def mixtral_22b_phase(gen, mesh):
    """(b) Mixtral-8x22B's one-card cut, as phase 10 treats a new model:
    the attention kernels at its serving shapes (G 6), its model through
    ``serve_real`` (held-routing logits, flips under TOL_FLIP_SHARE), its
    MoE layer timed, the graph check and the decode profile; then (a) on
    the same model.  Returns (kernel records by key, launches by path)."""
    cfg = get_one_card_config(MIXTRAL_22B)
    reqs = serving_requests(cfg)
    recs = check_main_path_shapes(gen, main_path_shapes(cfg, reqs))
    say("kernels", phase="main_path_shapes", config=cfg.name,
        G=cfg.num_heads // cfg.num_kv_heads, D=cfg.head_dim,
        tolerance_bf16=TOL_BF16, tolerance_bf16_row=TOL_ROW, **recs)
    gc.collect()
    torch.cuda.empty_cache()
    model = init_full(cfg)
    say("moe", config=cfg.name, layer=0, **moe_layer_record(gen, model, reqs))
    launches = {}
    launches[cfg.name] = serve_full(model, reqs)[0]
    graph_phase(model, reqs, gen)
    attn, by_path = long_phase(model, mesh, "at_long_500k_mixtral_8x22b")
    launches.update(by_path)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"at_g6": recs, **attn}, launches


def train_cell_check(mesh, card):
    """(c) MiniCPM-2B at every width, cut to TRAIN_CELL_LAYERS layers: one
    step of ``build_train_cell`` on the 1x1 mesh at phase 11's batch (2 x
    4096 tokens, 2 microbatches, phase 11's optimizer), against phase
    11's ``make_train_step`` on the same weights (both from seed 0) and
    the same batch (``TokenPipeline``'s first); loss and grad norm within
    1e-6 relative (bit-equal expected: one chip runs the same
    operations)."""
    argv = MINICPM_TRAIN
    batch, seq = (int(argv[argv.index(f) + 1]) for f in ("--batch",
                                                          "--seq-len"))
    mb = int(argv[argv.index("--microbatches") + 1])
    cfg = dataclasses.replace(get_one_card_config("minicpm-2b"),
                              num_layers=TRAIN_CELL_LAYERS)
    steps_n = int(argv[argv.index("--steps") + 1])
    opt = OptConfig(lr=1e-3, warmup_steps=5, stable_steps=max(10, steps_n),
                    decay_steps=10, moment_dtype=cfg.opt_dtype)
    pipe = TokenPipeline(cfg.vocab_size, batch, seq, seed=0)
    b = train_launch.make_batch(pipe, DEVICE)
    ops.reset_launches()
    t = time.perf_counter()
    a_state = init_train_state(cfg, opt, device=DEVICE, seed=0)
    cell = steps_mod.build_train_cell(a_state.model, ShapeConfig(
        "train_4k", seq, batch, "train"), mesh=mesh, opt=opt,
        microbatches=mb)
    got = {k: float(steps_mod.gather(v)) for k, v in cell(**b).items()}
    torch.cuda.synchronize()
    cell_s = time.perf_counter() - t
    del cell, a_state
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(cfg, opt, device=DEVICE, seed=0)
    _, want = make_train_step(cfg, opt, microbatches=mb)(state, b)
    want = {k: float(v) for k, v in want.items()}
    launches = ops.launches()
    rec = {"config": cfg.name, "layers": cfg.num_layers,
           "batch": [batch, seq], "microbatches": mb,
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "cell": got, "phase_11_step": want,
           "loss_rel_err": abs(got["loss"] - want["loss"]) / abs(
               want["loss"]),
           "grad_norm_rel_err": abs(got["grad_norm"] - want["grad_norm"]) /
           abs(want["grad_norm"]),
           "bit_equal": got["loss"] == want["loss"] and
           got["grad_norm"] == want["grad_norm"],
           "tolerance": 1e-6, "cell_s": cell_s, "launches": launches,
           "card": card}
    say("mesh", phase="train_cell", **rec)
    require(rec["loss_rel_err"] <= 1e-6 and rec["grad_norm_rel_err"] <= 1e-6,
            f"the train cell's step differs from phase 11's: {rec}")
    require(not any(launches.values()), f"training launched kernels "
            f"{launches}: it runs the plain versions")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"minicpm-2b-train-cell": launches}


def mesh_phase(gen, card):
    """Phase 13: (a) ``long_500k`` through a 1x1 mesh for the Jamba period,
    xLSTM-125M and (in (b)) Mixtral-8x22B; (b) Mixtral-8x22B served; (c)
    one train-cell step.  Returns (kernel records by key, launches by
    path)."""
    mesh = make_host_mesh()
    recs, launches = {}, {}
    try:
        for name, cfg in (("at_long_500k_jamba", jamba_period()),
                          (None, get_config(XLSTM_ARCH))):
            with timed(f"long_500k {cfg.name}"):
                model = init_full(cfg)
                attn, by_path = long_phase(model, mesh, name)
                recs.update(attn)
                launches.update(by_path)
                del model
                gc.collect()
                torch.cuda.empty_cache()
        with timed(MIXTRAL_22B):
            attn, by_path = mixtral_22b_phase(gen, mesh)
        recs.update(attn)
        launches.update(by_path)
        with timed("train_cell"):
            launches.update(train_cell_check(mesh, card))
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return recs, launches


# ---------------------------------------------------------------------------
# phase 9: the online gateway and its HTTP server, on granite-8b
# ---------------------------------------------------------------------------

# the reference's lmsys trace at 1 qps for 20 s (seed 0: 13 requests, 17,392
# prompt and 5,225 new tokens), each request sent over HTTP at its arrival
# (offset by TRACE_AT); besides it one client that disconnects after token
# CANCEL_AFTER, one that stops reading after token 2 until the gateway has
# paused its stream, and first a burst: a prompt alone (one new token) whose
# prefill holds the card while two more requests arrive, so that the second
# of them is prefilled in a fused step beside the first one's decode (a
# request that arrives while others decode is prefilled alone: the decode
# lane is busy at its arrival, ROADMAP A4)
GATEWAY_TRACE = dict(trace="lmsys", qps=1.0, duration=20.0, seed=0)
GATEWAY_BURST = [dict(at=0.0, prompt_len=6000, max_new_tokens=1),
                 dict(at=0.05, prompt_len=600, max_new_tokens=24),
                 dict(at=0.05, prompt_len=700, max_new_tokens=24)]
TRACE_AT = 1.5
GATEWAY_CANCEL = dict(at=2.5, prompt_len=800, max_new_tokens=300)
GATEWAY_SLOW = dict(at=3.5, prompt_len=1024, max_new_tokens=400)
CANCEL_AFTER = 4
STREAM_BUFFER = 8           # GatewayPolicy.stream_buffer
COMPARE_TOKENS = 64         # tokens held beside serve_real's
GATEWAY_DEADLINE_S = 240.0


class Client:
    """One HTTP client of phase 9, run by the client process
    (``ChildClients``): it POSTs /v1/generate at ``at`` seconds after the
    phase's t0 and reads the NDJSON stream line by line with the receive
    times; with ``cancel_after`` it disconnects after that token index,
    with ``pause`` it stops reading after token 2 until its stream is
    paused (evicted)."""

    def __init__(self, at, body, cancel_after=None, pause=False):
        self.at, self.body = at, body
        self.cancel_after, self.pause = cancel_after, pause
        self.lines, self.times, self.error, self.sent = [], [], None, None

    def token_times(self):
        return [t for t, ev in zip(self.times, self.lines)
                if ev["type"] == "token"]


class ChildClients:
    """The clients and the /healthz monitor in a child process
    (``smoke_clients.py``, which imports no torch), so that their threads
    never take this process's GIL.  Its records come back over a pipe, on
    ``time.perf_counter()`` as the parent's: both read CLOCK_MONOTONIC,
    which ``check_clock`` verifies.  A paused client waits on an eviction
    that ``evicted`` reports to the child."""

    def __init__(self):
        self.proc = subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "smoke_clients.py")],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            bufsize=1)

    def send(self, **msg):
        self.proc.stdin.write(json.dumps(msg) + "\n")
        self.proc.stdin.flush()

    def read(self):
        line = self.proc.stdout.readline()
        require(line, "gateway: the client process ended early")
        return json.loads(line)

    def check_clock(self):
        """The child's ``perf_counter`` read between two of the parent's:
        returns (before, child, after)."""
        before = time.perf_counter()
        self.send(clock=True)
        child = self.read()["clock"]
        after = time.perf_counter()
        require(before <= child <= after, f"gateway: the client process's "
                f"clock reads {child} outside [{before}, {after}]")
        return before, child, after

    def start(self, port, t0, clients):
        self.clients = clients
        self.send(port=port, t0=t0, poll_s=0.25, clients=[
            {"at": c.at, "body": c.body, "cancel_after": c.cancel_after,
             "pause": c.pause} for c in clients])

    def evicted(self, rid):
        self.send(evicted=rid)

    def finish(self):
        """Stops the monitor; fills each client's records from the child's;
        returns the monitor's /healthz replies."""
        self.send(stop=True)
        out = self.read()
        self.proc.wait(30)
        for c, rec in zip(self.clients, out["clients"]):
            c.lines, c.times = rec["lines"], rec["times"]
            c.sent, c.error = rec["sent"], rec["error"]
        return out["health"]


def http_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def stats_ms(xs):
    return {"mean": float(np.mean(xs)) * 1e3,
            "p95": float(np.percentile(xs, 95)) * 1e3} if xs else None


def gateway_phase(model):
    """Phase 9: ``GatewayHTTPServer`` in this process on 127.0.0.1, over
    one RAPID worker (``RapidEngine`` + ``KernelExecutor`` with the pool
    the scheduler sizes from ``H100``) on ``RealTimeClock``, driven over
    HTTP by clients in a process of their own (``ChildClients``), so that
    none of their threads takes this process's GIL: ``GATEWAY_BURST``,
    ``GATEWAY_TRACE`` at its arrivals, a client that disconnects, and one
    that stops reading until its stream is paused, beside a /healthz
    monitor.  The objects of the earlier phases are frozen out of the
    garbage collector's walks while it serves, as a server does after its
    warm-up.  Returns the kernel launches of the run and the stamp lags'
    p99 and max (ms, net of plans)."""
    cfg = model.cfg
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    trace, arrivals = serve_engine.trace_requests(cfg, **GATEWAY_TRACE)
    prompts = serve_engine.SeededPrompts(cfg.vocab_size,
                                         GATEWAY_TRACE["seed"])
    gw = serve_engine.make_gateway(
        model, serve_engine.serve_config(), prompts, clock=RealTimeClock(),
        policy=GatewayPolicy(stream_buffer=STREAM_BUFFER))
    worker = gw.registry.workers[0]
    eng, ex = worker.engine, worker.engine.executor
    beats = []
    beat = worker._heartbeat
    worker._heartbeat = lambda wid: (beats.append(gw.clock.now), beat(wid))
    # each lane completion's due time (the engine's ``now`` before the
    # launch plus its duration) and when it fired, on the gateway's clock
    lanes, clock_at = [], gw.clock.at

    def at_lane(t, fn):
        if "_apply" not in fn.__qualname__:
            return clock_at(t, fn)

        def fire():
            lanes.append((t, gw.clock.now))
            fn()
        return clock_at(t, fire)

    gw.clock.at = at_lane
    server = GatewayHTTPServer(gw, "127.0.0.1", 0, prompts=prompts)
    errors, health, offset = [], [], []
    child = ChildClients()
    clock = child.check_clock()

    def on_engine(ev):
        if type(ev).__name__ == "PhaseEvent" and ev.phase == "preempted":
            child.evicted(ev.rid)

    eng.subscribe(on_engine)

    async def main():
        loop = asyncio.get_running_loop()
        loop.set_exception_handler(
            lambda lp, ctx: errors.append(str(ctx.get("exception") or
                                              ctx.get("message"))))
        await server.start()
        port = server.port
        offset.append(gw.clock.now - time.perf_counter())
        ops.reset_launches()
        t0 = time.perf_counter() + 0.2
        clients = [Client(b["at"], {k: b[k] for k in ("prompt_len",
                                                     "max_new_tokens")})
                   for b in GATEWAY_BURST]
        clients += [Client(TRACE_AT + arrivals[r.rid],
                           {"prompt_len": len(r.prompt),
                            "max_new_tokens": r.max_new}) for r in trace]
        cancel = Client(GATEWAY_CANCEL["at"],
                        {k: GATEWAY_CANCEL[k] for k in
                         ("prompt_len", "max_new_tokens")},
                        cancel_after=CANCEL_AFTER)
        slow = Client(GATEWAY_SLOW["at"],
                      {k: GATEWAY_SLOW[k] for k in
                       ("prompt_len", "max_new_tokens")}, pause=True)
        child.start(port, t0, clients + [cancel, slow])
        require((await loop.run_in_executor(None, child.read)).get(
            "clients_done"), "gateway: the client process misspoke")
        # the disconnect's cancel reaches the engine at its next write
        while gw._live and time.perf_counter() < t0 + GATEWAY_DEADLINE_S:
            await asyncio.sleep(0.05)
        launches = ops.launches()
        health.extend(await loop.run_in_executor(None, child.finish))
        metrics = await loop.run_in_executor(
            None, lambda: http_get(port, "/metrics"))
        await server.close()
        return clients, cancel, slow, launches, metrics

    torch.cuda.synchronize()
    gc.collect()
    gc.freeze()
    try:
        clients, cancel, slow, launches, metrics = asyncio.run(main())
    finally:
        gc.unfreeze()
        if child.proc.poll() is None:
            child.proc.kill()
            child.proc.wait()
    torch.cuda.synchronize()
    served_s = time.perf_counter() - t_phase
    require(not errors, f"gateway: the event loop caught {errors[:3]}")
    bad = [c.error for c in clients + [slow] if c.error]
    require(not bad, f"gateway: clients failed: {bad[:3]}")
    require(all(c.lines for c in clients + [slow, cancel]),
            "gateway: a stream gave no line")
    fleet = list(gw.stream.events())
    terminal = {ev.rid: ev for ev in fleet if type(ev).__name__ in (
        "FinishedEvent", "RejectedEvent", "CancelledEvent")}
    streams = {c.lines[-1]["rid"]: c for c in clients + [slow]}
    cancel_rid, slow_rid = cancel.lines[0]["rid"], slow.lines[-1]["rid"]
    preempted = [ev.rid for ev in fleet if type(ev).__name__ ==
                 "PhaseEvent" and ev.phase == "preempted"]
    records = {r.rid: r for r in gw.metrics.records}
    kinds = collections.Counter(e["kind"] for e in ex.log)
    resumed = [e for e in ex.log if e["resumed"]]
    launched = {k for k, n in launches.items() if n > 0}
    states = [h[1]["workers"] if h[0] == 200 else h for h in health]
    raw, net = serve_engine.token_stamp_lags(ex.log, eng.stream.events(),
                                             offset[0])
    # how far each lane was due after the end of the launch before it
    # fired (the double wait would put it a whole launch after)
    ends = sorted(e["host_end"] + offset[0] for e in ex.log)
    due_after = [due - ends[bisect.bisect_right(ends, fired + 1e-6) - 1]
                 for due, fired in lanes]
    # client side against the engine's records
    finished = {r.rid: r for r in eng.finished}
    done = [rid for rid in streams if rid in finished]
    client_ttft = [streams[rid].token_times()[0] - streams[rid].sent
                   for rid in done]
    client_itl = [b - a for rid in done for a, b in zip(
        streams[rid].token_times(), streams[rid].token_times()[1:])]
    engine_ttft = [finished[rid].ttft for rid in done]
    engine_itl = [x for rid in done for x in finished[rid].itls]
    gaps = np.diff(beats) if len(beats) > 1 else []
    say("gateway", phase="run", config=cfg.name, **GATEWAY_TRACE,
        requests=len(trace), burst=GATEWAY_BURST, cancelled_rid=cancel_rid,
        paused_rid=slow_rid, kernel_launches=launches, launches=dict(kinds),
        reprefills=[(e["rids"][0], e["resumed"], e["prefill_tokens"],
                     e["kind"], e["wall_s"]) for e in resumed],
        preempted=preempted,
        pool_blocks=ex.num_blocks, pool_gb=ex.pool_bytes / 1e9,
        decode_graphs=ex.graphs.stats(), served_s=served_s,
        heartbeats=len(beats),
        longest_heartbeat_gap_s=float(max(gaps)) if len(gaps) else None,
        longest_heartbeat_gap_at_s=float(beats[int(np.argmax(gaps)) + 1])
        if len(gaps) else None,
        heartbeat_s=gw.policy.heartbeat_s,
        heartbeat_timeout_s=gw.policy.heartbeat_timeout_s,
        healthz_polls=len(health),
        clock_check={"parent_before": clock[0], "child": clock[1],
                     "parent_after": clock[2]},
        clamped=gw.clock.stats.clamped,
        dispatched=gw.clock.stats.dispatched)
    say("gateway", phase="latency", config=cfg.name,
        clock={"client": "host wall clock from the POST to each line",
               "engine": "RealTimeClock stamps of the TokenEvents"},
        client_ttft_ms=stats_ms(client_ttft), engine_ttft_ms=stats_ms(
            engine_ttft), client_itl_ms=stats_ms(client_itl),
        engine_itl_ms=stats_ms(engine_itl),
        token_stamp_after_lane_end_ms={
            "max_raw": max(raw) * 1e3, "max_net": max(net) * 1e3,
            "p99_net": float(np.percentile(net, 99)) * 1e3,
            "p95_raw": float(np.percentile(raw, 95)) * 1e3,
            "raw_over_limit": sum(x > serve_engine.STAMP_P99_S
                                  for x in raw),
            "net_over_limit": sum(x > serve_engine.STAMP_P99_S
                                  for x in net),
            "tokens": len(raw),
            "limit_p99_net": serve_engine.STAMP_P99_S * 1e3,
            "limit_max_net": serve_engine.STAMP_MAX_S * 1e3}
        if raw else None, lanes=len(lanes),
        lane_due_after_launch_end_ms_max=max(due_after) * 1e3
        if due_after else None)
    for rid, c in streams.items():
        require(c.lines[-1]["type"] == "finished",
                f"gateway: request {rid}'s stream ended in {c.lines[-1]}")
        idx = [ev["index"] for ev in c.lines if ev["type"] == "token"]
        require(idx == list(range(c.body["max_new_tokens"])),
                f"gateway: request {rid}'s token indices are not "
                f"0..{c.body['max_new_tokens'] - 1} once each")
    require(type(terminal.get(cancel_rid)).__name__ == "CancelledEvent",
            f"gateway: the disconnected stream ended in "
            f"{terminal.get(cancel_rid)}")
    require(preempted == [slow_rid], f"gateway: preempted {preempted}, "
            f"only the paused stream {slow_rid} should be")
    require(not any(r.rejected for r in records.values()),
            "gateway: a request was rejected")
    require(sum(r.preemptions for r in records.values()
                if not r.cancelled) == 1,
            "gateway: preemptions other than the scripted pause")
    require(launched == path_kernels(cfg),
            f"gateway: launched {sorted(launched)}, its path runs "
            f"{sorted(path_kernels(cfg))}: {launches}")
    require(kinds["fused"] >= 1, f"gateway: no fused step: {dict(kinds)}")
    require(resumed and all(e["rids"][0] == slow_rid for e in resumed),
            "gateway: no re-prefill of the paused request alone")
    kv = eng.kv
    require(kv.num_requests == 0 and kv.allocator.free_count ==
            kv.allocator.num_blocks, "gateway: KV pool not reclaimed")
    require(ex.rows_free == ex.state_rows and not ex._spare,
            "gateway: state rows or spare pages not reclaimed")
    require(states and all(s == {"rapid-0": "up"} for s in states),
            f"gateway: /healthz read "
            f"{[s for s in states if s != {'rapid-0': 'up'}][:3]}")
    require(metrics[0] == 200 and "fleet" in metrics[1],
            f"gateway: /metrics gave {str(metrics)[:200]}")
    require(due_after and max(due_after) <= 1e-4,
            f"gateway: of {len(lanes)} lane completions one was due "
            f"{max(due_after, default=0) * 1e3:.3f} ms after its launch's "
            f"end")
    late_tokens(ex.log, eng.stream.events(), offset[0])
    late = serve_engine.stamps_late(net)
    require(late is None, f"gateway: {late}")
    # the tokens beside serve_real's greedy tokens for the same prompts,
    # once the gateway's pool is freed
    tokens = ex.tokens
    del gw, server, eng, ex, worker, beat
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    rids = sorted(streams)
    reqs = [serve_real.Request(rid, prompts[rid], min(
        COMPARE_TOKENS, streams[rid].body["max_new_tokens"])) for rid in rids]
    out = serve_real.serve(model, reqs, slots=SERVE["slots"],
                           page=SERVE["page"], f_decode=SERVE["f_decode"])
    real = {r.rid: r.tokens for r in out["requests"]}
    same = sum(tokens[rid][:len(real[rid])] == real[rid] for rid in rids)
    alone = serve_real.serve(model, [serve_real.Request(
        slow_rid, prompts[slow_rid], GATEWAY_SLOW["max_new_tokens"])],
        slots=SERVE["slots"], page=SERVE["page"],
        f_decode=SERVE["f_decode"])["requests"][0].tokens
    got = tokens[slow_rid]
    first_diff = next((i for i, (a, b) in enumerate(zip(got, alone))
                       if a != b), None)
    say("gateway", phase="beside_serve_real", config=cfg.name,
        compared_tokens=COMPARE_TOKENS, streams=len(rids),
        streams_tokens_equal_serve_real=same,
        paused_request={"rid": slow_rid, "resumed_at_token": [
            e["resumed"] for e in resumed], "tokens": len(got),
            "equal_uninterrupted": got == alone,
            "first_difference_at": first_diff},
        seconds=time.perf_counter() - t)
    return launches, {"p99_net_ms": float(np.percentile(net, 99)) * 1e3,
                      "max_net_ms": max(net) * 1e3}


# ---------------------------------------------------------------------------
# phase 11: training
# ---------------------------------------------------------------------------

# (a) every mixer and FFN the port trains, reduced, float32 (TF32 off):
# the card's lm_loss and gradients against the CPU's on the same weights
# and batch.  The gradient bound is 1e-4 of the gradient's largest |value|
# over all leaves: xLSTM's mLSTM normaliser divides by sums that cancel,
# and a leaf whose exact gradient is 0 (the sLSTM input-gate bias) holds
# only rounding noise (tests/test_torch_training.py).
TRAIN_ARCHS = ("granite-8b", "mixtral-8x7b", "jamba-1.5-large-398b",
               "minicpm-2b", "xlstm-125m")
TOL_TRAIN_LOSS, TOL_TRAIN_GRAD = 1e-5, 1e-4
# ... and one make_train_step (microbatches 2) on each side from the same
# weights and batch.  Where the CPU step's gradient is above 1e-3 of its
# largest |value| (ten times the gradient bound, so both signs agree; read
# from its first moment, (1 - b1) x clip x g, since with an MoE layer the
# microbatches route otherwise than the whole batch), the first
# AdamW step moves each parameter by lr x its sign on both sides: the
# parameters within 1e-5 of their leaf's largest |value|.  The moments are
# the gradient scaled (mu) and squared (nu): within the gradient bound, and
# twice it, of their largest |value|.
TRAIN_OPT = OptConfig(lr=3e-3, warmup_steps=5, stable_steps=100,
                      decay_steps=10)
TOL_STEP_PARAM, STEP_MASK = 1e-5, 1e-3
# (b) MiniCPM-2B at every published width, the reference's train_4k length
MINICPM_TRAIN = ["--arch", "minicpm-2b", "--full", "--steps", "6",
                 "--batch", "2", "--seq-len", "4096", "--microbatches", "2",
                 "--ckpt-every", "1000"]
# (d) xLSTM-125M at every published width, checkpointed at steps 4 and 8
XLSTM_TRAIN = ["--arch", "xlstm-125m", "--full", "--steps", "8", "--batch",
               "8", "--seq-len", "512", "--ckpt-every", "4",
               "--compress-grads"]
# (e) the train_small counterpart: its failure at step 30 restarts from the
# checkpoint of step 30 (one every 10 steps: its default 50 would fail
# before the first checkpoint)
TRAIN_SMALL = ["--steps", "60", "--fail-at", "30", "--ckpt-every", "10"]


def loss_and_grads(model, toks, labels, pos):
    loss = tf.lm_loss(model, toks, labels, pos)
    names, params = zip(*model.named_parameters())
    return loss.item(), dict(zip(names, torch.autograd.grad(loss, params)))


def step_card_vs_cpu(cfg, cpu, batch):
    """One train step from ``cpu``'s weights on each side: the relative
    errors of its loss and grad norm, and the worst leaf's error of the
    parameters and of each moment where the CPU step's gradient is not
    near 0 (TOL_STEP_PARAM's comment)."""
    states, metrics = {}, {}
    for dev in ("cpu", DEVICE):
        model = copy.deepcopy(cpu).to(dev)
        state = TrainState(model, adamw_init(dict(model.named_parameters()),
                                             TRAIN_OPT),
                           torch.zeros((), dtype=torch.int32, device=dev))
        states[dev], m = make_train_step(cfg, TRAIN_OPT, microbatches=2)(
            state, {k: v.to(dev) for k, v in batch.items()})
        metrics[dev] = {k: float(v) for k, v in m.items()}
    cpu_s, card_s = states["cpu"], states[DEVICE]
    top = max(float(m.abs().max()) for m in cpu_s.opt.mu.values())
    mask = {n: m.abs() > STEP_MASK * top for n, m in cpu_s.opt.mu.items()}

    def worst(got, want, per_leaf):
        want = {n: w.detach() for n, w in want.items()}
        big = max(float(w.abs().max()) for w in want.values())
        errs = []
        for n, w in want.items():
            d = (got[n].detach().cpu() - w)[mask[n]].abs()
            errs.append((float(d.max()) if d.numel() else 0.0) /
                        max(float(w.abs().max()) if per_leaf else big, 1e-30))
        return max(errs)

    mc, mg = metrics["cpu"], metrics[DEVICE]
    return {"step_loss_rel_err": abs(mg["loss"] - mc["loss"]) / mc["loss"],
            "step_grad_norm_rel_err": abs(mg["grad_norm"] - mc["grad_norm"])
            / mc["grad_norm"],
            "step_param_err": worst(card_s.params, cpu_s.params, True),
            "step_mu_err": worst(card_s.opt.mu, cpu_s.opt.mu, False),
            "step_nu_err": worst(card_s.opt.nu, cpu_s.opt.nu, False),
            "step_masked_share": sum(int(m.sum()) for m in mask.values()) /
            sum(m.numel() for m in mask.values())}


def train_card_vs_cpu():
    """(a): per arch the loss's relative error and the worst gradient
    leaf's max |card - cpu| over the gradient's largest |value|, then one
    train step's (``step_card_vs_cpu``)."""
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = replace(get_reduced_config(arch), dtype="float32")
        cpu = tf.init_model(cfg, device="cpu", seed=0).requires_grad_()
        card = copy.deepcopy(cpu).to(DEVICE)
        rs = np.random.RandomState(1)
        toks, labels = (torch.from_numpy(rs.randint(
            0, cfg.vocab_size, size=(2, 32)).astype(np.int32))
            for _ in range(2))
        pos = torch.arange(32, dtype=torch.int32).expand(2, 32)
        lc, gc_ = loss_and_grads(cpu, toks, labels, pos)
        lg, gg = loss_and_grads(card, *(t.to(DEVICE)
                                        for t in (toks, labels, pos)))
        top = max(float(g.abs().max()) for g in gc_.values())
        worst = max(gc_, key=lambda n: float((gg[n].cpu() - gc_[n])
                                             .abs().max()))
        out[arch] = {"loss_cpu": lc, "loss_rel_err": abs(lg - lc) / abs(lc),
                     "grad_err": float((gg[worst].cpu() - gc_[worst]).abs()
                                       .max()) / top, "worst_leaf": worst}
        out[arch].update(step_card_vs_cpu(cfg, cpu, {
            "inputs": toks, "labels": labels, "positions": pos}))
    limits = {"loss_rel_err": TOL_TRAIN_LOSS, "grad_err": TOL_TRAIN_GRAD,
              "step_loss_rel_err": TOL_TRAIN_LOSS,
              "step_grad_norm_rel_err": TOL_TRAIN_GRAD,
              "step_param_err": TOL_STEP_PARAM,
              "step_mu_err": TOL_TRAIN_GRAD,
              "step_nu_err": 2 * TOL_TRAIN_GRAD}
    say("train", phase="card_vs_cpu", dtype="float32", tf32=False,
        limits=limits, **out)
    for arch, r in out.items():
        require(all(r[k] <= lim for k, lim in limits.items()),
                f"train: {arch}'s loss, gradients or train step on the card "
                f"differ from the CPU's: {r}")
    return out


def tree_equal(a, b) -> bool:
    la, lb = ckpt_mod.leaves(a), ckpt_mod.leaves(b)
    return list(la) == list(lb) and all(
        la[n].dtype == lb[n].dtype and la[n].device == lb[n].device and
        torch.equal(la[n], lb[n]) for n in la)


def train_run(argv, card):
    """One ``launch/train.main`` run on the card with the kernels' counts
    set to 0 before it: training runs the plain versions (``impl="ref"``,
    as the reference does), so none may launch.  Checks every loss and
    grad norm finite and the last loss below the first."""
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launches()
    out = train_launch.main(argv + ["--device", DEVICE])
    torch.cuda.synchronize()
    out["launches"] = ops.launches()
    cfg = out["state"].model.cfg
    n = sum(p.numel() for p in out["state"].model.parameters())
    tokens = int(argv[argv.index("--batch") + 1]) * \
        int(argv[argv.index("--seq-len") + 1])
    out["record"] = {
        "config": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "params": n, "tokens_per_step": tokens, "dtype": cfg.dtype,
        "moment_dtype": cfg.opt_dtype, "losses": out["losses"],
        "grad_norms": out["grad_norms"], "step_s": out["step_s"],
        "first_step_s": out["first_step_s"],
        "tokens_per_s": out["tokens_per_s"],
        "peak_gb": out["peak_bytes"] / 1e9,
        "model_flop_share": 6 * n * tokens / (
            out["step_s"] * PEAK_FLOPS[torch.bfloat16]),
        "model_flop_share_counts": "6 N tokens, no remat recompute, "
        "over 989 TFLOP/s", "kernel_launches": out["launches"],
        "card": card}
    require(not any(out["launches"].values()),
            f"train: {cfg.name}'s training launched kernels "
            f"{out['launches']}: it runs the plain versions")
    require(out["finite"], f"train: {cfg.name}: a loss or grad norm is not "
            f"finite: {out['losses']}, {out['grad_norms']}")
    require(out["losses"][-1] < out["losses"][0],
            f"train: {cfg.name}'s loss did not descend: {out['losses']}")
    return out


def serve_trained(model, mem_before, card):
    """(c): the trained model serves the smoke's first 2 requests through
    serve_real on the kernels (no graph is built), kernel path against
    plain path on its first steps; pool and slots reclaimed, and the memory
    after serving is the weights' (no optimizer state or graph left)."""
    cfg = model.cfg
    gc.collect()
    torch.cuda.empty_cache()
    reqs = serving_requests(cfg)[:2]
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=SERVE["slots"],
                              page=SERVE["page"], f_decode=SERVE["f_decode"])
    torch.cuda.synchronize()
    launches = ops.launches()
    errs, _ = first_steps_kernel_vs_plain(model, reqs, SERVE["page"])
    gc.collect()
    torch.cuda.empty_cache()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    after = torch.cuda.memory_allocated()
    say("train", phase="trained_serves", config=cfg.name, launches=launches,
        **serve_real.summarize(result), metric="max|kernel-plain|/max|plain|",
        limit=TOL_LOGITS, **errs, mem_before_training_gb=mem_before / 1e9,
        mem_after_serving_gb=after / 1e9, weights_gb=weights / 1e9,
        card=card)
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == path_kernels(cfg),
            f"train: the trained {cfg.name} launched {sorted(launched)}")
    require(result["pool_reclaimed"] and result["state_slots_reclaimed"],
            "train: the trained model's pool or slots not reclaimed")
    require(all(e < TOL_LOGITS for e in errs.values()),
            f"train: the trained model's kernel and plain logits differ: "
            f"{errs}")
    require(all(p.grad is None for p in model.parameters()) and
            after <= mem_before + weights + (256 << 20),
            f"train: {after / 1e9:.2f} GB held after serving, over the "
            f"{weights / 1e9:.2f} GB of weights")
    return launches


def xlstm_checkpoints(out, ckpt_dir):
    """(d): the step-8 checkpoint restored onto the card equals the live
    state bit for bit; a checkpoint written from CPU tensors restores onto
    the card."""
    state = out["state"]
    live = ckpt_mod.restore_checkpoint(ckpt_dir, state, step=8)
    host = ckpt_mod.restore_checkpoint(ckpt_dir, state, step=8, device="cpu")
    from_cpu = os.path.join(ckpt_dir, "from_cpu")
    ckpt_mod.save_checkpoint(from_cpu, 8, host)
    back = ckpt_mod.restore_checkpoint(from_cpu, host, device=DEVICE)
    res = {"kept_steps": sorted(os.listdir(ckpt_dir)),
           "restored_equals_live": tree_equal(live, state),
           "host_copy_on_cpu": host.model.tok.device.type == "cpu",
           "from_cpu_restored_on_card_equals_live": tree_equal(back, state)}
    say("train", phase="xlstm_checkpoints", **res)
    require(res["restored_equals_live"] and res["host_copy_on_cpu"] and
            res["from_cpu_restored_on_card_equals_live"],
            f"train: checkpoint round trip: {res}")


def grad_guard_fault():
    """(f): a kernel wrapper called on an input that requires grad, under
    grad mode, must raise (no kernel has a backward)."""
    q = torch.randn(1, 64, 4, 64, device=DEVICE, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 64, 4, 64, device=DEVICE, dtype=torch.bfloat16)
    try:
        ops.flash_prefill(q, k, k)
    except RuntimeError as e:
        say("train", phase="grad_guard_fault", raised=str(e))
        return
    raise PhaseFailed("train: flash_prefill ran on an input that requires "
                      "grad: its output would be silently detached")


def train_phase(card):
    """Phase 11; returns the launch counts of its runs by path."""
    with timed("train_card_vs_cpu"):
        train_card_vs_cpu()
    gc.collect()
    torch.cuda.empty_cache()
    mem_before = torch.cuda.memory_allocated()
    with timed("train_minicpm-2b"):
        out = train_run(MINICPM_TRAIN, card)
    say("train", phase="minicpm-2b", **out["record"])
    launches = {"minicpm-2b-train": out["launches"]}
    model = out["state"].model
    del out
    with timed("train_minicpm-2b_serves"):
        launches["minicpm-2b-trained-serve"] = serve_trained(
            model, mem_before, card)
    del model
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as d, \
            timed("train_xlstm-125m"):
        out = train_run(XLSTM_TRAIN + ["--ckpt-dir", d], card)
        say("train", phase="xlstm-125m", **out["record"])
        launches["xlstm-125m-train"] = out["launches"]
        xlstm_checkpoints(out, d)
        del out
    gc.collect()
    torch.cuda.empty_cache()
    with timed("train_small"):
        ops.reset_launches()
        out = train_small.main(TRAIN_SMALL + ["--device", DEVICE])
        launches["train_small"] = ops.launches()
        say("train", phase="train_small", losses_first_min_last=[
            out["losses"][0], min(out["losses"]), out["losses"][-1]],
            restarts=out["supervisor"].restarts, steps=len(out["losses"]),
            log_restart=[e for e in out["supervisor"].log
                         if e["event"] == "restart"])
        require(out["supervisor"].restarts == 1,
                "train: train_small did not restart once")
        del out
    grad_guard_fault()
    return launches


@contextlib.contextmanager
def timed(phase):
    t = time.perf_counter()
    yield
    say("time", phase=phase, seconds=time.perf_counter() - t)


def late_tokens(log, events, offset):
    """ROADMAP C8, read after the run: for every token stamped more than
    ``STAMP_MAX_S`` after its lane's end net of plans, the launches of the
    plans from the one before its lane's to the one after the last plan
    that started before its stamp (kind, plan, graph, start on the clock,
    host end on the clock, wall seconds, batch); and the tokens over
    ``STAMP_P99_S`` counted by the kind and graph state of their lane's
    launch and of the next plan's."""
    stamps = serve_engine.token_stamps(log, events, offset)
    by_plan = collections.defaultdict(list)
    for e in log:
        by_plan[e["plan"]].append(e)

    def fields(e):
        return {"kind": e["kind"], "plan": e["plan"], "graph": e["graph"],
                "t_start": e["t_start"], "host_end": e["host_end"] + offset,
                "wall_s": e["wall_s"], "decode_bs": e["decode_bs"],
                "rids": len(e["rids"])}

    def kind(p):
        es = by_plan.get(p)
        return f"{es[-1]['kind']}/{es[-1]['graph']}" if es else "none"

    over, counts = [], collections.Counter()
    for st in stamps:
        if st["net"] > serve_engine.STAMP_P99_S:
            counts[f"{kind(st['plan'])} then {kind(st['plan'] + 1)}"] += 1
        if st["net"] <= serve_engine.STAMP_MAX_S:
            continue
        last = max([p for p, es in by_plan.items()
                    if min(e["t_start"] for e in es) <= st["t"]],
                   default=st["plan"])
        over.append({**st, "launches": [
            fields(e) for p in range(st["plan"] - 1, last + 2)
            for e in by_plan.get(p, [])]})
    say("gateway", phase="late_tokens", limit_ms=serve_engine.STAMP_MAX_S
        * 1e3, over_limit=over, over_p99_limit_by_plans=dict(counts))


def gateway_runs(runs):
    """``--gateway-runs``: phase 9 alone, ``runs`` times in a row on one
    granite-8b (after phase 4's serving run, as in the whole smoke).  A
    run that fails is reported and the next one starts.  Returns each
    run's stamp lags (ms) or its failure."""
    model = init_full(get_config("granite-8b"))
    serve_full(model)
    out = []
    for i in range(runs):
        with timed(f"gateway run {i}"):
            try:
                r = gateway_phase(model)[1]
            except PhaseFailed as e:
                r = {"failed": str(e)}
        out.append(r)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU (every phase, with no options).")
    ap.add_argument("--gateway-runs", type=int, default=0,
                    help="run only phase 9, this many times, and print each "
                    "run's stamp lags")
    ap.add_argument("--logits-depths", action="store_true",
                    help="run only the depth-and-seed table of Qwen2-VL's "
                    "logits: kernel and plain paths in bf16 against a "
                    "float32 plain path (ROADMAP C9)")
    ap.add_argument("--only-mesh", action="store_true",
                    help="run only phase 13 (after the build)")
    ap.add_argument("--only-hybrid", action="store_true",
                    help="run only phase 14 (after the build, and phase "
                    "6's RAPID run it is set beside)")
    ap.add_argument("--only-disagg", action="store_true",
                    help="run only phase 15 (after the build, and phase "
                    "6's RAPID run it is set beside)")
    ap.add_argument("--only-cells", nargs="?", const=str(CELL_SEED),
                    metavar="SEEDS",
                    help="run only phase 12 (after the build); with "
                    "comma-separated seeds, its cells once per seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave nothing"
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), nvidia_smi=card,
        torch=torch.__version__, cuda=torch.version.cuda)
    t_start = time.perf_counter()
    try:
        t = time.perf_counter()
        libs = build.build_all()
        say("build", seconds=time.perf_counter() - t,
            libraries=sorted(p.name for p in libs.values()),
            ptxas=build.ptxas_report())

        gen = torch.Generator(device=DEVICE).manual_seed(0)
        if args.gateway_runs:
            runs = gateway_runs(args.gateway_runs)
            say("gateway", phase="runs", card=card, stamp_lags=runs,
                cpus=os.cpu_count(),
                p99_net_ms=[r.get("p99_net_ms") for r in runs])
            return 1 if any("failed" in r for r in runs) else 0
        if args.logits_depths:
            with timed("logits_depths"):
                recs = logits_depths()
            say("depths", phase="table", card=card, limit=TOL_LOGITS,
                records=recs)
            return 0
        if args.only_hybrid:
            with timed("hybrid"):
                recs, launches = only_hybrid(gen)
            say("hybrid", phase="only", launches=launches,
                kernels={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms",
                                                "bound_by", "library_ms")}
                         for k, v in recs.items()})
            return 0
        if args.only_disagg:
            with timed("disagg"):
                launches = only_disagg()
            say("disagg", phase="only", launches=launches)
            return 0
        if args.only_mesh:
            with timed("mesh"):
                recs, launches = mesh_phase(gen, card)
            say("mesh", phase="only", launches=launches,
                kernels={k: list(v) for k, v in recs.items()})
            return 0
        if args.only_cells:
            with timed("cells"):
                recs, launches = cells_phase(gen, [
                    int(x) for x in args.only_cells.split(",")])
            say("cells", phase="only", launches=launches,
                kernels=list(recs))
            return 0
        with timed("kernels"):
            worst_f32, worst_bf16, recs = kernels_phase(gen)
        with timed("granite-8b"):
            launches, recs["flash_prefill_paged"] = granite_phase(gen)
        with timed("jamba-period"):
            jamba_attn, recs["ssm_scan"], jamba_launches = jamba_phase(gen)
        launches.update(jamba_launches)
        with timed("mixtral-8x7b"):
            mixtral_attn, mixtral_launches = mixtral_phase(gen)
        launches.update(mixtral_launches)
        with timed("llama3-70b"):
            launches.update(llama_phase(gen))
        with timed("archs"):
            archs_attn, archs_launches = archs_phase(gen)
        launches.update(archs_launches)
        gc.collect()
        torch.cuda.empty_cache()
        with timed("train"):
            launches.update(train_phase(card))
        gc.collect()
        torch.cuda.empty_cache()
        with timed("cells"):
            cells_attn, cells_launches = cells_phase(gen)
        launches.update(cells_launches)
        gc.collect()
        torch.cuda.empty_cache()
        with timed("mesh"):
            mesh_attn, mesh_launches = mesh_phase(gen, card)
        launches.update(mesh_launches)
        say("time", phase="total", seconds=time.perf_counter() - t_start)
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel's launches are those of the first serving run whose path
    # runs it: granite-8b for attention, the Jamba period for ssm_scan;
    # every serving run's own counts (Mixtral's, LLaMA's and phase 10's
    # too) are under launches_by_path
    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:113"),
               "flash_prefill_paged": (
                   "src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill.py:113"),
               "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                                   "src/repro/kernels/paged_attention.py:109"),
               "unified_pd": ("src/repro_torch/csrc/unified_pd.cu",
                              "src/repro/kernels/unified_pd.py:259"),
               "ssm_scan": ("src/repro_torch/csrc/ssm_scan.cu",
                            "src/repro/kernels/ssm_scan.py:88")}
    kernels = []
    for name, (src, replaces) in sources.items():
        r = recs[name]
        by_path = {path: n[name] for path, n in launches.items()}
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": next(n for n in by_path.values() if n),
                        "launches_by_path": by_path,
                        "max_abs_err": r["max_abs_err"],
                        "max_row_rel_err": r["max_row_rel_err"],
                        "fault_row_rel_err": r["fault_row_rel_err"],
                        "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "shape": r["shape"],
                        "f32_test_shapes_max_abs_err": worst_f32.get(
                            name, r.get("f32_test_shapes_max_abs_err"))})
        if name in worst_bf16:
            kernels[-1]["bf16_test_shapes"] = worst_bf16[name]
        for k in ("splits", "bound_share", "lanes", "stages", "random_A",
                  "from_h0", "persistent"):
            if k in r:
                kernels[-1][k] = r[k]
        for key, at in (("at_jamba_shapes", jamba_attn),
                        ("at_mixtral_shapes", mixtral_attn),
                        *archs_attn.items(), *cells_attn.items(),
                        *mesh_attn.items()):
            if name in at:
                kernels[-1][key] = {
                    k: at[name][k] for k in (
                        "max_abs_err", "max_row_rel_err", "fault_row_rel_err",
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms", "library", "shape", "splits",
                        "ctas", "persistent") if k in at[name]}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
