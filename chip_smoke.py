#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

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
               with float32 weights (1e-3), and the same profiled rerun.
The last two lines are the kernels' JSON record and the result line.
"""
import gc
import json
import os
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.config import get_config, replace  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import ssm_scan as ss  # noqa: E402
from repro_torch.kernels import unified_pd as up  # noqa: E402
from repro_torch.kvcache import kv_pages_for  # noqa: E402
from repro_torch.launch import serve_real  # noqa: E402
from repro_torch.models import mamba as mamba_mod  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.layers import embed_tokens, rmsnorm  # noqa: E402

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


def prefill_work(q, k):
    """Bytes (q,k,v read once, o written once) and causal multiply-add
    operations (2 per MAC) of q (B,Hq,S,D) against k (B,Hkv,S,D)."""
    B, Hq, S, D = q.shape
    pairs = B * Hq * S * (S + 1) // 2
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
    """q, pages and scattered block tables for sequences of ``lens``."""
    B = len(lens)
    mp = -(-max(lens) // page)
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


def prefill_faults(q, k, v):
    """The plain prefill under planted faults: the last key never read;
    key BK (the first of the second k-block) read as key BK-1."""
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64], v2[:, :, 64] = k[:, :, 63], v[:, :, 63]
    return {"last_key_dropped": ref.causal_attention(q, k[:, :, :-1],
                                                     v[:, :, :-1]),
            "key_64_read_as_63": ref.causal_attention(q, k2, v2)}


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
    return faults


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


def first_steps_kernel_vs_plain(model, reqs, page):
    """The run's first prefill (request 0) and first concurrent step
    (prefill request 1 + decode request 0), through the kernel path and
    the plain path on the same inputs and cache contents."""
    cfg = model.cfg
    r0, r1 = reqs[0], reqs[1]
    n0 = len(r0.prompt)
    blocks = kv_pages_for(n0 + 1, page)
    cache = tf.init_cache(cfg, blocks, page, 1, device=DEVICE)
    tab = torch.arange(blocks, device=DEVICE, dtype=torch.int32)[None]
    slot = torch.zeros(1, device=DEVICE, dtype=torch.int64)
    p0 = torch.tensor(r0.prompt[None], device=DEVICE)
    pos0 = torch.arange(n0, device=DEVICE)[None]
    lk, aux = tf.forward(model, p0, pos0, impl="kernel", return_aux=True,
                         last_only=True)
    lr = tf.forward(model, p0, pos0, impl="ref", last_only=True)
    tf.write_prefill_to_cache(cache, aux, tab, slot)
    tok = tf.greedy_sample(lk, cfg.vocab_size)
    lens = torch.tensor([n0], device=DEVICE, dtype=torch.int32)
    p1 = torch.tensor(r1.prompt[None], device=DEVICE)
    pos1 = torch.arange(len(r1.prompt), device=DEVICE)[None]
    outs = {}
    for impl in ("kernel", "ref"):
        c = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        p_logits, _, d_logits, _ = tf.fused_pd_forward(
            model, p1, pos1, tok, lens[:, None], c, tab, lens, slot,
            f_decode=SERVE["f_decode"], impl=impl)
        outs[impl] = (p_logits, d_logits)
    return {"first_prefill": rel_err(lk, lr),
            "fused_prefill": rel_err(outs["kernel"][0], outs["ref"][0]),
            "fused_decode": rel_err(outs["kernel"][1], outs["ref"][1])}


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


def path_kernels(cfg):
    """The kernels a serving run of ``cfg`` launches: the three attention
    kernels, and ssm_scan when it has Mamba layers."""
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
    generator."""
    t = time.perf_counter()
    model = tf.init_model(cfg, seed=SERVE["seed"], device=DEVICE)
    torch.cuda.synchronize()
    say("serve", phase="init", config=cfg.name, layers=cfg.num_layers,
        layer_pattern=cfg.layer_pattern, ffn_pattern=cfg.ffn_pattern,
        d_model=cfg.d_model, dtype=cfg.dtype,
        weights_gb=sum(p.numel() * p.element_size()
                       for p in model.parameters()) / 1e9,
        init_s=time.perf_counter() - t)
    return model


def serve_full(model):
    """The serving run: 8 requests after a warm-up, with the launch counts
    of the run alone; then kernel path against plain path.  Returns the
    launch counts."""
    cfg = model.cfg
    # warm-up: two short requests exercise prefill, fused and decode steps
    warm = serve_real.make_requests(cfg, 2, SERVE["seed"] + 1, (32, 64),
                                    (3, 3))
    serve_real.serve(model, warm, slots=SERVE["slots"], page=SERVE["page"],
                     f_decode=SERVE["f_decode"])
    reqs = serving_requests(cfg)
    torch.cuda.synchronize()
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=SERVE["slots"],
                              page=SERVE["page"], f_decode=SERVE["f_decode"])
    torch.cuda.synchronize()
    launches = ops.launches()
    summary = serve_real.summarize(result)
    say("serve", phase="run", config=cfg.name, launches=launches, **summary,
        prompt_lens=[len(r.prompt) for r in reqs],
        max_new=[r.max_new for r in reqs])
    require(summary["requests"] == SERVE["requests"], "not every request "
            "was served")
    require(all(len(r.tokens) == r.max_new and
                all(0 <= x < cfg.vocab_size for x in r.tokens)
                for r in result["requests"]), "bad generated tokens")
    require(result["pool_reclaimed"], "KV pool not fully reclaimed")
    require(result["state_slots_reclaimed"], "decode slots not reclaimed")
    launched = {k for k, n in launches.items() if n > 0}
    require(launched == path_kernels(cfg),
            f"{cfg.name}: launched {sorted(launched)}, its path runs "
            f"{sorted(path_kernels(cfg))}: {launches}")
    errs = first_steps_kernel_vs_plain(model, reqs, SERVE["page"])
    say("serve", phase="kernel_vs_plain_logits", config=cfg.name,
        metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS, **errs)
    require(all(e < TOL_LOGITS for e in errs.values()),
            f"logits differ between kernel and plain paths: {errs}")
    return launches


def jamba_period():
    """One full-width Jamba-1.5-Large period without experts.  Two cuts of
    the published model: depth 72 -> 8 (one whole period: 7 Mamba layers
    and the attention layer at position 4), and the MoE FFN of odd layers
    -> Jamba's dense FFN (d_ff 24576) on every layer; one full-width MoE
    layer would be 19.3 GB of bf16 experts.  9.0 B parameters, 18 GB."""
    return replace(get_config("jamba-1.5-large-398b"), num_layers=8,
                   ffn_pattern=("dense",))


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


KERNEL_FAMILIES = {"flash_kernel": "flash_prefill",
                   "paged_kernel": "paged_attention",
                   "unified_kernel": "unified_pd",
                   "ssm_kernel": "ssm_scan"}
MATMUL_MARKS = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "splitk")


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
    busy = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    sync_msgs = [str(w.message) for w in syncs
                 if "synchroniz" in str(w.message)]
    return {"requests": len(reqs), "steps": result["steps"], "wall_s": wall,
            "device_busy_s": busy,
            "busy_share": busy / wall if busy else "not measured",
            "device_s_by_family": by_family, "top_kernels_s": top,
            "host_self_s_top": host_top, "host_syncs": len(sync_msgs),
            "host_sync_kinds": sorted(set(m[:100] for m in sync_msgs))}


# ---------------------------------------------------------------------------


def main():
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
    try:
        t = time.perf_counter()
        libs = build.build_all()
        say("build", seconds=time.perf_counter() - t,
            libraries=sorted(p.name for p in libs.values()),
            ptxas=build.ptxas_report())

        gen = torch.Generator(device=DEVICE).manual_seed(0)
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

        model = init_full(cfg)
        launches = {"granite-8b": serve_full(model)}
        say("profile", config=cfg.name, **profile_serving(model, cfg))
        del model
        gc.collect()
        torch.cuda.empty_cache()

        cfg = jamba_period()
        jamba_attn = check_main_path_shapes(
            gen, main_path_shapes(cfg, serving_requests(cfg)))
        say("kernels", phase="main_path_shapes", config="jamba-period",
            **jamba_attn)
        model = init_full(cfg)
        recs["ssm_scan"] = check_scan_serving_shape(
            gen, model, serving_requests(cfg)[0].prompt)
        say("kernels", phase="ssm_scan_serving_shape",
            tolerance_row=TOL_SCAN_ROW, **recs["ssm_scan"])
        launches["jamba-period"] = serve_full(model)
        say("profile", config=cfg.name, **profile_serving(model, cfg))
        del model
        gc.collect()
        torch.cuda.empty_cache()
        # the same comparison with float32 weights (36 GB), where only the
        # order of float32 sums separates the two paths
        model = init_full(replace(cfg, dtype="float32"))
        errs = first_steps_kernel_vs_plain(model, serving_requests(cfg),
                                           SERVE["page"])
        fault = logits_fault(model, serving_requests(cfg)[0].prompt)
        say("serve", phase="kernel_vs_plain_logits_f32", config=cfg.name,
            metric="max|kernel-plain|/max|plain|", limit=TOL_LOGITS_F32,
            fault_last_update_skipped=fault, **errs)
        require(all(e < TOL_LOGITS_F32 for e in errs.values()),
                f"float32 logits differ between kernel and plain: {errs}")
        require(fault > TOL_LOGITS_F32, f"a planted scan fault moves the "
                f"float32 logits by {fault}, within {TOL_LOGITS_F32}")
    except PhaseFailed as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    # each kernel's launches are those of the first serving run whose path
    # runs it: granite-8b for attention, the Jamba period for ssm_scan
    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
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
                        "f32_test_shapes_max_abs_err": worst_f32[name]})
        if name in worst_bf16:
            kernels[-1]["bf16_test_shapes"] = worst_bf16[name]
        for k in ("splits", "bound_share", "lanes", "stages", "random_A",
                  "from_h0", "persistent"):
            if k in r:
                kernels[-1][k] = r[k]
        if name in jamba_attn:
            j = jamba_attn[name]
            kernels[-1]["at_jamba_shapes"] = {
                k: j[k] for k in ("max_abs_err", "max_row_rel_err", "ms",
                                  "plain_ms", "bound_ms", "shape", "splits",
                                  "persistent")
                if k in j}
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
