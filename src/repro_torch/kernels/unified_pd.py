"""Unified P/D attention step: wrapper of ``csrc/unified_pd.cu``.

The counterpart of ``repro/kernels/unified_pd.py``: prefill flash tiles
and decode paged tiles run in ONE launch.  The kernel is persistent: a
grid of ``min(tiles, SMs x CTAs per SM)`` CTAs (``grid_size``), each
taking tiles from two work queues until both are empty.  ``f_decode`` —
the Adaptive Resource Manager's control variable — is the share of the
SMs whose CTAs take decode tiles first (``decode_sms``; the paper's CU
masking): 1.0 puts every CTA on decode first, 0.1 holds 13 of the H100's
132 SMs for decode while the others run prefill.  A CTA whose own queue
is empty takes the other's tiles, so no SM idles while work is left (the
reference's overallocation).  The outputs do not depend on ``f_decode``.

The queues (``work_queues``) are the reference's 7-column descriptor
rows (``split_descriptors``, ``_make_descriptors``), split by kind: the
decode rows, then the prefill rows longest first (the most k-blocks
read).  They are built on the host and copied to the device once per
step shape.  The decode tiles are the split tiles of ``paged_attention``,
so the fused kernel's outputs equal the standalone kernels' bit for bit.
The queue heads and an exit count sit in the stream's counter buffer
after the split counters, and the kernel leaves them zeroed.

``unified_pd(trace=...)`` is the kernel's one measurement argument: an
int64 tensor of ``TRACE_LEN`` on the device (``new_trace``) in which the
launch records, in ns of the card's global clock, its first CTA's start,
its last decode tile's end (after the merge) and its last prefill tile's
end, then ``%nsmid`` and the set of SM ids that ran a CTA.  It is how a
measurement sees whether a held share keeps decode's finish time apart
from prefill's, which the reference's interference model assumes
(``repro/perfmodel/interference.py``) and a real-kernel executor will
rely on.  The serving path passes none.

On a CPU tensor the wrapper computes the plain version
(``ref.unified_pd``); on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_prefill import BLOCK_Q, bhs_strides, \
    check_prefill
from repro_torch.kernels.paged_attention import check_decode, split_args, \
    split_count

PREFILL, DECODE = 0, 1
BLOCK_K = 64     # keys per k-block of a prefill tile (attn_tiles.cuh BK)
CONTROL = 3      # queue heads and exit count after the split counters
# unified_pd.cu's trace: first CTA start, last decode end, last prefill
# end (ns), %nsmid, then 4 words of the set of SM ids that ran a CTA
TRACE_START, TRACE_DECODE_END, TRACE_PREFILL_END, TRACE_NSMID, \
    TRACE_SM_SET = range(5)
TRACE_LEN = TRACE_SM_SET + 4

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P] + \
    [_L] * 12 + [_I] * 4 + [_P] * 8 + [_I] * 3 + [ctypes.c_float, _P]


def build_slot_schedule(n_prefill: int, n_decode: int,
                        f_decode: float) -> np.ndarray:
    """Merged issue order: position of each decode tile i is
    floor(i / f_decode); prefill tiles fill the remaining slots."""
    n = n_prefill + n_decode
    f = min(max(f_decode, 1e-3), 1.0)
    kinds = np.zeros(n, np.int32)
    pos = np.minimum((np.arange(n_decode) / f).astype(np.int64),
                     n - np.arange(n_decode, 0, -1))
    # resolve collisions by shifting right
    used = np.zeros(n, bool)
    for p in pos:
        p = int(p)
        while used[p]:
            p += 1
        used[p] = True
        kinds[p] = DECODE
    return kinds


def _make_descriptors(Bp: int, Hq: int, nq: int, Bd: int, Hkv: int,
                      G: int, f_decode: float) -> np.ndarray:
    """(n_slots, 7) int32 rows [kind, pb, ph, pkvh, pqi, db, dkvh]."""
    prefill_tiles = [(b, h, h // G, qi) for b in range(Bp)
                     for h in range(Hq) for qi in range(nq)]
    decode_tiles = [(db, dh) for db in range(Bd) for dh in range(Hkv)]
    kinds = build_slot_schedule(len(prefill_tiles), len(decode_tiles),
                                f_decode)
    desc = np.zeros((len(kinds), 7), np.int32)
    ip = id_ = 0
    for s, kind in enumerate(kinds):
        if kind == PREFILL:
            b, h, kvh, qi = prefill_tiles[ip]
            desc[s] = (PREFILL, b, h, kvh, qi, 0, 0)
            ip += 1
        else:
            db, dh = decode_tiles[id_]
            desc[s] = (DECODE, 0, 0, 0, 0, db, dh)
            id_ += 1
    return desc


def split_descriptors(Bp: int, Hq: int, nq: int, Bd: int, Hkv: int,
                      G: int, splits: int, f_decode: float) -> np.ndarray:
    """The descriptor rows of a step whose decode tiles are split: the
    reference's schedule over Bd x (Hkv * splits) decode tiles, whose
    ``dkvh`` column the kernel reads as kvh * splits + split."""
    return _make_descriptors(Bp, Hq, nq, Bd, Hkv * splits, G, f_decode)


def prefill_kblocks(qi: int, S: int, window: int) -> int:
    """The k-blocks prefill tile ``qi`` of an S-token sequence reads: up
    to its causal bound, from its window's start (``window`` <= 0: none),
    as both prefill tiles of attn_tiles.cuh walk them."""
    q0 = qi * BLOCK_Q
    kb0 = (q0 - window + 1) // BLOCK_K if 0 < window < q0 + 1 else 0
    return -(-min(S, q0 + BLOCK_Q) // BLOCK_K) - kb0


def work_queues(Bp: int, Hq: int, S: int, Bd: int, Hkv: int, G: int,
                splits: int, window: int):
    """The kernel's two work queues as one (n, 7) int32 table of the
    reference's descriptor rows (``split_descriptors``): the decode rows,
    in the reference's order, then the prefill rows longest first (by
    ``prefill_kblocks``, ties in the reference's order).  Returns the
    table and its number of decode rows."""
    desc = split_descriptors(Bp, Hq, -(-S // BLOCK_Q), Bd, Hkv, G, splits,
                             1.0)
    dec, pre = desc[desc[:, 0] == DECODE], desc[desc[:, 0] == PREFILL]
    work = np.array([prefill_kblocks(qi, S, window) for qi in pre[:, 4]])
    pre = pre[np.argsort(-work, kind="stable")]
    return np.concatenate([dec, pre]), len(dec)


def decode_sms(f_decode: float, n_sms: int) -> int:
    """The SMs whose CTAs take decode tiles first: ``f_decode`` of
    ``n_sms``, clamped to [1e-3, 1] as ``build_slot_schedule`` clamps it,
    rounded, and at least one."""
    f = min(max(f_decode, 1e-3), 1.0)
    return min(max(int(f * n_sms + 0.5), 1), n_sms)


def grid_size(n_tiles: int, ctas_per_sm: int, n_sms: int) -> int:
    """The persistent grid: every CTA resident at once, and no more CTAs
    than tiles."""
    return max(1, min(n_tiles, ctas_per_sm * n_sms))


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=None)
def ctas_per_sm(code: int, D: int, G: int, splits: int) -> int:
    """CTAs of the kernel instance (dtype code, D) that fit on one SM at
    the shared memory that G and ``splits`` give it (the occupancy
    calculator, asked once per instance and shape)."""
    fn = build.library("unified_pd").unified_pd_ctas_per_sm
    fn.argtypes = [_I] * 4 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = ctypes.c_int(0)
    build.check("unified_pd", fn(code, D, G, splits, ctypes.byref(out)))
    if out.value < 1:
        raise RuntimeError(f"unified_pd: no CTA fits an SM (D={D}, G={G}, "
                           f"splits={splits})")
    return out.value


def new_trace(device) -> torch.Tensor:
    """A zeroed trace for ``unified_pd(trace=)``, its start at the most an
    int64 holds (the kernel takes the minimum over its CTAs)."""
    trace = torch.zeros(TRACE_LEN, dtype=torch.int64, device=device)
    trace[TRACE_START] = torch.iinfo(torch.int64).max
    return trace


@functools.lru_cache(maxsize=256)
def _device_queues(key, device):
    # Read-only on the device; every layer of a step, and every step of
    # the same shape, reuses one copy instead of a host-to-device copy.
    rows, n_decode = work_queues(*key)
    return torch.from_numpy(rows).to(device), n_decode


def unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
               seq_lens, *, f_decode: float = 0.5,
               window: Optional[int] = None,
               trace: Optional[torch.Tensor] = None):
    """One fused P/D attention step.

    q_p (Bp,Hq,Sp,D), k_p/v_p (Bp,Hkv,Sp,D)        — prefill batch
    q_d (Bd,Hq,D), k/v_pages (N,page,Hkv,D),
    block_tables (Bd,max_pages), seq_lens (Bd,)     — decode batch
    ``trace``: None, or ``new_trace``'s tensor for the launch to record
    its times into (the module docstring).
    Returns (o_p (Bp,Hq,Sp,D), o_d (Bd,Hq,D)).
    """
    if q_p.device.type == "cpu":
        return ref.unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages,
                              block_tables, seq_lens, window=window)
    q_d = q_d.contiguous()
    build.check_cuda(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
                     seq_lens)
    check_prefill(q_p, k_p, v_p)
    check_decode(q_d, k_pages, v_pages, block_tables, seq_lens)
    code = build.dtype_code(q_p, k_p, v_p, q_d, k_pages, v_pages)
    Bp, Hq, Sp, D = q_p.shape
    Hkv = k_p.shape[1]
    Bd = q_d.shape[0]
    if q_d.shape[1:] != (Hq, D) or k_pages.shape[2] != Hkv:
        raise ValueError("prefill and decode operands disagree on heads")
    if Bp * Sp == 0 or Bd == 0:
        raise ValueError("unified_pd needs a prefill and a decode batch")
    if trace is not None and (trace.dtype != torch.int64 or
                              trace.shape != (TRACE_LEN,) or
                              trace.device != q_p.device):
        raise ValueError(f"trace must be int64 ({TRACE_LEN},) on "
                         f"{q_p.device}")
    page, max_pages = k_pages.shape[1], block_tables.shape[1]
    G, splits = Hq // Hkv, split_count(max_pages, page)
    rows, n_decode = _device_queues((Bp, Hq, Sp, Bd, Hkv, G, splits,
                                     window or 0), q_p.device)
    n_sms = sm_count(q_p.device)
    grid = grid_size(rows.shape[0], ctas_per_sm(code, D, G, splits), n_sms)
    o_p = torch.empty_like(q_p)
    o_d = torch.empty_like(q_d)
    stream = torch.cuda.current_stream(q_p.device).cuda_stream
    part, count, splits = split_args(q_d, k_pages, block_tables, stream,
                                     CONTROL)
    fn = build.entry("unified_pd", _ARGTYPES)
    err = fn(code, D, rows.data_ptr(), n_decode, rows.shape[0] - n_decode,
             grid, decode_sms(f_decode, n_sms),
             count.data_ptr() + 4 * Bd * Hkv,
             None if trace is None else trace.data_ptr(), q_p.data_ptr(),
             k_p.data_ptr(), v_p.data_ptr(), o_p.data_ptr(),
             *bhs_strides(q_p), *bhs_strides(k_p), *bhs_strides(v_p),
             *bhs_strides(o_p), Sp, Hq, Hkv, window or 0, q_d.data_ptr(),
             k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
             seq_lens.data_ptr(), o_d.data_ptr(), part.data_ptr(),
             count.data_ptr(), page, max_pages, splits, 1.0 / D ** 0.5,
             stream)
    build.check("unified_pd", err)
    unified_pd.launches += 1
    return o_p, o_d


unified_pd.launches = 0
