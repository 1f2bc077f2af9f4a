"""Unified P/D attention step: wrapper of ``csrc/unified_pd.cu``.

The counterpart of ``repro/kernels/unified_pd.py``: prefill flash tiles
and decode paged tiles issue from ONE launch, in the slot order of
``build_slot_schedule(f_decode)``.  ``f_decode`` — the Adaptive Resource
Manager's control variable — sets how densely decode tiles are packed at
the head of the schedule (1.0: all decode tiles first; 0.25: one decode
tile every 4 slots).  The outputs do not depend on it.

The descriptor table is built on the host (``_make_descriptors``, the
same 7-column rows as the reference) and copied to the device once per
distinct step shape.  Its decode tiles are the split tiles of
``paged_attention`` (``split_descriptors``), so the fused kernel's decode
output equals the standalone kernel's bit for bit.  On a CPU tensor the
wrapper computes the plain version (``ref.unified_pd``); on a CUDA tensor
it launches the kernel or raises.
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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _I, _P, _P, _P, _P] + [_L] * 12 + [_I] * 4 + \
    [_P] * 8 + [_I] * 3 + [ctypes.c_float, _P]


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


@functools.lru_cache(maxsize=256)
def _device_descriptors(key, device) -> torch.Tensor:
    # Read-only on the device; every layer of a step, and every step of
    # the same shape, reuses one copy instead of a host-to-device copy.
    return torch.from_numpy(split_descriptors(*key)).to(device)


def unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
               seq_lens, *, f_decode: float = 0.5,
               window: Optional[int] = None):
    """One fused P/D attention step.

    q_p (Bp,Hq,Sp,D), k_p/v_p (Bp,Hkv,Sp,D)        — prefill batch
    q_d (Bd,Hq,D), k/v_pages (N,page,Hkv,D),
    block_tables (Bd,max_pages), seq_lens (Bd,)     — decode batch
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
    nq = -(-Sp // BLOCK_Q)
    page, max_pages = k_pages.shape[1], block_tables.shape[1]
    desc = _device_descriptors((Bp, Hq, nq, Bd, Hkv, Hq // Hkv,
                                split_count(max_pages, page),
                                float(f_decode)), q_p.device)
    o_p = torch.empty_like(q_p)
    o_d = torch.empty_like(q_d)
    stream = torch.cuda.current_stream(q_p.device).cuda_stream
    part, count, splits = split_args(q_d, k_pages, block_tables, stream)
    fn = build.entry("unified_pd", _ARGTYPES)
    err = fn(code, D, desc.data_ptr(), desc.shape[0], q_p.data_ptr(),
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
