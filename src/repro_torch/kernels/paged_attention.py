"""Paged decode attention: wrapper of ``csrc/paged_attention.cu``.

The counterpart of ``repro/kernels/paged_attention.py``.  On a CPU tensor
the wrapper computes the plain version (``ref.paged_attention``); on a
CUDA tensor it launches the kernel or raises.  The kernel reads only the
first ``seq_lens[b]`` keys of sequence b through its block-table row, so
padded table entries must be valid block ids (0) but are never read.

The kernel splits each sequence's keys over ``split_count`` CTAs of
``SPLIT_KEYS`` keys each; the count comes from the block table's width
and the page size, shapes the host holds, so no launch waits on
``seq_lens``.  The wrapper allocates the float32 workspace of the
splits' partials per call and keeps one zeroed counter buffer per device
and stream, which the kernel leaves zeroed: launches on one stream run in
order and share it, launches on two streams never do.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build, ref

SPLIT_KEYS = 256   # keys of one decode CTA (attn_tiles.cuh SPLIT)
MAX_G = 8          # query heads per kv head a decode CTA holds (MAX_G)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I] + [_P] * 8 + [_I] * 6 + [ctypes.c_float, _P]
_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def split_count(max_pages: int, page: int) -> int:
    """Decode CTAs per (sequence, kv head): the table's key capacity in
    SPLIT_KEYS pieces (at least 1)."""
    return max(1, -(-max_pages * page // SPLIT_KEYS))


def counters(device, n: int, stream: int) -> torch.Tensor:
    """The zeroed int32 arrival counters of ``stream`` (a raw CUDA stream
    handle; 0 is the default stream) on ``device``, at least ``n`` of them.
    Kernels on one stream share them, one after the other: each launch
    leaves them at 0.  A larger buffer replaces a stream's own, allocated
    on that stream, so its launches still run in order behind it."""
    key = (torch.device(device), stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def split_args(q, k_pages, block_tables, stream: int, control: int = 0):
    """The split decode tiles' launch arguments for q (B,Hq,D) over
    k_pages (N,page,Hkv,D), launched on ``stream``: the partials' float32
    workspace, the stream's counters (B*Hkv, then ``control`` more for
    the kernel's own use) and the split count.  The caller holds the
    workspace until the launch is queued."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    splits = split_count(block_tables.shape[1], page)
    part = torch.empty(B * Hkv * splits * (Hq // Hkv) * (D + 2),
                       dtype=torch.float32, device=q.device)
    return part, counters(q.device, B * Hkv + control, stream), splits


def check_decode(q, k_pages, v_pages, block_tables, seq_lens) -> None:
    """Shapes and types the kernel takes: q (B,Hq,D) dense, pages
    (N,page,Hkv,D) dense, int32 tables (B,max_pages) and lens (B,)."""
    B, Hq, D = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != D:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % k_pages.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of "
                         f"Hkv={k_pages.shape[2]}")
    if Hq // k_pages.shape[2] > MAX_G:
        raise ValueError(f"G = {Hq // k_pages.shape[2]} query heads per kv "
                         f"head exceed {MAX_G}")
    if D not in build.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {build.HEAD_DIMS}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("KV pages must be contiguous")
    build.check_rows_aligned(k_pages, v_pages)
    for name, t, shape in (("block_tables", block_tables, (B,)),
                           ("seq_lens", seq_lens, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape[:1]) != shape or \
                not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 with "
                             f"leading dim {B}")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q (B,Hq,D); k/v_pages (N,page,Hkv,D); block_tables (B,max_pages)
    int32; seq_lens (B,) int32.  Returns (B,Hq,D)."""
    if q.device.type == "cpu":
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens)
    q = q.contiguous()
    build.check_cuda(q, k_pages, v_pages, block_tables, seq_lens)
    check_decode(q, k_pages, v_pages, block_tables, seq_lens)
    code = build.dtype_code(q, k_pages, v_pages)
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    o = torch.empty_like(q)
    if B == 0:
        return o
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part, count, splits = split_args(q, k_pages, block_tables, stream)
    fn = build.entry("paged_attention", _ARGTYPES)
    err = fn(code, D, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
             part.data_ptr(), count.data_ptr(), B, Hq, Hkv, page,
             block_tables.shape[1], splits, 1.0 / D ** 0.5, stream)
    build.check("paged_attention", err)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
