"""Causal GQA flash attention (prefill): wrapper of ``csrc/flash_prefill.cu``.

The counterpart of ``repro/kernels/flash_prefill.py``.  On a CPU tensor
the wrapper computes the plain version (``ref.causal_attention``); on a
CUDA tensor it launches the kernel or raises.  Any strides are taken as
long as the head dim is dense, so the model's (B,S,H,D) activations pass
as transposed views without a copy, and the ragged edge is masked inside
the kernel, so nothing is padded.

``flash_prefill_paged`` is the kernel's paged, offset form, which a
hybrid (chunked-prefill) step runs: prompt chunks of several requests
packed along one row dimension, each at its own offset over its
request's paged KV (plain version ``ref.paged_prefill``).  Where the
chunks lie is a ``Chunks``, whose host copy the wrapper checks and whose
device copy the kernel reads.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import build, ref

BLOCK_Q = 64    # query rows per CTA (attn_tiles.cuh BQ)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = [_I, _I, _P, _P, _P, _P] + [_L] * 12 + [_I] * 5 + \
    [ctypes.c_float, _P]


def check_prefill(q, k, v) -> None:
    """Shapes and dtypes the kernel takes: (B,Hq,S,D) with Hkv | Hq."""
    B, Hq, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % k.shape[1]:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={k.shape[1]}")
    if D not in build.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {build.HEAD_DIMS}")
    build.check_rows_aligned(q, k, v)


def bhs_strides(t):
    """Element strides of the batch, head and sequence dims."""
    return t.stride(0), t.stride(1), t.stride(2)


def flash_prefill(q, k, v, *, window: Optional[int] = None):
    """q (B,Hq,S,D), k/v (B,Hkv,S,D) -> (B,Hq,S,D) in q's dtype."""
    build.check_no_grad("flash_prefill", q, k, v)
    if q.device.type == "cpu":
        return ref.causal_attention(q, k, v, window=window)
    build.check_cuda(q, k, v)
    check_prefill(q, k, v)
    code = build.dtype_code(q, k, v)
    B, Hq, S, D = q.shape
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    fn = build.entry("flash_prefill", _ARGTYPES)
    err = fn(code, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             *bhs_strides(q), *bhs_strides(k), *bhs_strides(v),
             *bhs_strides(o), B, Hq, k.shape[1], S, window or 0,
             1.0 / D ** 0.5, torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_prefill", err)
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0


_PAGED_ARGTYPES = [_I, _I] + [_P] * 6 + [_L] * 4 + [_I] * 6 + \
    [ctypes.c_float, _P]


class Chunks:
    """Where the chunks of a packed prefill batch lie: per chunk its first
    row in the packed queries (``starts``), its rows (``lens``) and the
    absolute position of its first row (``offsets``), as host tuples, and
    the pages of its own block table (``pages``; None where every table
    is unpadded); ``meta(device)`` is the (3, C) int32 copy the kernel
    reads, made once per device."""

    def __init__(self, lens: Sequence[int], offsets: Sequence[int],
                 pages: Optional[Sequence[int]] = None):
        self.lens = tuple(int(n) for n in lens)
        self.offsets = tuple(int(o) for o in offsets)
        self.pages = None if pages is None else tuple(int(m) for m in pages)
        if len(self.lens) != len(self.offsets) or \
                len(self.pages or self.lens) != len(self.lens):
            raise ValueError(f"{len(self.lens)} lengths for "
                             f"{len(self.offsets)} offsets and "
                             f"{len(self.pages or self.lens)} tables")
        if any(n < 0 for n in self.lens) or any(o < 0 for o in self.offsets):
            raise ValueError(f"negative chunk lengths or offsets: "
                             f"{self.lens}, {self.offsets}")
        starts, at = [], 0
        for n in self.lens:
            starts.append(at)
            at += n
        self.starts = tuple(starts)
        self.rows = at
        self._meta: Dict[torch.device, torch.Tensor] = {}

    def __len__(self) -> int:
        return len(self.lens)

    def meta(self, device) -> torch.Tensor:
        device = torch.device(device)
        if device not in self._meta:
            self._meta[device] = torch.tensor(
                [self.starts, self.lens, self.offsets], dtype=torch.int32,
                device=device)
        return self._meta[device]


def check_paged_prefill(q, k_pages, v_pages, block_tables,
                        chunks: Chunks) -> None:
    """Shapes and types the paged form takes: q (T,Hq,D) whose rows are
    the chunks' (T = the chunks' rows), pages (N,page,Hkv,D) dense with
    Hkv | Hq, int32 tables (C,max_pages) contiguous, and every chunk's
    keys (offset + len) within its own table's pages (``chunks.pages``,
    not the padded width: padding reads another request's block)."""
    T, Hq, D = q.shape
    if k_pages.shape != v_pages.shape or k_pages.shape[3] != D:
        raise ValueError(f"pages {tuple(k_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hq % k_pages.shape[2]:
        raise ValueError(f"Hq={Hq} is not a multiple of "
                         f"Hkv={k_pages.shape[2]}")
    if D not in build.HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {build.HEAD_DIMS}")
    if not (k_pages.is_contiguous() and v_pages.is_contiguous()):
        raise ValueError("KV pages must be contiguous")
    build.check_rows_aligned(q, k_pages, v_pages)
    if chunks.rows != T:
        raise ValueError(f"the chunks hold {chunks.rows} rows, q {T}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 or \
            block_tables.shape[0] != len(chunks) or \
            not block_tables.is_contiguous():
        raise ValueError(f"block_tables must be contiguous int32 "
                         f"({len(chunks)}, max_pages), got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    width = block_tables.shape[1]
    pages = chunks.pages or (width,) * len(chunks)
    if any(m > width for m in pages):
        raise ValueError(f"tables of {pages} pages in a block table "
                         f"{width} wide")
    keys = [m * k_pages.shape[1] for m in pages]
    over = [c for c, (n, o) in enumerate(zip(chunks.lens, chunks.offsets))
            if o + n > keys[c]]
    if over:
        raise ValueError(f"chunks {over} reach past their tables' keys "
                         f"{keys} (offsets {chunks.offsets}, lengths "
                         f"{chunks.lens})")


def flash_prefill_paged(q, k_pages, v_pages, block_tables, chunks: Chunks):
    """q (T,Hq,D) the chunks' queries packed; k/v_pages (N,page,Hkv,D),
    holding each chunk's keys 0 .. offset + len - 1 (its own written
    first) through its row of block_tables (C,max_pages) int32.  Returns
    o (T,Hq,D) in q's dtype."""
    build.check_no_grad("flash_prefill_paged", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return ref.paged_prefill(q, k_pages, v_pages, block_tables,
                                 chunks.starts, chunks.lens, chunks.offsets)
    build.check_cuda(q, k_pages, v_pages, block_tables)
    check_paged_prefill(q, k_pages, v_pages, block_tables, chunks)
    code = build.dtype_code(q, k_pages, v_pages)
    T, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    q_blocks = max((-(-n // BLOCK_Q) for n in chunks.lens), default=0)
    if T == 0 or q_blocks == 0:
        return o
    fn = build.entry("flash_prefill", _PAGED_ARGTYPES,
                     symbol="flash_prefill_paged_launch")
    err = fn(code, D, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             o.data_ptr(), block_tables.data_ptr(),
             chunks.meta(q.device).data_ptr(), q.stride(0), q.stride(1),
             o.stride(0), o.stride(1), len(chunks), q_blocks, Hq, Hkv, page,
             block_tables.shape[1], 1.0 / D ** 0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_prefill", err)
    flash_prefill_paged.launches += 1
    return o


flash_prefill_paged.launches = 0
