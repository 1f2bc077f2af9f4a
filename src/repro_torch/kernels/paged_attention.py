"""Paged decode attention: wrapper of ``csrc/paged_attention.cu``.

The counterpart of ``repro/kernels/paged_attention.py``.  On a CPU tensor
the wrapper computes the plain version (``ref.paged_attention``); on a
CUDA tensor it launches the kernel or raises.  The kernel reads only the
first ``seq_lens[b]`` keys of sequence b through its block-table row, so
padded table entries must be valid block ids (0) but are never read.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I, _I] + [_P] * 6 + [_I] * 5 + [ctypes.c_float, _P]


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
    fn = build.entry("paged_attention", _ARGTYPES)
    err = fn(code, D, q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), seq_lens.data_ptr(), o.data_ptr(),
             B, Hq, Hkv, page, block_tables.shape[1], 1.0 / D ** 0.5,
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("paged_attention", err)
    paged_attention.launches += 1
    return o


paged_attention.launches = 0
