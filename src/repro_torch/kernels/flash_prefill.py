"""Causal GQA flash attention (prefill): wrapper of ``csrc/flash_prefill.cu``.

The counterpart of ``repro/kernels/flash_prefill.py``.  On a CPU tensor
the wrapper computes the plain version (``ref.causal_attention``); on a
CUDA tensor it launches the kernel or raises.  Any strides are taken as
long as the head dim is dense, so the model's (B,S,H,D) activations pass
as transposed views without a copy, and the ragged edge is masked inside
the kernel, so nothing is padded.
"""
from __future__ import annotations

import ctypes
from typing import Optional

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
