"""Mamba S6 selective scan: wrapper of ``csrc/ssm_scan.cu``.

The counterpart of ``repro/kernels/ssm_scan.py``.  On a CPU tensor the
wrapper computes the plain version (``ref.ssm_scan``); on a CUDA tensor
it launches the kernel or raises.  Like the Pallas kernel, the scan
starts from a zero state.  The kernel takes dense float32 operands, so
strided views (``Bm``/``Cm`` sliced out of one projection) are copied
dense first; it reads them with 4-byte loads, so no wider alignment is
needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

D_STATES = (4, 8, 16)     # the kernel's DS instances

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] + [_P] * 7 + [_I] * 3 + [_P]


def check_scan(xs, dt, A, Bm, Cm) -> None:
    """Shapes and types the kernel takes: xs/dt (B,L,din), A (din,ds),
    Bm/Cm (B,L,ds), all float32, ds in ``D_STATES``."""
    B, L, din = xs.shape
    ds = A.shape[1]
    for name, t, shape in (("dt", dt, (B, L, din)), ("A", A, (din, ds)),
                           ("Bm", Bm, (B, L, ds)), ("Cm", Cm, (B, L, ds))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape} for xs "
                             f"{tuple(xs.shape)}")
    if ds not in D_STATES:
        raise ValueError(f"d_state {ds} not in {D_STATES}")
    if any(t.dtype != torch.float32 for t in (xs, dt, A, Bm, Cm)):
        raise TypeError("ssm_scan takes float32 operands")


def ssm_scan(xs, dt, A, Bm, Cm):
    """xs/dt (B,L,din) f32; A (din,ds) f32; Bm/Cm (B,L,ds) f32.
    Returns y (B,L,din) f32 and the final state h (B,din,ds) f32."""
    if xs.device.type == "cpu":
        return ref.ssm_scan(xs, dt, A, Bm, Cm)
    xs, dt, A, Bm, Cm = (t.contiguous() for t in (xs, dt, A, Bm, Cm))
    build.check_cuda(xs, dt, A, Bm, Cm)
    check_scan(xs, dt, A, Bm, Cm)
    B, L, din = xs.shape
    ds = A.shape[1]
    y = torch.empty_like(xs)
    h = torch.zeros(B, din, ds, device=xs.device, dtype=torch.float32)
    if B == 0 or L == 0 or din == 0:
        return y, h
    fn = build.entry("ssm_scan", _ARGTYPES)
    err = fn(ds, xs.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
             Cm.data_ptr(), y.data_ptr(), h.data_ptr(), B, L, din,
             torch.cuda.current_stream(xs.device).cuda_stream)
    build.check("ssm_scan", err)
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0
