"""Mamba S6 selective scan: wrapper of ``csrc/ssm_scan.cu``.

The counterpart of ``repro/kernels/ssm_scan.py``.  On a CPU tensor the
wrapper computes the plain version (``ref.ssm_scan``); on a CUDA tensor
it launches the kernel or raises.  The scan starts from ``h0`` when it is
given and from a zero state otherwise (the reference's kernel starts from
zero only; its ``ops.ssm_scan(h0=)`` falls back to the plain scan).  The
kernel takes dense float32 operands, so strided views (``Bm``/``Cm``
sliced out of one projection) are copied dense first, and B and C rows
copied again where they do not start 16-byte aligned.

The kernel splits each channel's ``ds`` states over ``LANES[ds]`` lanes
and stages its inputs through a ring of ``STAGES`` shared-memory stages;
the source compiles one instance a d_state and refuses a launch whose
lanes and stages are not these.
"""
from __future__ import annotations

import ctypes
import torch

from repro_torch.kernels import build, ref

D_STATES = (4, 8, 16)     # the d_state values the kernel takes
LANES = {4: 1, 8: 2, 16: 2}   # lanes a channel, by d_state
STAGES = 4                # chunk stages of the shared-memory ring

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_I] * 3 + [_P] * 8 + [_I] * 3 + [_P]


def check_scan(xs, dt, A, Bm, Cm, h0=None) -> None:
    """Shapes and types the kernel takes: xs/dt (B,L,din), A (din,ds),
    Bm/Cm (B,L,ds), h0 (B,din,ds) when given, all float32, ds in
    ``D_STATES``."""
    B, L, din = xs.shape
    ds = A.shape[1]
    named = [("dt", dt, (B, L, din)), ("A", A, (din, ds)),
             ("Bm", Bm, (B, L, ds)), ("Cm", Cm, (B, L, ds))]
    if h0 is not None:
        named.append(("h0", h0, (B, din, ds)))
    for name, t, shape in named:
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} {tuple(t.shape)} != {shape} for xs "
                             f"{tuple(xs.shape)}")
    if ds not in D_STATES:
        raise ValueError(f"d_state {ds} not in {D_STATES}")
    if any(t.dtype != torch.float32 for t in [xs] + [t for _, t, _ in named]):
        raise TypeError("ssm_scan takes float32 operands")


def _dense(t):
    """t contiguous, its data 16-byte aligned."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssm_scan(xs, dt, A, Bm, Cm, h0=None):
    """xs/dt (B,L,din) f32; A (din,ds) f32; Bm/Cm (B,L,ds) f32; h0
    (B,din,ds) f32 or None for a zero state.  Returns y (B,L,din) f32 and
    the final state h (B,din,ds) f32."""
    build.check_no_grad("ssm_scan", xs, dt, A, Bm, Cm, h0)
    if xs.device.type == "cpu":
        return ref.ssm_scan(xs, dt, A, Bm, Cm, h0=h0)
    xs, dt, A, Bm, Cm = (_dense(t) for t in (xs, dt, A, Bm, Cm))
    h0 = None if h0 is None else _dense(h0)
    build.check_cuda(xs, dt, A, Bm, Cm, *([] if h0 is None else [h0]))
    check_scan(xs, dt, A, Bm, Cm, h0)
    B, L, din = xs.shape
    ds = A.shape[1]
    y = torch.empty_like(xs)
    if B == 0 or L == 0 or din == 0:
        h = torch.zeros(B, din, ds, device=xs.device, dtype=torch.float32)
        return y, h if h0 is None else h0.clone()
    h = torch.empty(B, din, ds, device=xs.device, dtype=torch.float32)
    fn = build.entry("ssm_scan", _ARGTYPES)
    err = fn(ds, LANES[ds], STAGES, xs.data_ptr(), dt.data_ptr(),
             A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
             None if h0 is None else h0.data_ptr(), y.data_ptr(),
             h.data_ptr(), B, L, din,
             torch.cuda.current_stream(xs.device).cuda_stream)
    build.check("ssm_scan", err)
    ssm_scan.launches += 1
    return y, h


ssm_scan.launches = 0
