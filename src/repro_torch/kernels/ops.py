"""Model-facing layout wrappers around the kernels, and their launch
counts.

The models pass (B, S, H, D)-layout tensors; the attention kernels take
(B, H, S, D).  The transposes here are views: the kernels read strides,
so no copy is made on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssm_scan as _ssm
from repro_torch.kernels import unified_pd as _updk


def flash_prefill(q, k, v, *, window: Optional[int] = None):
    """q (B,S,Hq,D), k/v (B,S,Hkv,D) -> (B,S,Hq,D)."""
    o = _fp.flash_prefill(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), window=window)
    return o.transpose(1, 2)


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """q (B,Hq,D) over paged cache -> (B,Hq,D)."""
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens)


def paged_attention_dense(q, cache_k, cache_v, seq_lens, *,
                          window: Optional[int] = None, page: int = 64):
    """Decode attention over a *dense slot* cache via the paged kernel.

    q (B,Hq,D); cache_k/v (B,Sc,Hkv,D); seq_lens (B,) valid tokens
    (for ring-buffer windows pass min(len, window) — all slots valid).
    The dense cache is viewed as trivially-paged: sequence b owns pages
    [b*np, (b+1)*np), identity block table.
    """
    B, Sc, Hkv, D = cache_k.shape
    page = min(page, Sc)
    while Sc % page:
        page -= 1
    n_pages = Sc // page
    kp = cache_k.reshape(B * n_pages, page, Hkv, D)
    vp = cache_v.reshape(B * n_pages, page, Hkv, D)
    tables = (torch.arange(B, device=q.device)[:, None] * n_pages +
              torch.arange(n_pages, device=q.device)[None, :]).int()
    lens = seq_lens.to(device=q.device, dtype=torch.int32)
    if window is not None:
        lens = torch.clamp(lens, max=window)
    return _pa.paged_attention(q, kp, vp, tables, lens)


def unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
               seq_lens, *, f_decode: float = 0.5,
               window: Optional[int] = None):
    """Fused concurrent P/D attention step (layouts as models produce):
    q_p/k_p/v_p (Bp,S,H,D); q_d (Bd,Hq,D).  Returns
    (o_p (Bp,S,Hq,D), o_d (Bd,Hq,D))."""
    o_p, o_d = _updk.unified_pd(
        q_p.transpose(1, 2), k_p.transpose(1, 2), v_p.transpose(1, 2), q_d,
        k_pages, v_pages, block_tables, seq_lens, f_decode=f_decode,
        window=window)
    return o_p.transpose(1, 2), o_d


def ssm_scan(xs, dt, A, Bm, Cm, *, h0=None):
    """Selective scan from h0 (B,din,ds) f32, or from a zero state:
    xs/dt (B,L,din) f32, A (din,ds), Bm/Cm (B,L,ds) f32 -> y (B,L,din)
    f32, h_last (B,din,ds) f32."""
    return _ssm.ssm_scan(xs, dt, A, Bm, Cm, h0)


LAUNCH_COUNTED = {"flash_prefill": _fp.flash_prefill,
                  "paged_attention": _pa.paged_attention,
                  "unified_pd": _updk.unified_pd,
                  "ssm_scan": _ssm.ssm_scan}


def reset_launches() -> None:
    for fn in LAUNCH_COUNTED.values():
        fn.launches = 0


def launches() -> dict:
    return {name: fn.launches for name, fn in LAUNCH_COUNTED.items()}
