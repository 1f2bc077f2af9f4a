"""Plain PyTorch versions of every kernel.

No tiling, no online softmax and no staging: the simplest correct math,
in float32 throughout and cast to the input's dtype at the end, as the
kernels do.  The CPU tests hold them against the reference's kernels and
oracles, and ``chip_smoke.py`` holds the CUDA kernels against them on the
card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# Query rows per chunk of the plain attention, as the reference's
# ``chunked_causal_attention`` works through query chunks: the float32
# scores take (B, Hq, CHUNK_Q, Sk) at a time, where the whole
# (32, 6000, 6000) of Mixtral's 6000-token prefill would be 4.6 GB.
CHUNK_Q = 512


def causal_attention(q, k, v, *, window: Optional[int] = None,
                     q_offset: int = 0):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) -> (B,Hq,Sq,D).  GQA by repeat.

    Query i sits at absolute position q_offset + i and attends to keys at
    positions <= its own, and within `window` when set: ``q_offset`` > 0
    is a chunk of a prompt whose first q_offset positions are already
    cached (k and v hold them first).  The queries go through in chunks
    of ``CHUNK_Q`` rows.
    """
    B, Hq, Sq, D = q.shape
    G = Hq // k.shape[1]
    k = k.float().repeat_interleave(G, dim=1)
    v = v.float().repeat_interleave(G, dim=1)
    kpos = torch.arange(k.shape[2], device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, Sq, CHUNK_Q):
        qc = q[:, :, i0:i0 + CHUNK_Q].float()
        scores = torch.einsum("bhqd,bhkd->bhqk", qc, k) / (D ** 0.5)
        qpos = torch.arange(q_offset + i0, q_offset + i0 + qc.shape[2],
                            device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        probs = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
        out[:, :, i0:i0 + CHUNK_Q] = torch.einsum(
            "bhqk,bhkd->bhqd", probs, v).to(q.dtype)
    return out


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens):
    """Decode attention over a paged KV cache.

    q (B,Hq,D); k/v_pages (N, page, Hkv, D); block_tables (B, max_pages)
    int32; seq_lens (B,) = valid tokens per sequence (including the
    current token, already written to its slot).  Returns (B,Hq,D).
    """
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    max_pages = block_tables.shape[1]
    tabs = block_tables.long()
    kk = k_pages[tabs].reshape(B, max_pages * page, Hkv, D).float()
    vv = v_pages[tabs].reshape(B, max_pages * page, Hkv, D).float()
    qg = q.reshape(B, Hkv, G, D).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", qg, kk) / (D ** 0.5)
    valid = (torch.arange(max_pages * page, device=q.device)[None, :]
             < seq_lens.to(q.device)[:, None])
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, vv)
    return out.reshape(B, Hq, D).to(q.dtype)


def paged_prefill(q, k_pages, v_pages, block_tables, starts, lens, offsets,
                  *, window: Optional[int] = None):
    """Prefill attention of chunks packed along q's first dim, each chunk
    over its request's paged KV at its offset.

    q (T,Hq,D): chunk c's queries are rows starts[c] .. starts[c] +
    lens[c] - 1, at absolute positions offsets[c] .. offsets[c] + lens[c]
    - 1.  k/v_pages (N, page, Hkv, D) hold each chunk's keys at positions
    0 .. offsets[c] + lens[c] - 1 (the chunk's own written first), read
    through row c of block_tables (C, max_pages) int32.  starts, lens and
    offsets are host sequences of ints.  Gathers each chunk's pages, then
    ``causal_attention`` at the chunk's offset.  Returns (T,Hq,D)."""
    page = k_pages.shape[1]
    out = torch.zeros_like(q)
    for c, (s, n, off) in enumerate(zip(starts, lens, offsets)):
        if n == 0:
            continue
        keys = off + n
        tab = block_tables[c, :-(-keys // page)].long()
        kk = k_pages[tab].flatten(0, 1)[:keys]          # (keys, Hkv, D)
        vv = v_pages[tab].flatten(0, 1)[:keys]
        out[s:s + n] = causal_attention(
            q[None, s:s + n].transpose(1, 2), kk[None].transpose(1, 2),
            vv[None].transpose(1, 2), window=window,
            q_offset=off)[0].transpose(0, 1)
    return out


def unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
               seq_lens, *, window: Optional[int] = None):
    """The unified P/D step: prefill flash output + decode paged output,
    computed independently (they share no data)."""
    o_p = causal_attention(q_p, k_p, v_p, window=window)
    o_d = paged_attention(q_d, k_pages, v_pages, block_tables, seq_lens)
    return o_p, o_d


def ssm_scan(xs, dt, A, Bm, Cm, h0=None):
    """Sequential (token-by-token) selective scan from h0, or from a zero
    state when h0 is None:
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t, y_t = h_t . C_t.

    xs/dt (B,L,din) f32; A (din,ds) f32; Bm/Cm (B,L,ds) f32; h0
    (B,din,ds).  Returns y (B,L,din) f32, h_last (B,din,ds) f32.
    """
    B, L, din = xs.shape
    h = torch.zeros(B, din, A.shape[1], device=xs.device,
                    dtype=torch.float32) if h0 is None else h0.float()
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t, :, None] * A)
        b = (dt[:, t] * xs[:, t])[..., None] * Bm[:, t, None]
        h = a * h + b
        ys.append(torch.einsum("bds,bs->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) if ys else xs.new_zeros(B, 0, din)
    return y, h
