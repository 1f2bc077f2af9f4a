"""GQA attention with RoPE over a paged KV cache.

Counterpart of ``repro/models/attention.py``.  Two execution paths, chosen
by the caller:
  * ``kernel`` — the CUDA kernels through ``kernels/ops.py`` (on a CPU
                 tensor each wrapper computes its plain version);
  * ``ref``    — the plain PyTorch versions in ``kernels/ref.py``, on any
                 device: what the kernel path is held against on the card.

The decode cache is the paged pool of ``kvcache/manager.py``:
(num_blocks, page, Hkv, D) per layer, addressed through int32 block
tables.  The reference's slot-dense cache is its special case with
identity tables.  Writes into the pool are in place.

Under a sliding window W the pool holds each sequence as a ring of W
positions, the reference's ring-buffer cache (``cache_shape``,
``prefill_into_cache``): position p lives at ring slot p % W, mapped
through the first W / page entries of the sequence's block table
(``ring_table``).  RoPE is applied before K is cached, so the order of
the slots does not matter to attention.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (ParamInit, apply_rope, mrope_cos_sin,
                                       rope_cos_sin)

IMPLS = ("kernel", "ref")


class Attention(nn.Module):
    """wq (d, Hq*D), wk/wv (d, Hkv*D), wo (Hq*D, d); biases when qkv_bias."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        d, D = cfg.d_model, cfg.head_dim
        hq, hkv = cfg.heads_padded(1), cfg.kv_heads_padded(1)
        self.wq = init.normal(d, hq * D)
        self.wk = init.normal(d, hkv * D)
        self.wv = init.normal(d, hkv * D)
        self.wo = init.normal(hq * D, d)
        if cfg.qkv_bias:
            self.bq = init.zeros(hq * D)
            self.bk = init.zeros(hkv * D)
            self.bv = init.zeros(hkv * D)


def init_attention(init: ParamInit, cfg) -> Attention:
    return Attention(init, cfg)


def _qkv(p: Attention, cfg, x):
    """x (..., d) -> q (..., Hq, D), k/v (..., Hkv, D)."""
    D = cfg.head_dim
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    lead = x.shape[:-1]
    return (q.view(*lead, -1, D), k.view(*lead, -1, D),
            v.view(*lead, -1, D))


def _rope(cfg, q, k, positions):
    """positions: the leading dims of q/k without the head dims, and for
    M-RoPE a last axis of 3 (the t, h, w streams)."""
    if cfg.rope_type == "none":
        return q, k
    if cfg.rope_type == "mrope":
        cos, sin = mrope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    elif cfg.rope_type == "rope":
        cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    else:
        raise ValueError(f"no such rope_type {cfg.rope_type!r}")
    return (apply_rope(q, cos, sin).to(q.dtype),
            apply_rope(k, cos, sin).to(k.dtype))


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl {impl!r} not in {IMPLS}")


def prefill_attention(q, k, v, *, window: Optional[int], impl: str):
    """(B,S,H,D) causal attention on the chosen path."""
    check_impl(impl)
    if impl == "kernel":
        return ops.flash_prefill(q, k, v, window=window)
    return ref.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                window=window).transpose(1, 2)


def full_attention(p: Attention, cfg, x, positions, *, impl: str = "kernel"):
    """Prefill path.  Returns (out, (k, v)) — k/v for the cache write."""
    q, k, v = _qkv(p, cfg, x)
    q, k = _rope(cfg, q, k, positions)
    out = prefill_attention(q, k, v, window=cfg.sliding_window, impl=impl)
    B, S = x.shape[:2]
    return out.reshape(B, S, -1) @ p.wo, (k, v)


def ring_pages(window: Optional[int], page: int) -> Optional[int]:
    """Pages of a ``window``-slot ring (None without a window); raises
    when ``page`` does not divide the window."""
    if not window:
        return None
    if window % page:
        raise ValueError(f"page {page} does not divide the sliding window "
                         f"{window}: the ring's slots must be whole pages")
    return window // page


def ring_table(blocks, window: Optional[int], page: int):
    """A sequence's block table from the blocks it holds (a list): all of
    them, or under a window the first W / page, which hold its ring."""
    n = ring_pages(window, page)
    return blocks if n is None else blocks[:n]


def check_ring_tables(block_tables, window: Optional[int], page: int):
    """Under a window, block tables must be ring tables: at most W / page
    entries (a wider table would make the decode kernels split more)."""
    n = ring_pages(window, page)
    if n is not None and block_tables.shape[1] > n:
        raise ValueError(f"block tables of {block_tables.shape[1]} pages "
                         f"under a window of {window} ({n} pages): pass "
                         f"ring tables (ring_table)")


def ring_slots(positions, window: Optional[int]):
    """Where token ``positions`` live in the pool: p, or p % W."""
    return positions % window if window else positions


def ring_lens(lens, window: Optional[int]):
    """The cached tokens attention reads: ``lens``, or at most W."""
    return torch.clamp(lens, max=window) if window else lens


def pool_rows(block_tables, positions, page: int):
    """Flat pool rows (block * page + offset) of token ``positions``
    (B, n) through ``block_tables`` (B, max_pages) -> (B*n,) int64."""
    pos = positions.long()
    blocks = torch.gather(block_tables.long(), 1, pos // page)
    return (blocks * page + pos % page).reshape(-1)


def write_kv(k_pages, v_pages, k, v, rows):
    """Write k/v rows (n, Hkv, D) into the pools at flat ``rows`` (n,),
    in place."""
    N, page, Hkv, D = k_pages.shape
    k_pages.view(N * page, Hkv, D)[rows] = k.to(k_pages.dtype)
    v_pages.view(N * page, Hkv, D)[rows] = v.to(v_pages.dtype)


def decode_attention(p: Attention, cfg, x, positions, k_pages, v_pages,
                     block_tables, seq_lens, *, impl: str = "kernel"):
    """One-token decode step over the paged pool.

    x (B, 1, d); positions (B, 1) or (B, 1, 3); k/v_pages (N, page,
    Hkv, D); block_tables (B, max_pages) int32 (ring tables under a
    window); seq_lens (B,) int32 = tokens already cached.  The new
    token's K/V is written at position seq_lens (ring slot seq_lens % W),
    never at a position id, BEFORE attention, which then covers
    seq_lens + 1 tokens (at most W).
    Returns out (B, 1, d); the pools are updated in place.
    """
    check_impl(impl)
    w = cfg.sliding_window
    B = x.shape[0]
    q, k1, v1 = _qkv(p, cfg, x)
    q, k1 = _rope(cfg, q, k1, positions)
    rows = pool_rows(block_tables, ring_slots(seq_lens, w)[:, None],
                     k_pages.shape[1])
    write_kv(k_pages, v_pages, k1[:, 0], v1[:, 0], rows)
    attend = ops.paged_attention if impl == "kernel" else ref.paged_attention
    out = attend(q[:, 0], k_pages, v_pages, block_tables,
                 ring_lens(seq_lens + 1, w))
    return out.reshape(B, 1, -1) @ p.wo
