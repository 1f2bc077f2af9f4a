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
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import ParamInit, apply_rope, rope_cos_sin

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
    """positions: the leading dims of q/k without the head dims."""
    if cfg.rope_type == "none":
        return q, k
    if cfg.rope_type != "rope":
        raise NotImplementedError(f"rope_type {cfg.rope_type!r} is not "
                                  "ported yet")
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
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

    x (B, 1, d); positions (B, 1); k/v_pages (N, page, Hkv, D);
    block_tables (B, max_pages) int32; seq_lens (B,) int32 = tokens
    already cached.  The new token's K/V is written at position seq_lens
    BEFORE attention, which then covers seq_lens + 1 tokens.
    Returns out (B, 1, d); the pools are updated in place.
    """
    if cfg.sliding_window:
        raise NotImplementedError("ring-buffer (sliding window) decode is "
                                  "not ported yet")
    check_impl(impl)
    B = x.shape[0]
    q, k1, v1 = _qkv(p, cfg, x)
    q, k1 = _rope(cfg, q, k1, positions)
    rows = pool_rows(block_tables, seq_lens[:, None], k_pages.shape[1])
    write_kv(k_pages, v_pages, k1[:, 0], v1[:, 0], rows)
    attend = ops.paged_attention if impl == "kernel" else ref.paged_attention
    out = attend(q[:, 0], k_pages, v_pages, block_tables, seq_lens + 1)
    return out.reshape(B, 1, -1) @ p.wo
