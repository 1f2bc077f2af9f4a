"""GQA attention with RoPE over a paged KV cache.

Counterpart of ``repro/models/attention.py``.  Two execution paths, chosen
by the caller:
  * ``kernel`` — the CUDA kernels through ``kernels/ops.py`` (on a CPU
                 tensor each wrapper computes its plain version);
  * ``ref``    — the plain PyTorch versions in ``kernels/ref.py``, on any
                 device: what the kernel path is held against on the card.

``tp``, the model's tensor-parallel degree, pads the heads as the
reference's does: query heads to a multiple of tp, KV heads too when that
costs at most 2x (``kv_shard_mode`` "heads"), else the KV heads stay
whole and the cache is sharded over the sequence ("seq").  Padded heads
are real compute; at tp = 1 nothing is padded.

Under a mesh (DTensor inputs, ``sharding.py``) the projections run as
DTensor products, ``constrain`` at the reference's places; attention
itself runs on each chip's shards (``on_shards``): heads over "model"
and sequences over "batch" are independent, so the kernel or the plain
version computes them on local tensors, and a kernel is never handed a
DTensor.  In "seq" mode the query heads are gathered first.  A decode
over a pool whose blocks are split over the sequence (context-parallel
KV, ``long_500k``) computes each chip's pages' part with its
log-sum-exp and combines the parts (``paged_partial``); a kernel takes
that only where the split is one chip (it returns no log-sum-exp).

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

import functools
from typing import Optional

import torch
from torch import nn

from repro_torch import sharding
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (ParamInit, apply_rope, mm,
                                       mrope_cos_sin, rope_cos_sin)

IMPLS = ("kernel", "ref")


class Attention(nn.Module):
    """wq (d, Hq*D), wk/wv (d, Hkv*D), wo (Hq*D, d); biases when qkv_bias.
    Hq and Hkv padded for ``tp`` (the module docstring)."""

    def __init__(self, init: ParamInit, cfg, tp: int = 1):
        super().__init__()
        d, D = cfg.d_model, cfg.head_dim
        self.tp = tp
        hq, hkv = cfg.heads_padded(tp), cfg.kv_heads_padded(tp)
        self.wq = init.normal(d, hq * D)
        self.wk = init.normal(d, hkv * D)
        self.wv = init.normal(d, hkv * D)
        self.wo = init.normal(hq * D, d)
        if cfg.qkv_bias:
            self.bq = init.zeros(hq * D)
            self.bk = init.zeros(hkv * D)
            self.bv = init.zeros(hkv * D)


def init_attention(init: ParamInit, cfg, tp: int = 1) -> Attention:
    return Attention(init, cfg, tp)


def kv_spec(cfg, tp: int):
    """The logical name of the KV heads' dim: "model", or None where the
    KV heads stay whole ("seq" mode)."""
    return "model" if cfg.kv_shard_mode(tp) == "heads" else None


def param_specs(cfg, tp: int = 1) -> dict:
    """The logical axes of each parameter (the reference's specs)."""
    kv = kv_spec(cfg, tp)
    specs = {"wq": (None, "model"), "wk": (None, kv), "wv": (None, kv),
             "wo": ("model", None)}
    if cfg.qkv_bias:
        specs.update(bq=("model",), bk=(kv,), bv=(kv,))
    return specs


_identity = sharding.identity


def _qkv(p: Attention, cfg, x, constrain=_identity):
    """x (..., d) -> q (..., Hq, D), k/v (..., Hkv, D)."""
    D = cfg.head_dim
    q, k, v = mm(x, p.wq), mm(x, p.wk), mm(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    if constrain is not _identity:
        kv = kv_spec(cfg, p.tp)
        lead_axes = ("batch",) + (None,) * (x.dim() - 2)
        q = constrain(q, lead_axes + ("model",))
        k = constrain(k, lead_axes + (kv,))
        v = constrain(v, lead_axes + (kv,))
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
    """(B,S,H,D) causal attention on the chosen path; DTensors on each
    chip's shards (sequences and heads; a sequence must not be split)."""
    check_impl(impl)
    if sharding.is_dtensor(q):
        return sharding.on_shards(functools.partial(
            prefill_attention, window=window, impl=impl), q, k, v, like=q)
    if impl == "kernel":
        return ops.flash_prefill(q, k, v, window=window)
    return ref.causal_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2),
                                window=window).transpose(1, 2)


def _heads_whole(cfg, tp, q, constrain):
    """In "seq" mode under a mesh, the query heads gathered, so that each
    chip holds every head of its KV heads' groups."""
    if constrain is _identity or kv_spec(cfg, tp) == "model":
        return q
    return constrain(q, ("batch",) + (None,) * (q.dim() - 1))


def full_attention(p: Attention, cfg, x, positions, *, impl: str = "kernel",
                   constrain=_identity):
    """Prefill path.  Returns (out, (k, v)) — k/v for the cache write."""
    q, k, v = _qkv(p, cfg, x, constrain)
    q, k = _rope(cfg, q, k, positions)
    out = prefill_attention(_heads_whole(cfg, p.tp, q, constrain), k, v,
                            window=cfg.sliding_window, impl=impl)
    B, S = x.shape[:2]
    if constrain is not _identity:
        out = constrain(out, ("batch", None, "model", None))
    return mm(out.reshape(B, S, -1), p.wo), (k, v)


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
                     block_tables, seq_lens, *, impl: str = "kernel",
                     constrain=_identity, cp_offsets=None):
    """One-token decode step over the paged pool.

    x (B, 1, d); positions (B, 1) or (B, 1, 3); k/v_pages (N, page,
    Hkv, D); block_tables (B, max_pages) int32 (ring tables under a
    window); seq_lens (B,) int32 = tokens already cached.  The new
    token's K/V is written at position seq_lens (ring slot seq_lens % W),
    never at a position id, BEFORE attention, which then covers
    seq_lens + 1 tokens (at most W).
    Returns out (B, 1, d); the pools are updated in place.

    Under a mesh the tables hold each chip's own block ids (every chip
    the same table), and a pool split over the sequence takes
    ``cp_offsets``: a DTensor of each chip's first position, split as the
    pool's blocks are.
    """
    check_impl(impl)
    B = x.shape[0]
    q, k1, v1 = _qkv(p, cfg, x, constrain)
    q, k1 = _rope(cfg, q, k1, positions)
    args = (q[:, 0], k1[:, 0], v1[:, 0], k_pages, v_pages, block_tables,
            seq_lens)
    if sharding.is_dtensor(q):
        out = _decode_shards(cfg, _heads_whole(cfg, p.tp, args[0],
                                               constrain), *args[1:],
                             impl=impl, cp_offsets=cp_offsets)
        out = constrain(out, ("batch", "model", None))
    else:
        out = _decode_local(cfg, *args, impl=impl)
    return mm(out.reshape(B, 1, -1), p.wo)


def _decode_local(cfg, q, k1, v1, k_pages, v_pages, block_tables, seq_lens,
                  *, impl):
    """Write k1/v1 (B, Hkv, D) at ``seq_lens`` and attend: (B, Hq, D)."""
    w = cfg.sliding_window
    rows = pool_rows(block_tables, ring_slots(seq_lens, w)[:, None],
                     k_pages.shape[1])
    write_kv(k_pages, v_pages, k1, v1, rows)
    attend = ops.paged_attention if impl == "kernel" else ref.paged_attention
    return attend(q, k_pages, v_pages, block_tables,
                  ring_lens(seq_lens + 1, w))


def _cp_dims(q, k_pages) -> list:
    """The mesh dims (of more than one chip) that split the pool's blocks
    but not the batch: the pool is split over the sequence there."""
    from torch.distributed.tensor import Shard
    mesh = k_pages.device_mesh
    return [i for i, (pk, pq) in enumerate(zip(k_pages.placements,
                                               q.placements))
            if mesh.size(i) > 1 and pk == Shard(0) and pq != Shard(0)]


def _decode_shards(cfg, q, k1, v1, k_pages, v_pages, block_tables, seq_lens,
                   *, impl, cp_offsets):
    """``_decode_local`` on each chip's shards; over a pool split along
    the sequence, each chip's part and the parts combined."""
    cp = _cp_dims(q, k_pages)
    if not cp:
        return sharding.on_shards(functools.partial(
            _decode_local, cfg, impl=impl), q, k1, v1, k_pages, v_pages,
            block_tables, seq_lens, like=q)
    if impl == "kernel":
        raise NotImplementedError(
            "a context-parallel decode over more than one chip needs each "
            "part's log-sum-exp, which the paged kernel does not return")
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    o, lse = [t.to_local() if sharding.is_dtensor(t) else t
              for t in _cp_part(q, k1, v1, k_pages, v_pages, block_tables,
                                seq_lens, cp_offsets, cfg.sliding_window)]
    # the parts stacked on a new leading dim, split over the CP dims
    place = [Shard(p.dim + 1) if isinstance(p, Shard) else p
             for p in q.placements]
    for i in cp:
        place[i] = Shard(0)
    whole = list(place)
    for i in cp:
        whole[i] = Replicate()
    o = DTensor.from_local(o[None], mesh, place, run_check=False) \
        .redistribute(mesh, whole)
    lse = DTensor.from_local(lse[None], mesh, place, run_check=False) \
        .redistribute(mesh, whole)
    wgt = torch.exp(lse - lse.amax(0, keepdim=True))
    out = (o * wgt[..., None]).sum(0) / wgt.sum(0)[..., None]
    return out.to(q.dtype)


def _cp_part(q, k1, v1, k_pages, v_pages, block_tables, seq_lens, offsets,
             window=None):
    """Each chip's part of a context-parallel decode, on its shards: the
    new token's K/V written where its slot (its position, or under a
    window its ring slot) falls in the chip's slice of the sequence's
    slots, then attention over the slice's cached slots.  Returns the
    part's output (B, Hq, D) float32 and log-sum-exp (B, Hq)."""
    loc = [t.to_local() if sharding.is_dtensor(t) else t
           for t in (q, k1, v1, k_pages, v_pages, block_tables, seq_lens,
                     offsets)]
    q, k1, v1, kp, vp, tables, lens, off = loc
    page = kp.shape[1]
    span = kp.shape[0] * page // q.shape[0]     # the chip's slots a sequence
    pos = ring_slots(lens.long(), window) - off.long()
    mine = ((pos >= 0) & (pos < span))[:, None, None]
    rows = pool_rows(tables, pos.clamp(0, span - 1)[:, None], page)
    N, _, Hkv, D = kp.shape
    write_kv(kp, vp, torch.where(mine, k1, kp.view(N * page, Hkv, D)[rows]),
             torch.where(mine, v1, vp.view(N * page, Hkv, D)[rows]), rows)
    return paged_partial(q, kp, vp, tables,
                         (ring_lens(lens.long() + 1, window) -
                          off.long()).clamp(0, span))


def paged_partial(q, k_pages, v_pages, block_tables, seq_lens):
    """``ref.paged_attention`` over the first ``seq_lens`` tokens of each
    table, also returning the log-sum-exp of the scores: (out (B, Hq, D)
    float32, lse (B, Hq)).  A row with no token gives lse about NEG_INF
    (weight 0 when parts are combined)."""
    B, Hq, D = q.shape
    _, page, Hkv, _ = k_pages.shape
    G = Hq // Hkv
    tabs = block_tables.long()
    n = tabs.shape[1] * page
    kk = k_pages[tabs].reshape(B, n, Hkv, D).float()
    vv = v_pages[tabs].reshape(B, n, Hkv, D).float()
    scores = torch.einsum("bhgd,bkhd->bhgk", q.reshape(B, Hkv, G, D).float(),
                          kk) / (D ** 0.5)
    valid = torch.arange(n, device=q.device)[None, :] < seq_lens[:, None]
    scores = scores.masked_fill(~valid[:, None, None], ref.NEG_INF)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", torch.softmax(scores, dim=-1), vv)
    return out.reshape(B, Hq, D), lse.reshape(B, Hq)
