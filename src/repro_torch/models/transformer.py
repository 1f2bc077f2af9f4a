"""Decoder assembly for attention + dense-FFN architectures.

Counterpart of ``repro/models/transformer.py``.  Pre-norm residual blocks:
    x = x + attn(rmsnorm(x))
    x = x + dense_ffn(rmsnorm(x))
A plain loop over layers takes the place of the reference's scan over
stacked periods; ``convert.py`` unstacks the reference's parameters.
Any other mixer or FFN raises ``NotImplementedError``.

Entry points:
  * ``forward``          — prefill over full sequences (``return_aux``
                           gives per-layer K/V; ``last_only`` the LM head
                           on the final position);
  * ``decode_forward``   — one-token step over the paged KV pool;
  * ``fused_pd_forward`` — the RAPID concurrent step: a prefill batch and a
                           decode batch through every layer together, with
                           ONE ``unified_pd`` launch per layer for both
                           attentions.

The KV cache is one paged pool per layer, ``(num_blocks, page, Hkv, D)``,
and every layer uses the same block ids.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamInit, embed_tokens, lm_logits,
                                       rmsnorm)


class Block(nn.Module):
    def __init__(self, init: ParamInit, cfg, pos: int):
        super().__init__()
        if cfg.mixer_at(pos) != "attn" or cfg.ffn_at(pos) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: only attention + dense FFN blocks are ported "
                f"(layer {pos}: {cfg.mixer_at(pos)}/{cfg.ffn_at(pos)})")
        self.norm1 = init.ones(cfg.d_model)
        self.mixer = attn_mod.init_attention(init, cfg)
        self.norm2 = init.ones(cfg.d_model)
        self.ffn = moe_mod.init_dense_ffn(init, cfg)


class Transformer(nn.Module):
    """tok (vocab_padded, d) [tied LM head], lm_head (d, vocab_padded)
    when untied, final_norm (d,), layers[i]: Block."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        if cfg.frontend != "token":
            raise NotImplementedError(f"frontend {cfg.frontend!r} is not "
                                      "ported yet")
        self.cfg = cfg
        self.tok = init.normal(cfg.vocab_padded, cfg.d_model, scale=1.0)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal(cfg.d_model, cfg.vocab_padded)
        self.final_norm = init.ones(cfg.d_model)
        self.layers = nn.ModuleList(
            Block(init, cfg, i % cfg.period) for i in range(cfg.num_layers))


def init_model(cfg, *, seed: int = 0, device="cpu", dtype=None,
               generator=None) -> Transformer:
    """Random weights drawn on ``device`` from a seeded torch.Generator
    (or the one given); ``dtype`` defaults to the config's."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(ParamInit(generator, device, dtype), cfg)


def _ffn_residual(blk: Block, cfg, x):
    return x + moe_mod.dense_ffn(blk.ffn, cfg,
                                 rmsnorm(x, blk.norm2, cfg.norm_eps))


@torch.no_grad()
def forward(model: Transformer, inputs, positions, *, impl: str = "kernel",
            return_aux: bool = False, last_only: bool = False):
    """inputs (B,S) tokens, positions (B,S).  Returns logits
    (B,S|1,vocab_padded), or (logits, aux) with ``return_aux`` where aux
    is a per-layer list of {"k", "v"} (B,S,Hkv,D)."""
    cfg = model.cfg
    x = embed_tokens(model, inputs)
    aux = []
    for blk in model.layers:
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        out, (k, v) = attn_mod.full_attention(blk.mixer, cfg, h, positions,
                                              impl=impl)
        x = _ffn_residual(blk, cfg, x + out)
        if return_aux:
            aux.append({"k": k, "v": v})
    if last_only:
        x = x[:, -1:]
    logits = lm_logits(model, x)
    return (logits, aux) if return_aux else logits


def init_cache(cfg, num_blocks: int, page: int, *, device="cpu",
               dtype=None):
    """One zeroed paged pool per layer: [{"k", "v"}], each
    (num_blocks, page, Hkv, D)."""
    if cfg.sliding_window:
        raise NotImplementedError("ring-buffer (sliding window) caches are "
                                  "not ported yet")
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (num_blocks, page, cfg.kv_heads_padded(1), cfg.head_dim)
    return [{"k": torch.zeros(shape, device=device, dtype=dtype),
             "v": torch.zeros(shape, device=device, dtype=dtype)}
            for _ in range(cfg.num_layers)]


@torch.no_grad()
def write_prefill_to_cache(cache, aux, block_tables):
    """Write ``forward(return_aux=True)`` K/V (B,S,Hkv,D) per layer into
    the pools at positions 0..S-1 of each sequence's ``block_tables``
    (B, max_pages) row, in place.  Returns the cache."""
    B, S = aux[0]["k"].shape[:2]
    page = cache[0]["k"].shape[1]
    positions = torch.arange(S, device=block_tables.device).expand(B, S)
    rows = attn_mod.pool_rows(block_tables, positions, page)
    for c, a in zip(cache, aux):
        attn_mod.write_kv(c["k"], c["v"], a["k"].flatten(0, 1),
                          a["v"].flatten(0, 1), rows)
    return cache


@torch.no_grad()
def decode_forward(model: Transformer, inputs, positions, cache,
                   block_tables, seq_lens, *, impl: str = "kernel"):
    """One-token decode.  inputs (B,1) tokens; positions (B,1);
    block_tables (B,max_pages) int32; seq_lens (B,) int32 tokens already
    cached.  Returns (logits (B,1,vocab_padded), cache) — the cache is
    updated in place."""
    cfg = model.cfg
    x = embed_tokens(model, inputs)
    for blk, c in zip(model.layers, cache):
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        out = attn_mod.decode_attention(blk.mixer, cfg, h, positions,
                                        c["k"], c["v"], block_tables,
                                        seq_lens, impl=impl)
        x = _ffn_residual(blk, cfg, x + out)
    return lm_logits(model, x), cache


@torch.no_grad()
def fused_pd_forward(model: Transformer, p_inputs, p_positions, d_inputs,
                     d_positions, cache, block_tables, seq_lens, *,
                     f_decode: float = 0.5, impl: str = "kernel"):
    """The RAPID concurrent step: prefill ``p_inputs`` (Bp,Sp) and decode
    ``d_inputs`` (Bd,1) through every layer together.

    The prefill rows and the decode rows share each layer's projections
    and FFN (one matrix product over both), the decode tokens' K/V are
    written into the pools, and one ``unified_pd`` launch computes both
    attentions.  Returns (p_logits (Bp,1,Vp) at the last position, aux
    per-layer prefill {"k","v"}, d_logits (Bd,1,Vp), cache) — the same
    products as the reference's forward + decode_forward step."""
    attn_mod.check_impl(impl)
    if model.cfg.sliding_window:
        raise NotImplementedError("ring-buffer (sliding window) decode is "
                                  "not ported yet")
    cfg = model.cfg
    Bp, Sp = p_inputs.shape
    Bd = d_inputs.shape[0]
    n_p = Bp * Sp
    x = torch.cat([embed_tokens(model, p_inputs).flatten(0, 1),
                   embed_tokens(model, d_inputs).flatten(0, 1)])
    positions = torch.cat([p_positions.reshape(-1), d_positions.reshape(-1)])
    page = cache[0]["k"].shape[1]
    rows = attn_mod.pool_rows(block_tables, seq_lens[:, None], page)
    step = ops.unified_pd if impl == "kernel" else _ref_unified_pd
    aux = []
    for blk, c in zip(model.layers, cache):
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        q, k, v = attn_mod._qkv(blk.mixer, cfg, h)
        q, k = attn_mod._rope(cfg, q, k, positions)
        attn_mod.write_kv(c["k"], c["v"], k[n_p:], v[n_p:], rows)
        kp = k[:n_p].view(Bp, Sp, *k.shape[1:])
        vp = v[:n_p].view(Bp, Sp, *v.shape[1:])
        o_p, o_d = step(q[:n_p].view(Bp, Sp, *q.shape[1:]), kp, vp, q[n_p:],
                        c["k"], c["v"], block_tables, seq_lens + 1,
                        f_decode=f_decode)
        out = torch.cat([o_p.reshape(n_p, -1), o_d.reshape(Bd, -1)])
        x = _ffn_residual(blk, cfg, x + out @ blk.mixer.wo)
        aux.append({"k": kp, "v": vp})
    last = torch.cat([x[:n_p].view(Bp, Sp, -1)[:, -1], x[n_p:]])
    logits = lm_logits(model, last)[:, None]
    return logits[:Bp], aux, logits[Bp:], cache


def _ref_unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
                    seq_lens, *, f_decode):
    """``ops.unified_pd``'s layouts over the plain version (f_decode only
    orders tiles, so the plain version ignores it)."""
    o_p, o_d = ref.unified_pd(q_p.transpose(1, 2), k_p.transpose(1, 2),
                              v_p.transpose(1, 2), q_d, k_pages, v_pages,
                              block_tables, seq_lens)
    return o_p.transpose(1, 2), o_d


def greedy_sample(logits, vocab_size: int):
    """Argmax over the unpadded vocab.  logits (B,1,Vp) -> (B,1) int32."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)
