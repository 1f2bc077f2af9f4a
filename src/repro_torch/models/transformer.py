"""Decoder assembly for attention and Mamba mixers with dense FFNs.

Counterpart of ``repro/models/transformer.py``.  Pre-norm residual blocks:
    x = x + mixer(rmsnorm(x))          mixer in {attn, mamba}
    x = x + dense_ffn(rmsnorm(x))
A plain loop over layers takes the place of the reference's scan over
stacked periods; ``convert.py`` unstacks the reference's parameters.
Any other mixer or FFN (MoE, xLSTM) raises ``NotImplementedError``.

Entry points:
  * ``forward``          — prefill over full sequences (``return_aux``
                           gives per-layer K/V; ``last_only`` the LM head
                           on the final position);
  * ``decode_forward``   — one-token step over the paged KV pool;
  * ``fused_pd_forward`` — the RAPID concurrent step: a prefill batch and a
                           decode batch through every layer together, with
                           ONE ``unified_pd`` launch per layer for both
                           attentions and ONE ``ssm_scan`` launch per
                           Mamba layer for the prefill.

The cache is a list with one entry per layer.  An attention layer has a
paged pool ``{"k", "v"}`` of ``(num_blocks, page, Hkv, D)``, and every
attention layer uses the same block ids.  A Mamba layer has per-slot
state ``{"conv" (slots, d_conv-1, din), "ssm" (slots, din, ds) f32}``:
row s belongs to the request in decode slot s, and the entry points take
each row's ``slots`` as they take its block table.  The reference's
slot-dense state is the case ``slots = arange(B)``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamInit, embed_tokens, lm_logits,
                                       rmsnorm)


class Block(nn.Module):
    """``kind`` is the mixer: "attn" or "mamba"."""

    def __init__(self, init: ParamInit, cfg, pos: int):
        super().__init__()
        self.kind = cfg.mixer_at(pos)
        if self.kind not in ("attn", "mamba") or cfg.ffn_at(pos) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: only attention or Mamba + dense FFN blocks "
                f"are ported (layer {pos}: {self.kind}/{cfg.ffn_at(pos)})")
        self.norm1 = init.ones(cfg.d_model)
        self.mixer = (attn_mod.init_attention(init, cfg)
                      if self.kind == "attn" else mamba_mod.Mamba(init, cfg))
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
        moe = [i for i in range(cfg.num_layers) if cfg.ffn_at(i) == "moe"]
        if moe:
            raise NotImplementedError(
                f"{cfg.name}: the MoE FFN is not ported yet; layers {moe} "
                f"are MoE layers")
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


def _read_state(c, slots):
    """A Mamba layer's state rows of decode ``slots`` (B,) int64."""
    return {"conv": c["conv"][slots], "ssm": c["ssm"][slots]}


def _write_state(c, slots, state):
    """Write a Mamba state (B rows) into the cache rows ``slots``, in the
    cache's dtypes, in place."""
    c["conv"][slots] = state["conv"].to(c["conv"].dtype)
    c["ssm"][slots] = state["ssm"].to(c["ssm"].dtype)


def _page(cache) -> int:
    return next(c["k"].shape[1] for c in cache if "k" in c)


@torch.no_grad()
def forward(model: Transformer, inputs, positions, *, impl: str = "kernel",
            return_aux: bool = False, last_only: bool = False):
    """inputs (B,S) tokens, positions (B,S).  Returns logits
    (B,S|1,vocab_padded), or (logits, aux) with ``return_aux`` where aux
    is a per-layer list: {"k", "v"} (B,S,Hkv,D) for an attention layer,
    the final state {"conv", "ssm"} for a Mamba layer."""
    cfg = model.cfg
    x = embed_tokens(model, inputs)
    aux = []
    for blk in model.layers:
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        if blk.kind == "attn":
            out, (k, v) = attn_mod.full_attention(blk.mixer, cfg, h,
                                                  positions, impl=impl)
            state = {"k": k, "v": v}
        else:
            out, state = mamba_mod.mamba_forward(blk.mixer, cfg, h,
                                                 impl=impl)
        x = _ffn_residual(blk, cfg, x + out)
        if return_aux:
            aux.append(state)
    if last_only:
        x = x[:, -1:]
    logits = lm_logits(model, x)
    return (logits, aux) if return_aux else logits


def init_cache(cfg, num_blocks: int, page: int, slots: int, *,
               device="cpu", dtype=None):
    """A zeroed cache: per attention layer a paged pool {"k", "v"}, each
    (num_blocks, page, Hkv, D); per Mamba layer the state of ``slots``
    decode slots, {"conv" (slots, d_conv-1, din) in ``dtype``,
    "ssm" (slots, din, ds) float32}."""
    if cfg.sliding_window:
        raise NotImplementedError("ring-buffer (sliding window) caches are "
                                  "not ported yet")
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (num_blocks, page, cfg.kv_heads_padded(1), cfg.head_dim)
    cache = []
    for i in range(cfg.num_layers):
        if cfg.mixer_at(i) == "attn":
            cache.append({"k": torch.zeros(shape, device=device, dtype=dtype),
                          "v": torch.zeros(shape, device=device,
                                           dtype=dtype)})
        else:
            m = cfg.mamba
            cache.append({
                "conv": torch.zeros(slots, m.d_conv - 1, cfg.d_inner,
                                    device=device, dtype=dtype),
                "ssm": torch.zeros(slots, cfg.d_inner, m.d_state,
                                   device=device, dtype=torch.float32)})
    return cache


@torch.no_grad()
def write_prefill_to_cache(cache, aux, block_tables, slots):
    """Write ``forward(return_aux=True)`` products into the cache, in
    place: K/V (B,S,Hkv,D) into the pools at positions 0..S-1 of each
    sequence's ``block_tables`` (B, max_pages) row, and each Mamba
    layer's final state into rows ``slots`` (B,) int64.  Returns the
    cache."""
    rows = None
    for c, a in zip(cache, aux):
        if "ssm" in c:
            _write_state(c, slots, a)
            continue
        if rows is None:
            B, S = a["k"].shape[:2]
            positions = torch.arange(S, device=block_tables.device)
            rows = attn_mod.pool_rows(block_tables, positions.expand(B, S),
                                      c["k"].shape[1])
        attn_mod.write_kv(c["k"], c["v"], a["k"].flatten(0, 1),
                          a["v"].flatten(0, 1), rows)
    return cache


@torch.no_grad()
def decode_forward(model: Transformer, inputs, positions, cache,
                   block_tables, seq_lens, slots, *, impl: str = "kernel"):
    """One-token decode.  inputs (B,1) tokens; positions (B,1);
    block_tables (B,max_pages) int32; seq_lens (B,) int32 tokens already
    cached; slots (B,) int64 the Mamba state row of each sequence.
    Returns (logits (B,1,vocab_padded), cache) — the cache is updated in
    place."""
    cfg = model.cfg
    x = embed_tokens(model, inputs)
    for blk, c in zip(model.layers, cache):
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        if blk.kind == "attn":
            out = attn_mod.decode_attention(blk.mixer, cfg, h, positions,
                                            c["k"], c["v"], block_tables,
                                            seq_lens, impl=impl)
        else:
            out, state = mamba_mod.mamba_decode_step(
                blk.mixer, cfg, h, _read_state(c, slots))
            _write_state(c, slots, state)
        x = _ffn_residual(blk, cfg, x + out)
    return lm_logits(model, x), cache


@torch.no_grad()
def fused_pd_forward(model: Transformer, p_inputs, p_positions, d_inputs,
                     d_positions, cache, block_tables, seq_lens, slots, *,
                     f_decode: float = 0.5, impl: str = "kernel"):
    """The RAPID concurrent step: prefill ``p_inputs`` (Bp,Sp) and decode
    ``d_inputs`` (Bd,1) through every layer together.

    The prefill rows and the decode rows share each layer's projections
    and FFN (one matrix product over both).  In an attention layer the
    decode tokens' K/V are written into the pools and one ``unified_pd``
    launch computes both attentions.  In a Mamba layer one ``ssm_scan``
    launch runs the prefill from a zero state, and the decode rows take
    one step on their ``slots``' (Bd,) state, updated in place.  Returns
    (p_logits (Bp,1,Vp) at the last position, aux per-layer prefill
    products as ``forward``'s, d_logits (Bd,1,Vp), cache) — the same
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
    rows = attn_mod.pool_rows(block_tables, seq_lens[:, None], _page(cache))
    step = ops.unified_pd if impl == "kernel" else _ref_unified_pd
    aux = []
    for blk, c in zip(model.layers, cache):
        h = rmsnorm(x, blk.norm1, cfg.norm_eps)
        if blk.kind == "attn":
            q, k, v = attn_mod._qkv(blk.mixer, cfg, h)
            q, k = attn_mod._rope(cfg, q, k, positions)
            attn_mod.write_kv(c["k"], c["v"], k[n_p:], v[n_p:], rows)
            kp = k[:n_p].view(Bp, Sp, *k.shape[1:])
            vp = v[:n_p].view(Bp, Sp, *v.shape[1:])
            o_p, o_d = step(q[:n_p].view(Bp, Sp, *q.shape[1:]), kp, vp,
                            q[n_p:], c["k"], c["v"], block_tables,
                            seq_lens + 1, f_decode=f_decode)
            out = torch.cat([o_p.reshape(n_p, -1),
                             o_d.reshape(Bd, -1)]) @ blk.mixer.wo
            aux.append({"k": kp, "v": vp})
        else:
            xz = h @ blk.mixer.in_proj
            y_p, state = mamba_mod.prefill_mixer(
                blk.mixer, cfg, xz[:n_p].view(Bp, Sp, -1), impl=impl)
            y_d, d_state = mamba_mod.decode_mixer(blk.mixer, cfg, xz[n_p:],
                                                  _read_state(c, slots))
            _write_state(c, slots, d_state)
            out = torch.cat([y_p.reshape(n_p, -1), y_d]) @ \
                blk.mixer.out_proj
            aux.append(state)
        x = _ffn_residual(blk, cfg, x + out)
    last = torch.cat([x[:n_p].view(Bp, Sp, -1)[:, -1], x[n_p:]])
    logits = lm_logits(model, last)[:, None]
    return logits[:Bp], aux, logits[Bp:], cache


def _ref_unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
                    seq_lens, *, f_decode):
    """``ops.unified_pd``'s layouts over the plain version (f_decode only
    sets which SMs take which tiles first, so the plain version ignores
    it)."""
    o_p, o_d = ref.unified_pd(q_p.transpose(1, 2), k_p.transpose(1, 2),
                              v_p.transpose(1, 2), q_d, k_pages, v_pages,
                              block_tables, seq_lens)
    return o_p.transpose(1, 2), o_d


def greedy_sample(logits, vocab_size: int):
    """Argmax over the unpadded vocab.  logits (B,1,Vp) -> (B,1) int32."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)
