"""Decoder assembly: attention, Mamba and xLSTM mixers, dense, MoE or no FFN.

Counterpart of ``repro/models/transformer.py``.  Pre-norm residual blocks:
    x = x + mixer(rmsnorm(x))          mixer in {attn, mamba, mlstm, slstm}
    x = x + ffn(rmsnorm(x))            ffn in {dense, moe, none}
xLSTM mixers carry their own up and down projections, so xLSTM models
take FFN "none".  A plain loop over layers takes the place of the
reference's scan over stacked periods; ``convert.py`` unstacks the
reference's parameters.

Entry points:
  * ``lm_loss``          — the training loss over full sequences, with
                           per-layer remat and the LM head and
                           cross-entropy in checkpointed chunks;
  * ``forward``          — prefill over full sequences (``return_aux``
                           gives per-layer K/V or final state;
                           ``last_only`` the LM head on the final
                           position);
  * ``decode_forward``   — one-token step over the paged KV pool;
  * ``fused_pd_forward`` — the RAPID concurrent step: a prefill batch and a
                           decode batch through every layer together, with
                           ONE ``unified_pd`` launch per layer for both
                           attentions and ONE ``ssm_scan`` launch per
                           Mamba layer for the prefill.

An MoE layer takes the reference's capacity policy of the same step:
``forward`` with ``return_aux`` (the serving prefill) the inference
policy, without it and in ``lm_loss`` the training policy,
``decode_forward`` dropless; in
``fused_pd_forward`` the prefill rows are routed as ``forward`` with
``return_aux`` routes them and the decode rows dropless, apart, since
grouping them together would change the groups, the capacity and which
tokens drop.

The cache is a list with one entry per layer.  An attention layer has a
paged pool ``{"k", "v"}`` of ``(num_blocks, page, Hkv, D)``, and every
attention layer uses the same block ids.  A recurrent layer has per-slot
state rows: Mamba ``{"conv" (slots, d_conv-1, din), "ssm" (slots, din,
ds) f32}``, and in float32 mLSTM ``{"C" (slots, H, Dh, Dh), "n" (slots,
H, Dh), "m" (slots, H)}`` and sLSTM ``{"c", "n", "h", "m"}`` each
(slots, d): row s belongs to the request in decode slot s, and the entry
points take each row's ``slots`` as they take its block table.  The
reference's slot-dense state is the case ``slots = arange(B)``.

Inputs are tokens (B, S), or under ``frontend="embed_stub"`` (the audio
and vision backbones, whose encoders the reference stubs out) the
embeddings (B, S, d), cast to the model's dtype; the ``tok`` table stays,
as the tied LM head reads it.  Positions are (B, S), or (B, S, 3) for
M-RoPE's (t, h, w) streams; a decode writes its K/V at ``seq_lens``,
never at a position id (image tokens share a t).

Under a sliding window W (Mixtral) each sequence's pool is a ring of W
positions: position p lives at ring slot p % W, mapped through the first
W / page entries of its block table (``attention.ring_table``), so the
tables the entry points take hold at most W / page entries.  A prefill
writes its last min(S, W) tokens; a decode writes at ``seq_lens % W``
before attention and reads min(seq_lens + 1, W) slots, as the
reference's ring cache does.

``tp`` pads the attention heads as the reference's ``tp`` does
(``attention.py``); ``param_specs`` and ``cache_specs`` give every
parameter's and cache leaf's logical axes, the reference's specs per
layer.  Under a mesh the parameters and inputs are DTensors
(``launch/steps.py`` places them) and ``constrain`` redistributes the
activations at the reference's places; without one it is the identity,
and every path computes what it computes at tp = 1 without a mesh.

Only ``lm_loss`` builds an autograd graph; the serving entry points run
under ``torch.no_grad()``, so a model made trainable (``requires_grad_()``)
serves as before.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn_mod
from repro_torch.models import mamba as mamba_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (ParamInit, chunk_size, embed_tokens,
                                       lm_logits, pick_shards, rmsnorm)

NEG_INF = -1e30
XLSTM = ("mlstm", "slstm")
FRONTENDS = ("token", "embed_stub")
_MIXERS = {"attn": attn_mod.init_attention, "mamba": mamba_mod.Mamba,
           "mlstm": xlstm_mod.MLSTM, "slstm": xlstm_mod.SLSTM}
_FFNS = {"dense": moe_mod.init_dense_ffn, "moe": moe_mod.init_moe}


class Block(nn.Module):
    """``kind`` is the mixer: "attn", "mamba", "mlstm" or "slstm";
    ``ffn_kind`` the FFN: "dense", "moe" or "none" (no norm2, no ffn)."""

    def __init__(self, init: ParamInit, cfg, pos: int, tp: int = 1):
        super().__init__()
        self.kind, self.ffn_kind = cfg.mixer_at(pos), cfg.ffn_at(pos)
        if self.kind not in _MIXERS or \
                self.ffn_kind not in (*_FFNS, "none"):
            raise ValueError(f"{cfg.name}: no such block (layer {pos}: "
                             f"{self.kind}/{self.ffn_kind})")
        self.norm1 = init.ones(cfg.d_model)
        self.mixer = _MIXERS[self.kind](init, cfg, tp) \
            if self.kind == "attn" else _MIXERS[self.kind](init, cfg)
        if self.ffn_kind != "none":
            self.norm2 = init.ones(cfg.d_model)
            self.ffn = _FFNS[self.ffn_kind](init, cfg, tp)


class Transformer(nn.Module):
    """tok (vocab_padded, d) [tied LM head], lm_head (d, vocab_padded)
    when untied, final_norm (d,), layers[i]: Block; heads padded for
    ``tp``."""

    def __init__(self, init: ParamInit, cfg, tp: int = 1):
        super().__init__()
        self.tp = tp
        if cfg.frontend not in FRONTENDS:
            raise ValueError(f"{cfg.name}: no such frontend "
                             f"{cfg.frontend!r}")
        self.cfg = cfg
        self.tok = init.normal(cfg.vocab_padded, cfg.d_model, scale=1.0)
        if not cfg.tie_embeddings:
            self.lm_head = init.normal(cfg.d_model, cfg.vocab_padded)
        self.final_norm = init.ones(cfg.d_model)
        self.layers = nn.ModuleList(
            Block(init, cfg, i % cfg.period, tp)
            for i in range(cfg.num_layers))


def init_model(cfg, *, device, seed: int = 0, dtype=None,
               generator=None, tp: int = 1) -> Transformer:
    """Random weights drawn on ``device`` from a seeded torch.Generator
    (or the one given); ``dtype`` defaults to the config's."""
    dtype = dtype or getattr(torch, cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        return Transformer(ParamInit(generator, device, dtype), cfg, tp)


def _mixer_specs(cfg, kind: str, tp: int) -> dict:
    if kind == "attn":
        return attn_mod.param_specs(cfg, tp)
    if kind == "mamba":
        return mamba_mod.param_specs(cfg)
    return getattr(xlstm_mod, f"{kind}_specs")(cfg)


def param_specs(cfg, tp: int = 1) -> dict:
    """{parameter name: logical axes} of ``Transformer(cfg, tp)``: the
    reference's ``init_model`` specs, each layer's without its stacked
    period dim."""
    specs = {"tok": ("model", None), "final_norm": (None,)}
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "model")
    for i in range(cfg.num_layers):
        pre = f"layers.{i}."
        specs[pre + "norm1"] = (None,)
        for k, v in _mixer_specs(cfg, cfg.mixer_at(i), tp).items():
            specs[pre + "mixer." + k] = v
        ffn = cfg.ffn_at(i)
        if ffn != "none":
            specs[pre + "norm2"] = (None,)
            ffn_specs = moe_mod.dense_specs(cfg) if ffn == "dense" else \
                moe_mod.moe_specs(cfg, tp)
            for k, v in ffn_specs.items():
                specs[pre + "ffn." + k] = v
    return specs


def cache_specs(cfg, tp: int = 1) -> list:
    """Per layer, the logical axes of each cache leaf.  A pool's blocks
    hold sequences' pages, so its block dim carries both "batch" and
    "seq" (``launch/steps.py`` splits it over the one that divides); its
    KV heads are split as the attention's (``attention.kv_spec``)."""
    out = []
    for i in range(cfg.num_layers):
        kind = cfg.mixer_at(i)
        if kind == "attn":
            s = (("batch", "seq"), None, attn_mod.kv_spec(cfg, tp), None)
            out.append({"k": s, "v": s})
        elif kind == "mamba":
            out.append(dict(mamba_mod.STATE_SPECS))
        else:
            out.append(dict(getattr(xlstm_mod,
                                    f"{kind.upper()}_STATE_SPECS")))
    return out


def embed_inputs(model: Transformer, inputs, constrain=sharding.identity):
    """Tokens (B,S) through the embedding table, or an ``embed_stub``
    model's embeddings (B,S,d) cast to the model's dtype."""
    if model.cfg.frontend == "embed_stub":
        return inputs.to(model.tok.dtype)
    return constrain(embed_tokens(model, inputs),
                     ("batch",) + (None,) * (inputs.dim()))


def _ffn_residual(blk: Block, cfg, x, constrain=sharding.identity,
                  **moe_policy):
    """x + ffn(rmsnorm(x)), or x without an FFN; an MoE layer routes x
    under ``moe_policy`` (``moe_ffn``'s ``dropless`` / ``inference``)."""
    if blk.ffn_kind == "none":
        return x
    h = constrain(rmsnorm(x, blk.norm2, cfg.norm_eps),
                  ("batch",) + (None,) * (x.dim() - 1))
    if blk.ffn_kind == "dense":
        return x + moe_mod.dense_ffn(blk.ffn, cfg, h, constrain)
    return x + moe_mod.moe_ffn(blk.ffn, cfg, h, constrain=constrain,
                               **moe_policy)


def _read_state(c, slots):
    """A recurrent layer's state rows of decode ``slots`` (B,) int64."""
    return {k: t[slots] for k, t in c.items()}


def _write_state(c, slots, state):
    """Write a recurrent layer's state (B rows) into the cache rows
    ``slots``, in the cache's dtypes, in place."""
    for k, t in c.items():
        t[slots] = state[k].to(t.dtype)


_DECODE_STEPS = {"mamba": mamba_mod.mamba_decode_step,
                 "mlstm": xlstm_mod.mlstm_decode_step,
                 "slstm": xlstm_mod.slstm_decode_step}


def _page(cache) -> Optional[int]:
    """The pool's page size (None without an attention layer)."""
    return next((c["k"].shape[1] for c in cache if "k" in c), None)


def _block(blk: Block, cfg, x, positions, impl: str,
           inference: bool = False, constrain=sharding.identity):
    """One block over full sequences: (x out, the mixer's K/V or final
    state).  ``inference`` picks an MoE layer's capacity policy."""
    # the sequence gathered at the block's entry (Megatron-SP), the
    # reference's hint
    h = constrain(rmsnorm(x, blk.norm1, cfg.norm_eps), ("batch", None, None))
    if blk.kind == "attn":
        out, (k, v) = attn_mod.full_attention(blk.mixer, cfg, h, positions,
                                              impl=impl, constrain=constrain)
        state = {"k": k, "v": v}
    elif blk.kind == "mamba":
        out, state = mamba_mod.mamba_forward(blk.mixer, cfg, h, impl=impl)
    else:
        scan = getattr(xlstm_mod, f"{blk.kind}_forward")
        if sharding.is_dtensor(h):
            out, state = _xlstm_shards(blk, cfg, h, scan)
        else:
            out, state = scan(blk.mixer, cfg, h)
    x = _ffn_residual(blk, cfg, x + out, constrain, inference=inference)
    # the inter-block residual split over the sequence where the rules
    # say so (training: "seq" -> "model")
    return constrain(x, ("batch", "seq", None)), state


@torch.no_grad()
def forward(model: Transformer, inputs, positions, *, impl: str = "kernel",
            return_aux: bool = False, last_only: bool = False,
            constrain=sharding.identity):
    """inputs (B,S) tokens or (B,S,d) embeddings, positions (B,S) or
    (B,S,3).  Returns logits
    (B,S|1,vocab_padded), or (logits, aux) with ``return_aux`` where aux
    is a per-layer list: {"k", "v"} (B,S,Hkv,D) for an attention layer,
    the final state for a recurrent one ({"conv", "ssm"} Mamba, {"C",
    "n", "m"} mLSTM, {"c", "n", "h", "m"} sLSTM)."""
    x = embed_inputs(model, inputs, constrain)
    aux = []
    for blk in model.layers:
        # return_aux is the serving prefill: the inference capacity policy
        x, state = _block(blk, model.cfg, x, positions, impl,
                          inference=return_aux, constrain=constrain)
        if return_aux:
            aux.append(state)
    if last_only:
        x = x[:, -1:]
    logits = constrain(lm_logits(model, x), ("batch", None, "model"))
    return (logits, aux) if return_aux else logits


def _block_out(blk: Block, cfg, x, positions, impl: str,
               constrain=sharding.identity):
    return _block(blk, cfg, x, positions, impl, constrain=constrain)[0]


def _ce_sum(model: Transformer, x, labels, constrain=sharding.identity):
    """Summed cross-entropy of one chunk: the LM head in float32, padded
    vocab columns at NEG_INF."""
    cfg = model.cfg
    logits = constrain(lm_logits(model, x).float(),
                       ("batch", None, "model"))
    if cfg.vocab_padded != cfg.vocab_size:
        logits = logits.masked_fill(
            torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab_size,
            NEG_INF)
    if sharding.is_dtensor(logits):
        gold = pick_shards(logits, labels)
    else:
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.sum(torch.logsumexp(logits, dim=-1) - gold)


def lm_loss(model: Transformer, tokens, labels, positions, *,
            remat: bool = True, ce_chunk: int = 512,
            constrain=sharding.identity):
    """Mean next-token cross-entropy over B*S: tokens, labels, positions
    (B,S).  The trunk runs without the LM head, each layer checkpointed
    under ``remat`` (its activations recomputed in the backward; an sLSTM
    layer's token loop is checkpointed by the layer itself); the LM
    head and the cross-entropy run over chunks of ``ce_chunk`` positions
    (the largest divisor of S not above it), each chunk checkpointed, so
    the float32 logits of one chunk (B, c, vocab_padded) are live at a
    time.  An MoE layer takes the training capacity policy.  The layers
    run their plain versions (``impl="ref"``), as the reference trains:
    the hand-written kernels have no backward.

    The reference barriers each layer's parameters inside its scan
    (``grad_barrier``) so that XLA cannot hoist float32 upcasts of the
    whole stacked weights out of the loop; eager PyTorch runs each layer's
    ops where they are written and hoists nothing, so none is needed."""
    cfg = model.cfg
    x = embed_inputs(model, tokens, constrain)
    for blk in model.layers:
        # an sLSTM layer checkpoints its token loop in chunks itself: under
        # the layer's remat that loop, one small launch per op and token,
        # would run forward three times instead of twice
        if remat and blk.kind != "slstm":
            x = checkpoint(_block_out, blk, cfg, x, positions, "ref",
                           constrain, use_reentrant=False)
        else:
            x = _block_out(blk, cfg, x, positions, "ref", constrain)
    # the sequence gathered for the head's chunks (split over it in
    # training under a mesh)
    x = constrain(x, ("batch", None, None))
    B, S, _ = x.shape
    c = chunk_size(S, ce_chunk)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, c):
        total = total + checkpoint(_ce_sum, model, x[:, s0:s0 + c],
                                   labels[:, s0:s0 + c], constrain,
                                   use_reentrant=False)
    return total / (B * S)


def init_cache(cfg, num_blocks: int, page: int, slots: int, *,
               device, dtype=None, tp: int = 1):
    """A fresh cache: per attention layer a zeroed paged pool {"k", "v"},
    each (num_blocks, page, Hkv, D); per recurrent layer the zero state of
    ``slots`` decode slots (the module docstring), Mamba's conv window in
    ``dtype``, every other leaf float32.  Under a sliding window the page
    must divide it (the ring's slots are whole pages)."""
    attn_mod.ring_pages(cfg.sliding_window, page)
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (num_blocks, page, cfg.kv_heads_padded(tp), cfg.head_dim)
    cache = []
    for i in range(cfg.num_layers):
        kind = cfg.mixer_at(i)
        if kind == "attn":
            cache.append({"k": torch.zeros(shape, device=device, dtype=dtype),
                          "v": torch.zeros(shape, device=device,
                                           dtype=dtype)})
        elif kind in XLSTM:
            cache.append(getattr(xlstm_mod, f"{kind}_init_state")(
                cfg, slots, device=device))
        else:
            m = cfg.mamba
            cache.append({
                "conv": torch.zeros(slots, m.d_conv - 1, cfg.d_inner,
                                    device=device, dtype=dtype),
                "ssm": torch.zeros(slots, cfg.d_inner, m.d_state,
                                   device=device, dtype=torch.float32)})
    return cache


@torch.no_grad()
def write_prefill_to_cache(cache, aux, block_tables, slots, *,
                           window: Optional[int] = None):
    """Write ``forward(return_aux=True)`` products into the cache, in
    place: K/V (B,S,Hkv,D) into the pools at positions 0..S-1 of each
    sequence's ``block_tables`` (B, max_pages) row, and each recurrent
    layer's final state into rows ``slots`` (B,) int64.  Under a sliding
    ``window`` (the model's ``cfg.sliding_window``) only the last
    min(S, W) positions are written, each once, at its ring slot (two
    writes to one slot would land in no defined order on the card).
    Returns the cache."""
    rows = None
    for c, a in zip(cache, aux):
        if "k" not in c:
            _write_state(c, slots, a)
            continue
        B, S = a["k"].shape[:2]
        first = max(S - window, 0) if window else 0
        if rows is None:
            positions = torch.arange(first, S, device=block_tables.device)
            rows = attn_mod.pool_rows(
                block_tables, attn_mod.ring_slots(positions, window)
                .expand(B, S - first), c["k"].shape[1])
        attn_mod.write_kv(c["k"], c["v"], a["k"][:, first:].flatten(0, 1),
                          a["v"][:, first:].flatten(0, 1), rows)
    return cache


@torch.no_grad()
def decode_forward(model: Transformer, inputs, positions, cache,
                   block_tables, seq_lens, slots, *, impl: str = "kernel",
                   constrain=sharding.identity, cp_offsets=None):
    """One-token decode.  inputs (B,1) tokens or (B,1,d) embeddings;
    positions (B,1) or (B,1,3); block_tables (B,max_pages) int32 (ring
    tables under a window); seq_lens (B,) int32 tokens already cached;
    slots (B,) int64 the recurrent state row of each sequence.
    Returns (logits (B,1,vocab_padded), cache) — the cache is updated in
    place.  Under a mesh (``attention.decode_attention``) the tables hold
    each chip's block ids, the slots each chip's rows, and a pool split
    over the sequence takes ``cp_offsets``."""
    cfg = model.cfg
    if cfg.sliding_window:
        attn_mod.check_ring_tables(block_tables, cfg.sliding_window,
                                   _page(cache))
    x = embed_inputs(model, inputs, constrain)
    for blk, c in zip(model.layers, cache):
        h = constrain(rmsnorm(x, blk.norm1, cfg.norm_eps),
                      ("batch", None, None))
        if blk.kind == "attn":
            out = attn_mod.decode_attention(blk.mixer, cfg, h, positions,
                                            c["k"], c["v"], block_tables,
                                            seq_lens, impl=impl,
                                            constrain=constrain,
                                            cp_offsets=cp_offsets)
        elif sharding.is_dtensor(h):
            out = _state_step_shards(blk, cfg, h, c, slots)
        else:
            out, state = _DECODE_STEPS[blk.kind](blk.mixer, cfg, h,
                                                 _read_state(c, slots))
            _write_state(c, slots, state)
        x = _ffn_residual(blk, cfg, constrain(x + out, ("batch", None, None)),
                          constrain, dropless=True)
        x = constrain(x, ("batch", None, None))
    return lm_logits(model, x), cache


def _xlstm_shards(blk: Block, cfg, h, scan):
    """An xLSTM mixer over full sequences under a mesh, on each chip's
    sequences with the layer's weights gathered (its scans are
    sequential in time and independent across sequences): (out, final
    state), split as the batch is."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh
    h = h.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                              for pl in h.placements])
    weights = sharding.Leaves(**{
        n: sharding.local_weight(t.redistribute(
            mesh, sharding.replicated(mesh)), h)
        for n, t in blk.mixer.named_parameters()})
    out, state = scan(weights, cfg, h.to_local())
    names = list(state)
    got = sharding.on_shards(lambda: (out, *state.values()),
                             like=(h,) * (len(names) + 1))
    return got[0], dict(zip(names, got[1:]))


def _state_step_shards(blk: Block, cfg, h, c, slots):
    """A recurrent layer's decode step under a mesh: the layer's weights
    and its state rows gathered to each chip's own sequences (the rows
    split as the batch is; ``slots`` the chip's own row ids), the step
    taken on them, and the new rows written back into the cache's shards,
    in place."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = h.device_mesh

    def batch_only(t):
        return t.redistribute(mesh, [pl if pl == Shard(0) else Replicate()
                                     for pl in t.placements])

    h = batch_only(h)
    weights = sharding.Leaves(**{
        n: t.redistribute(mesh, sharding.replicated(mesh)).to_local()
        for n, t in blk.mixer.named_parameters()})
    whole = [batch_only(t) for t in c.values()]

    def step(h, slots, *rows):
        state = dict(zip(c, rows))
        out, new = _DECODE_STEPS[blk.kind](weights, cfg, h,
                                           _read_state(state, slots))
        return (out, *(new[k].to(state[k].dtype) for k in c))

    out, *new = sharding.on_shards(step, h, slots, *whole,
                                   like=(h, *whole))
    for t, rows in zip(c.values(), new):
        t.to_local()[slots.to_local()] = \
            rows.redistribute(mesh, t.placements).to_local()
    return out


@torch.no_grad()
def fused_pd_forward(model: Transformer, p_inputs, p_positions, d_inputs,
                     d_positions, cache, block_tables, seq_lens, slots, *,
                     f_decode: float = 0.5, impl: str = "kernel"):
    """The RAPID concurrent step: prefill ``p_inputs`` (Bp,Sp) and decode
    ``d_inputs`` (Bd,1) through every layer together (embeddings (.., d)
    and M-RoPE positions (.., 3) as ``forward`` takes them).

    The prefill rows and the decode rows share each layer's projections
    and dense FFN (one matrix product over both); an MoE layer routes
    them apart (the module docstring).  In an attention layer the decode
    tokens' K/V are written into the pools (at their ring slots under a
    window) and one ``unified_pd`` launch computes both attentions, the
    prefill tiles within the window.  In a Mamba layer one ``ssm_scan``
    launch runs the prefill from a zero state, and the decode rows take
    one step on their ``slots``' (Bd,) state, updated in place; an mLSTM
    or sLSTM layer does the same with its own scan and step.  Returns
    (p_logits (Bp,1,Vp) at the last position, aux per-layer prefill
    products as ``forward``'s, d_logits (Bd,1,Vp), cache) — the same
    products as the reference's forward + decode_forward step."""
    attn_mod.check_impl(impl)
    cfg = model.cfg
    w = cfg.sliding_window
    if w:
        attn_mod.check_ring_tables(block_tables, w, _page(cache))
    Bp, Sp = p_inputs.shape[:2]
    Bd = d_inputs.shape[0]
    n_p = Bp * Sp
    x = torch.cat([embed_inputs(model, p_inputs).flatten(0, 1),
                   embed_inputs(model, d_inputs).flatten(0, 1)])
    # (n,) or, under M-RoPE, (n, 3): the last axis is the stream's
    positions = torch.cat([p_positions.flatten(0, 1),
                           d_positions.flatten(0, 1)])
    page = _page(cache)
    rows = None if page is None else attn_mod.pool_rows(
        block_tables, attn_mod.ring_slots(seq_lens, w)[:, None], page)
    d_lens = attn_mod.ring_lens(seq_lens + 1, w)
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
                            q[n_p:], c["k"], c["v"], block_tables, d_lens,
                            f_decode=f_decode, window=w)
            out = torch.cat([o_p.reshape(n_p, -1),
                             o_d.reshape(Bd, -1)]) @ blk.mixer.wo
            aux.append({"k": kp, "v": vp})
        elif blk.kind in XLSTM:
            scan = getattr(xlstm_mod, f"{blk.kind}_forward")
            y_p, state = scan(blk.mixer, cfg, h[:n_p].view(Bp, Sp, -1))
            y_d, d_state = _DECODE_STEPS[blk.kind](
                blk.mixer, cfg, h[n_p:, None], _read_state(c, slots))
            _write_state(c, slots, d_state)
            out = torch.cat([y_p.reshape(n_p, -1), y_d.reshape(Bd, -1)])
            aux.append(state)
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
        x = x + out
        if blk.ffn_kind != "moe":
            x = _ffn_residual(blk, cfg, x)
        else:
            x = torch.cat([
                _ffn_residual(blk, cfg, x[:n_p].view(Bp, Sp, -1),
                              inference=True).flatten(0, 1),
                _ffn_residual(blk, cfg, x[n_p:], dropless=True)])
    last = torch.cat([x[:n_p].view(Bp, Sp, -1)[:, -1], x[n_p:]])
    logits = lm_logits(model, last)[:, None]
    return logits[:Bp], aux, logits[Bp:], cache


def _ref_unified_pd(q_p, k_p, v_p, q_d, k_pages, v_pages, block_tables,
                    seq_lens, *, f_decode, window):
    """``ops.unified_pd``'s layouts over the plain version (f_decode only
    sets which SMs take which tiles first, so the plain version ignores
    it)."""
    o_p, o_d = ref.unified_pd(q_p.transpose(1, 2), k_p.transpose(1, 2),
                              v_p.transpose(1, 2), q_d, k_pages, v_pages,
                              block_tables, seq_lens, window=window)
    return o_p.transpose(1, 2), o_d


def greedy_sample(logits, vocab_size: int):
    """Argmax over the unpadded vocab.  logits (B,1,Vp) -> (B,1) int32."""
    return torch.argmax(logits[..., :vocab_size], dim=-1).to(torch.int32)
