"""Structure-of-arrays pricing: the perfmodel formulas over numpy.

This module is THE formula layer.  The scalar entry points in
``perfmodel.costs`` (``_prefill_cost`` / ``chunk_prefill_cost`` /
``decode_cost``) and ``perfmodel.interference.forecast_phase_times``
are thin N=1 views over the batched functions here, so there is one
formula, not two — and the fleet-facing consumers (``ProjectionPolicy``,
``SloAwareRouter``, the rebalance cost/benefit gate, ``Executor.
price_batch``) price a whole replica fleet in a handful of array ops
per tick instead of per-replica Python.

Bit-identity contract (load-bearing — the golden parity suite and the
fig8–16 smokes pin simulation outputs, and ``bench_hotpath --fleet``
asserts the batched and scalar cluster paths produce identical traces):

  * every elementwise op (``+ - * /``, ``np.minimum``/``np.maximum``/
    ``np.where``, float64 ``**``) is IEEE-754-identical to the CPython
    float op it replaces, so expressions are kept in the scalar code's
    exact association order;
  * reductions NEVER use ``np.sum`` (pairwise summation reassociates
    for n >= 8): ragged per-entry sums accumulate column-by-column in
    the scalar code's left-to-right order, and integer token totals
    use exact int64 sums;
  * where the scalar code does exact *integer* arithmetic before its
    first float conversion (causal attention FLOPs over int sequence
    lengths, KV read bytes over an int context), the batched path does
    the same product in int64 and converts once, at the same point.

Everything here is plain numpy on float64/int64 and restricted to the
jax-transliterable op set (elementwise arithmetic, ``where``, ``clip``-
style min/max, fixed-trip-count loops over *layers*, never over
entries) — the door to on-accelerator pricing with jax_pallas
(ROADMAP item 1).  No Python loops over batch entries anywhere in the
formula paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

# §3.4 memory-subsystem interference (fractional slowdown of the HBM
# term when the other phase is co-resident).  Defined here — the formula
# layer — and re-exported by ``perfmodel.interference`` under the same
# names.
MEM_INTERFERENCE_PREFILL = 0.02
MEM_INTERFERENCE_DECODE = 0.035   # paper: 2-5% avg

_STEP_COST = None


def _step_cost_cls():
    # costs.py imports this module at its own top level, so the scalar
    # StepCost class is resolved lazily (and cached) here
    global _STEP_COST
    if _STEP_COST is None:
        from repro_torch.perfmodel.costs import StepCost
        _STEP_COST = StepCost
    return _STEP_COST


@dataclasses.dataclass(frozen=True)
class StepCostBatch:
    """Array-of-StepCost: one (flops, hbm_bytes, coll_bytes) triple per
    entry, each a float64 ``(n,)`` array.  Entry ``i`` is exactly the
    ``StepCost`` the scalar formulas would have produced for entry
    ``i``'s operating point (see the module docstring's bit-identity
    contract)."""
    flops: np.ndarray
    hbm_bytes: np.ndarray
    coll_bytes: np.ndarray

    def __len__(self) -> int:
        return self.flops.shape[0]

    def item(self, i: int):
        """Entry ``i`` as a scalar ``StepCost``."""
        return _step_cost_cls()(
            float(self.flops[i]), float(self.hbm_bytes[i]),
            float(self.coll_bytes[i]))


def zeros(n: int) -> StepCostBatch:
    return StepCostBatch(np.zeros(n), np.zeros(n), np.zeros(n))


def pack_costs(costs: Sequence[Optional[object]]
               ) -> "tuple[StepCostBatch, np.ndarray]":
    """Pack scalar ``Optional[StepCost]`` entries into a batch plus a
    presence mask.  ``None`` is NOT a zero cost: ``forecast_phase_times``
    applies memory interference to a phase whenever the *other* phase is
    present, even at zero cost — the mask carries that distinction."""
    mask = np.array([c is not None for c in costs], dtype=bool)
    flops = np.array([c.flops if c is not None else 0.0 for c in costs])
    hbm = np.array([c.hbm_bytes if c is not None else 0.0 for c in costs])
    coll = np.array([c.coll_bytes if c is not None else 0.0 for c in costs])
    return StepCostBatch(flops, hbm, coll), mask


# ---------------------------------------------------------------------------
# cost formulas (perfmodel.costs, vectorized)
# ---------------------------------------------------------------------------


def _seq_matrix(seqs) -> np.ndarray:
    """Ragged per-entry sequence lengths as a zero-padded int64 matrix.
    Fast path: the fleet tick and router paths price exactly one
    (backlog) sequence per entry, which maps straight to a column."""
    n = len(seqs)
    first = len(seqs[0]) if n else 0
    if n and all(len(s) == first for s in seqs):
        if first == 0:
            return np.zeros((n, 1), dtype=np.int64)
        return np.asarray(seqs, dtype=np.int64).reshape(n, first)
    width = max((len(s) for s in seqs), default=0)
    mat = np.zeros((n, max(width, 1)), dtype=np.int64)
    for i, s in enumerate(seqs):
        if len(s):
            mat[i, :len(s)] = s
    return mat


def _attn_flops_int(cfg, seq_mat: np.ndarray) -> np.ndarray:
    """Causal attention FLOPs summed over each entry's sequences.

    Mirrors ``sum(_attn_flops(cfg, s, s, True) for s in seq_lens)``:
    the per-sequence product is exact integer arithmetic up to the
    single ``* 0.5`` float conversion, and the per-entry sum runs
    left-to-right (column by column) like Python's ``sum`` — padding
    zeros are exact no-ops on the non-negative partial sums.
    """
    ctx = np.minimum(seq_mat, cfg.sliding_window) if cfg.sliding_window \
        else seq_mat
    prod = 2 * 2 * seq_mat * ctx * cfg.num_heads * cfg.head_dim  # exact i64
    per_seq = prod.astype(np.float64) * 0.5
    per_seq = per_seq * cfg.attn_layer_count
    total = np.zeros(seq_mat.shape[0])
    for k in range(seq_mat.shape[1]):
        total = total + per_seq[:, k]
    return total


def _attn_flops_f(cfg, q_tokens: np.ndarray,
                  ctx_tokens: np.ndarray) -> np.ndarray:
    """Non-causal attention FLOPs for float query/context counts
    (chunked prefill and decode average over the batch)."""
    if cfg.sliding_window:
        ctx_tokens = np.minimum(ctx_tokens, cfg.sliding_window)
    per_layer = 2 * 2 * q_tokens * ctx_tokens * cfg.num_heads * cfg.head_dim
    return per_layer * cfg.attn_layer_count


def _has_ssm(cfg) -> bool:
    # config-static; stashed on the instance like config.py's own
    # derived-property memos (the N=1 views hit this per cache miss)
    v = cfg.__dict__.get("_batch_has_ssm")
    if v is None:
        v = any(m in ("mamba", "mlstm", "slstm") for m in cfg.layer_pattern)
        cfg.__dict__["_batch_has_ssm"] = v
    return v


def _ssm_flops(cfg, tokens: np.ndarray) -> np.ndarray:
    """Selective-scan / xLSTM recurrence FLOPs.  The walk is over the
    *layer pattern* (bounded, config-static) — each layer's term is the
    scalar expression evaluated once and re-added in layer order, which
    reproduces the scalar accumulation bit-for-bit."""
    if not _has_ssm(cfg):
        return np.zeros_like(tokens)
    terms = {}
    for mx in set(cfg.layer_pattern):
        if mx == "mamba":
            m = cfg.mamba
            terms[mx] = 9.0 * tokens * cfg.d_inner * m.d_state
        elif mx == "mlstm":
            x = cfg.xlstm
            din = int(x.proj_factor * cfg.d_model)
            dh = din // x.num_heads
            terms[mx] = 8.0 * tokens * din * dh
        elif mx == "slstm":
            terms[mx] = 10.0 * tokens * cfg.d_model
    total = np.zeros_like(tokens)
    for i in range(cfg.num_layers):
        t = terms.get(cfg.mixer_at(i))
        if t is not None:
            total = total + t
    return total


def _tp_collective_bytes(cfg, tokens: np.ndarray, tp,
                         dtype_bytes: int) -> np.ndarray:
    if not isinstance(tp, np.ndarray):
        # scalar tp (the executor and N=1-view path): same arithmetic on
        # Python floats — IEEE-identical, ~half the ufunc dispatches
        if tp <= 1:
            return np.zeros_like(tokens, dtype=np.float64)
        payload = tokens * cfg.d_model * dtype_bytes
        ring = 2.0 * (tp - 1) / tp
        return 2.0 * cfg.num_layers * payload * ring
    gt1 = tp > 1
    tp_safe = np.where(gt1, tp, 2)
    payload = tokens * cfg.d_model * dtype_bytes
    ring = 2.0 * (tp_safe - 1) / tp_safe
    out = 2.0 * cfg.num_layers * payload * ring
    return np.where(gt1, out, 0.0)


def active_weight_bytes(cfg, tokens, dtype_bytes: int = 2) -> np.ndarray:
    """Vectorized ``costs.active_weight_bytes`` over int64 token counts."""
    tokens = np.asarray(tokens, dtype=np.int64)
    if cfg.moe is None:
        return np.full(tokens.shape, float(cfg.param_count() * dtype_bytes))
    split = cfg.__dict__.get("_batch_moe_split")
    if split is None:
        moe_layers = sum(1 for i in range(cfg.num_layers)
                         if cfg.ffn_at(i) == "moe")
        glu = 3
        expert_params = moe_layers * cfg.moe.num_experts * glu * \
            cfg.d_model * cfg.moe.d_ff_expert
        split = (cfg.param_count() - expert_params, expert_params)
        cfg.__dict__["_batch_moe_split"] = split
    rest, expert_params = split
    p_touch = 1.0 - (1.0 - cfg.moe.top_k / cfg.moe.num_experts) ** tokens
    return (rest + expert_params * np.minimum(1.0, p_touch)) * dtype_bytes


def _kv_read_bytes_f(cfg, context_tokens: np.ndarray,
                     dtype_bytes: int) -> np.ndarray:
    per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    if cfg.sliding_window:
        context_tokens = np.minimum(context_tokens, cfg.sliding_window)
    return per_tok * context_tokens


def _per_chip(coll: np.ndarray, tp) -> np.ndarray:
    """Collective payload per chip: divide by tp (clamped to >= 1)."""
    if not isinstance(tp, np.ndarray):
        return coll / max(tp, 1)
    return coll / np.maximum(tp, 1)


def _mask_cost(nz: np.ndarray, flops, bytes_, coll) -> StepCostBatch:
    if nz.all():          # common case: selecting everything is identity
        return StepCostBatch(flops, bytes_, coll)
    return StepCostBatch(np.where(nz, flops, 0.0),
                         np.where(nz, bytes_, 0.0),
                         np.where(nz, coll, 0.0))


def prefill_cost(cfg, seqs: Sequence[Sequence[int]], tp=1,
                 dtype_bytes: int = 2) -> StepCostBatch:
    """One prefill step per entry over whole prompts.  ``seqs[i]`` is
    entry ``i``'s prompt-length tuple; ``tp`` is an int or per-entry
    int array (the executor passes chips as tp)."""
    seq_mat = _seq_matrix(seqs)
    if isinstance(tp, (list, tuple, np.ndarray)):
        tp = np.asarray(tp, dtype=np.int64)
    t_int = seq_mat.sum(axis=1)          # exact int64 token totals
    t = t_int.astype(np.float64)
    nz = t_int != 0
    n_active = cfg.active_param_count()
    flops = 2.0 * n_active * t
    if cfg.attn_layer_count:
        flops = flops + _attn_flops_int(cfg, seq_mat)
    else:
        flops = flops + 0.0
    if _has_ssm(cfg):
        flops = flops + _ssm_flops(cfg, t)
    bytes_ = active_weight_bytes(cfg, t_int, dtype_bytes)
    bytes_ = bytes_ + 2.0 * t * cfg.kv_bytes_per_token(dtype_bytes)
    bytes_ = bytes_ + 4.0 * t * cfg.d_model * dtype_bytes
    coll = _per_chip(_tp_collective_bytes(cfg, t, tp, dtype_bytes), tp)
    return _mask_cost(nz, flops, bytes_, coll)


def chunk_prefill_cost(cfg, chunk_tokens, ctx_so_far, tp=1,
                       dtype_bytes: int = 2) -> StepCostBatch:
    """One chunk of a chunked prefill per entry: ``chunk_tokens[i]``
    queries attending to ``ctx_so_far[i] + chunk/2`` keys on average."""
    chunk = np.asarray(chunk_tokens, dtype=np.int64)
    ctx_i = np.asarray(ctx_so_far, dtype=np.int64)
    if isinstance(tp, (list, tuple, np.ndarray)):
        tp = np.asarray(tp, dtype=np.int64)
    t = chunk.astype(np.float64)
    n_active = cfg.active_param_count()
    flops = 2.0 * n_active * t
    flops = flops + _attn_flops_f(cfg, t, ctx_i + t / 2)
    if _has_ssm(cfg):
        flops = flops + _ssm_flops(cfg, t)
    bytes_ = active_weight_bytes(cfg, chunk, dtype_bytes)
    # KV re-read of the whole context so far: exact integer product,
    # converted at the scalar code's ``* 1.0``
    ctx_clip = np.minimum(ctx_i, cfg.sliding_window) if cfg.sliding_window \
        else ctx_i
    bytes_ = bytes_ + cfg.kv_bytes_per_token(dtype_bytes) * ctx_clip * 1.0
    bytes_ = bytes_ + 2.0 * t * cfg.kv_bytes_per_token(dtype_bytes)
    bytes_ = bytes_ + 4.0 * t * cfg.d_model * dtype_bytes
    coll = _per_chip(_tp_collective_bytes(cfg, t, tp, dtype_bytes), tp)
    return StepCostBatch(flops, bytes_, coll)


def decode_cost(cfg, batch, ctx_tokens_total, tp=1,
                dtype_bytes: int = 2) -> StepCostBatch:
    """One decode iteration per entry: ``batch[i]`` single-token queries
    over ``ctx_tokens_total[i]`` live context tokens."""
    batch = np.asarray(batch, dtype=np.int64)
    ctx = np.asarray(ctx_tokens_total, dtype=np.float64)
    if isinstance(tp, (list, tuple, np.ndarray)):
        tp = np.asarray(tp, dtype=np.int64)
    nz = batch != 0
    all_nz = bool(nz.all())
    b = batch.astype(np.float64)
    b_safe = b if all_nz else np.where(nz, b, 1.0)
    ctx_per = ctx / b_safe
    n_active = cfg.active_param_count()
    flops = 2.0 * n_active * b
    flops = flops + _attn_flops_f(cfg, b, ctx_per)
    if _has_ssm(cfg):
        flops = flops + _ssm_flops(cfg, b)
    bytes_ = active_weight_bytes(cfg, batch, dtype_bytes)
    bytes_ = bytes_ + _kv_read_bytes_f(cfg, ctx_per, dtype_bytes) * b
    bytes_ = bytes_ + b * cfg.state_bytes_per_seq(dtype_bytes)
    bytes_ = bytes_ + 4.0 * b * cfg.d_model * dtype_bytes
    coll = _per_chip(_tp_collective_bytes(cfg, b, tp, dtype_bytes), tp)
    if all_nz:
        return StepCostBatch(flops, bytes_, coll)
    return _mask_cost(nz, flops, bytes_, coll)


# ---------------------------------------------------------------------------
# interference / forecast (perfmodel.interference, vectorized)
# ---------------------------------------------------------------------------


def phase_time(cost: StepCostBatch, hw, chips, f=1.0,
               mem_interference=0.0, bw_share=1.0) -> np.ndarray:
    """Vectorized ``interference.phase_time``: per-entry duration under
    per-entry issue-capacity fractions / interference terms."""
    if isinstance(chips, (list, tuple, np.ndarray)):
        chips = np.asarray(chips, dtype=np.int64)
    f_c = np.maximum(f, 1e-3) if isinstance(f, np.ndarray) \
        else max(f, 1e-3)
    zero = (cost.flops == 0) & (cost.hbm_bytes == 0)
    t_compute = cost.flops / (chips * hw.peak_flops * f_c)
    t_mem = cost.hbm_bytes * (1.0 + mem_interference) / \
        (chips * hw.hbm_bw * bw_share)
    t_coll = cost.coll_bytes / hw.ici_bw
    t = np.maximum(t_compute, t_mem) + t_coll + hw.launch_overhead_s
    return np.where(zero, 0.0, t)


def compute_utilization(cost: StepCostBatch, hw, chips) -> np.ndarray:
    """Vectorized ``interference.compute_utilization``."""
    if isinstance(chips, (list, tuple, np.ndarray)):
        chips = np.asarray(chips, dtype=np.int64)
    t_c = cost.flops / (chips * hw.peak_flops)
    t_m = cost.hbm_bytes / (chips * hw.hbm_bw)
    t_coll = cost.coll_bytes / hw.ici_bw
    denom = np.maximum(t_m, t_c) + t_coll
    pos = denom > 0
    u = np.minimum(1.0, t_c / np.where(pos, denom, 1.0))
    return np.where(pos, u, 0.0)


def forecast_phase_times(p_cost: StepCostBatch, d_cost: StepCostBatch,
                         hw, chips_p, chips_d, *,
                         colocated, p_mask=None, d_mask=None,
                         f_decode=None) -> "tuple[np.ndarray, np.ndarray]":
    """Vectorized ``interference.forecast_phase_times``: projected
    ``(t_prefill, t_decode)`` arrays for a fleet of replica load points.

    ``p_mask`` / ``d_mask`` mark which entries carry a phase at all
    (the scalar API's ``None`` costs — absence is not zero cost, see
    ``pack_costs``).  ``f_decode`` is a float array where NaN selects
    overallocation (the scalar API's ``None``) and a finite value the
    distinct split; ``colocated`` is a per-entry bool array.  Every
    branch of the scalar overlap model is evaluated elementwise and
    selected with ``np.where``, so each entry gets bit-identical math
    to the scalar path it replaces.
    """
    n = len(p_cost)
    # scalar knobs stay scalar — every op below broadcasts, and the
    # result shape (n,) is pinned by the cost arrays themselves
    if np.ndim(chips_p):
        chips_p = np.broadcast_to(np.asarray(chips_p, dtype=np.int64), (n,))
    if np.ndim(chips_d):
        chips_d = np.broadcast_to(np.asarray(chips_d, dtype=np.int64), (n,))
    if np.ndim(colocated):
        colocated = np.broadcast_to(np.asarray(colocated, dtype=bool), (n,))
    else:
        colocated = bool(colocated)
    pm = True if p_mask is None else p_mask
    dm = True if d_mask is None else d_mask
    if np.ndim(pm) == 0:
        pm = bool(pm)
    if np.ndim(dm) == 0:
        dm = bool(dm)
    if f_decode is None:
        f_decode = np.nan
    elif np.ndim(f_decode):
        f_decode = np.broadcast_to(
            np.asarray(f_decode, dtype=np.float64), (n,))

    with np.errstate(invalid="ignore", divide="ignore"):
        # solo durations (also the non-colocated per-pool path)
        t_p_solo = phase_time(p_cost, hw, chips_p)
        t_d_solo_p = phase_time(d_cost, hw, chips_p)   # colocated, p absent
        t_d_solo_d = phase_time(d_cost, hw, chips_d)   # split decode pool
        # overallocation: shares proportional to standalone demand
        u_d = compute_utilization(d_cost, hw, chips_p)
        u_p = compute_utilization(p_cost, hw, chips_p)
        share_d = u_d / np.maximum(u_d + u_p, 1e-9)
        share_p = 1.0 - share_d
        t_d_ov = phase_time(d_cost, hw, chips_p,
                            f=np.maximum(share_d, 1e-3),
                            mem_interference=MEM_INTERFERENCE_DECODE)
        t_p_ov = phase_time(p_cost, hw, chips_p,
                            f=np.maximum(share_p, 1e-3),
                            mem_interference=MEM_INTERFERENCE_PREFILL)
        # distinct split (NaN f_decode entries resolve to the overalloc
        # branch below; their NaNs are selected away)
        f_d = np.minimum(np.maximum(f_decode, 0.05), 0.95)
        f_p = 1.0 - f_d
        t_d_di = phase_time(d_cost, hw, chips_p, f=f_d,
                            mem_interference=MEM_INTERFERENCE_DECODE)
        t_p_di = phase_time(p_cost, hw, chips_p, f=f_p,
                            mem_interference=MEM_INTERFERENCE_PREFILL)

    both = pm & dm
    distinct = both & ~np.isnan(f_decode)
    coupled_p = np.where(distinct, t_p_di, t_p_ov)
    coupled_d = np.where(distinct, t_d_di, t_d_ov)
    t_p = np.where(colocated & both, coupled_p,
                   np.where(pm, t_p_solo, 0.0))
    t_d = np.where(colocated,
                   np.where(both, coupled_d,
                            np.where(dm, t_d_solo_p, 0.0)),
                   np.where(dm, t_d_solo_d, 0.0))
    return t_p, t_d
