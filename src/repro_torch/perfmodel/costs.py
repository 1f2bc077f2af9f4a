"""Analytic per-step FLOP / HBM-byte / collective-byte counts.

These drive the discrete-event simulator's step durations (the container
has no TPU).  The same three terms are independently derived from the
*compiled* HLO by launch/roofline.py for EXPERIMENTS.md §Roofline; tests
assert the analytic and HLO-derived FLOP counts agree within tolerance,
which keeps the simulator honest.

All pricing functions are pure in their arguments, so the step-cost
entry points are memoized (``functools.lru_cache``) on their exact
operating points: the projection autoscaler re-prices identical
``LoadSnapshot``s every tick, the SLO-aware router re-prices repeated
(backlog, batch) pairs per arrival, and hybrid chunk boundaries land on
quantized (chunk, ctx) points — all of which now hit the cache instead
of re-walking the layer pattern.  Cached values are the *same* objects,
so memoization can never change simulator behavior, only its cost.
All caches carry an explicit ``maxsize`` so a fleet-scale trace cannot
grow them without bound; ``cache_stats()`` surfaces hit/miss counters
(bench_hotpath reports them).

The formula bodies live in ``perfmodel.batch`` (the structure-of-arrays
layer the fleet paths price whole replica sets through); the cached
entry points below are N=1 views over it, so there is one formula, not
two, and the batched and scalar paths are bit-identical by
construction.

Conventions:
  * matmul FLOPs = 2*M*N*K;   causal attention scores halved.
  * weights are streamed from HBM once per step (valid for serving batch
    sizes; prefill is compute-bound anyway so its byte term rarely binds).
  * TP collectives: 2 all-reduces per block over the activation slab,
    ring cost 2*(tp-1)/tp of the payload per chip.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

from repro_torch.perfmodel import batch as _batch


@dataclasses.dataclass(frozen=True)
class StepCost:
    flops: float          # total FLOPs for the step (all chips)
    hbm_bytes: float      # HBM traffic per chip-group, summed over chips
    coll_bytes: float     # per-chip collective payload bytes

    def __add__(self, other: "StepCost") -> "StepCost":
        return StepCost(self.flops + other.flops,
                        self.hbm_bytes + other.hbm_bytes,
                        self.coll_bytes + other.coll_bytes)

    def scale(self, k: float) -> "StepCost":
        return StepCost(self.flops * k, self.hbm_bytes * k,
                        self.coll_bytes * k)


ZERO_COST = StepCost(0.0, 0.0, 0.0)


def model_flops_per_token(cfg) -> float:
    """6*N_active per trained token; 2*N_active per inferred token is
    obtained by scaling."""
    return 6.0 * cfg.active_param_count()


# bounded (was maxsize=None): a handful of (cfg, dtype) pairs exist per
# process, but an unbounded cache is a fleet-scale liability on
# principle — every perfmodel cache now carries an explicit ceiling
@functools.lru_cache(maxsize=1024)
def weight_bytes(cfg, dtype_bytes: int = 2) -> float:
    """Bytes of weights streamed per step (MoE: only routed experts are
    read in expectation when the batch is small; we charge min(full,
    per-token-active * tokens) at the call sites)."""
    return cfg.param_count() * dtype_bytes


@functools.lru_cache(maxsize=65536)
def active_weight_bytes(cfg, tokens: int, dtype_bytes: int = 2) -> float:
    """Expected weight bytes touched by `tokens` tokens in one step.

    Dense: all weights.  MoE: each token touches top_k experts; with E
    experts the expected fraction of expert weights touched is
    1-(1-k/E)^tokens, capped at 1.  (N=1 view of the batched formula.)
    """
    return float(_batch.active_weight_bytes(cfg, (tokens,), dtype_bytes)[0])


def kv_read_bytes(cfg, context_tokens: float, dtype_bytes: int = 2) -> float:
    """KV bytes read for one query token against `context_tokens` cache."""
    per_tok = cfg.kv_bytes_per_token(dtype_bytes)
    if cfg.sliding_window:
        context_tokens = min(context_tokens, cfg.sliding_window)
    return per_tok * context_tokens


def prefill_cost(cfg, seq_lens: Sequence[int], tp: int = 1,
                 dtype_bytes: int = 2) -> StepCost:
    """One prefill step over whole prompts (RAPID: no chunking)."""
    return _prefill_cost(cfg, tuple(seq_lens), tp, dtype_bytes)


@functools.lru_cache(maxsize=65536)
def _prefill_cost(cfg, seq_lens: tuple, tp: int,
                  dtype_bytes: int) -> StepCost:
    if not any(seq_lens):
        return ZERO_COST
    return _batch.prefill_cost(cfg, (seq_lens,), tp, dtype_bytes).item(0)


@functools.lru_cache(maxsize=65536)
def chunk_prefill_cost(cfg, chunk_tokens: int, ctx_so_far: int,
                       tp: int = 1, dtype_bytes: int = 2) -> StepCost:
    """One chunk of a chunked prefill: chunk_tokens queries attend to
    (ctx_so_far + chunk) keys — the repeated KV re-read is the chunking
    overhead the paper quantifies in §3.1."""
    return _batch.chunk_prefill_cost(cfg, (chunk_tokens,), (ctx_so_far,),
                                     tp, dtype_bytes).item(0)


@functools.lru_cache(maxsize=65536)
def decode_cost(cfg, batch: int, ctx_tokens_total: float, tp: int = 1,
                dtype_bytes: int = 2) -> StepCost:
    """One decode iteration: `batch` single-token queries, total live
    context of ctx_tokens_total across the batch."""
    if batch == 0:
        return ZERO_COST
    return _batch.decode_cost(cfg, (batch,), (ctx_tokens_total,),
                              tp, dtype_bytes).item(0)


def kv_transfer_bytes(cfg, prompt_len: int, dtype_bytes: int = 2) -> float:
    """Disaggregated serving: KV moved prefill->decode instance."""
    return float(prompt_len) * cfg.kv_bytes_per_token(dtype_bytes)


def kv_migration_seconds(cfg, context_tokens: int, link_gbps: float,
                         dtype_bytes: int = 2) -> float:
    """Cross-replica preemption/migration: the victim's live context KV
    shipped over the inter-replica link before it can re-enqueue on the
    destination (the cluster rebalancer charges this on every move of a
    running request)."""
    return kv_transfer_bytes(cfg, context_tokens, dtype_bytes) / \
        max(link_gbps, 1e-9) / 1e9


def cache_stats() -> dict:
    """hits/misses/size for every memoized perfmodel entry point —
    bench_hotpath surfaces the per-run deltas so cache behavior stays
    visible at fleet scale (a miss now pays the N=1 batch-layer view)."""
    from repro_torch.perfmodel import interference as _interference
    fns = {
        "prefill_cost": _prefill_cost,
        "chunk_prefill_cost": chunk_prefill_cost,
        "decode_cost": decode_cost,
        "active_weight_bytes": active_weight_bytes,
        "weight_bytes": weight_bytes,
        "forecast_phase_times": _interference.forecast_phase_times,
    }
    return {name: fn.cache_info()._asdict() for name, fn in fns.items()}
