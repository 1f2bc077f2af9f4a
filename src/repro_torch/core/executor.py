"""Step execution backends for the generic serving engine (API v2).

An ``Executor`` prices the steps a ``Scheduler`` decided to launch: it
turns a ``StepPlan`` into per-lane durations (and the ``StepCost``
objects the interference model needs for overlapped steps).  The default
``PerfModelExecutor`` wraps ``perfmodel.costs`` + ``perfmodel.
interference`` — engine control flow is real, only durations are
modelled (DESIGN.md §6).

The split exists so a *real-kernel* executor can drop in behind the same
interface: ``KernelExecutor`` below runs each plan's launches through the
port's model and CUDA kernels at once (``unified_pd`` for colocated
plans, ``flash_prefill`` and ``paged_attention`` for launches alone, the
paged, offset ``flash_prefill`` and ``paged_attention`` for a hybrid
step; a split-pool plan's lanes one after the other over two pools, with
a measured device copy for each KV transfer) and reports measured
durations.  The other classes are copies of
``repro/core/executor.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.config import OneCardServeConfig
from repro_torch.core.events import FinishedEvent, PhaseEvent, RejectedEvent
from repro_torch.core.scheduler import SchedView, StepPlan
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ring_slots, ring_table
from repro_torch.models.decode_graph import DecodeGraphs, table_width
from repro_torch.perfmodel import batch as B
from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel import interference as I
from repro_torch.perfmodel.hw import H100, TPU_V5E, HardwareSpec


@dataclasses.dataclass(frozen=True)
class LaunchOutcome:
    """One priced lane step: wall-clock duration (host overhead included,
    Fig 6) plus the device cost the interference model consumes while
    the step is in flight."""
    duration_s: float
    cost: C.StepCost


@dataclasses.dataclass(frozen=True)
class StepOutputs:
    """Durations for every launch in a ``StepPlan`` (None = not in plan)."""
    prefill: Optional[LaunchOutcome] = None
    decode: Optional[LaunchOutcome] = None
    hybrid: Optional[LaunchOutcome] = None


class Executor:
    """Protocol: price a StepPlan.  Implementations must price launches
    in plan order — prefill before decode — so a decode launched in the
    same plan sees the new prefill in flight (colocated interference)."""

    def execute(self, plan: StepPlan, view: SchedView) -> StepOutputs:
        raise NotImplementedError

    def price_batch(self, plans: Sequence[StepPlan],
                    views: Sequence[SchedView]) -> "list[StepOutputs]":
        """Price many (plan, view) pairs in one call.  The pairs must be
        causally independent (different replicas, or speculative what-if
        pricing) — implementations may reorder the underlying cost
        evaluations.  Default: the sequential scalar path."""
        return [self.execute(p, v) for p, v in zip(plans, views)]

    def transfer_seconds(self, r, serve) -> float:
        """Disagg KV-transfer time for one request (ICI on the critical
        path, §3.2.1)."""
        raise NotImplementedError


class PerfModelExecutor(Executor):
    """Default executor: calibrated TPU-v5e perfmodel durations.

    ``colocated`` selects the paper's intra-GPU interference coupling:
    when prefill and decode share chips, an overlapped step's duration
    comes from ``interference.overlapped_times`` under the decode lane's
    resource split ``f_decode``; split-pool (disagg) lanes run at their
    own ``phase_time``.
    """

    def __init__(self, cfg, hw: HardwareSpec = TPU_V5E,
                 colocated: bool = True,
                 lane_chips: Optional[Dict[str, int]] = None):
        self.cfg = cfg
        self.hw = hw
        self.colocated = colocated
        self.lane_chips = lane_chips or {}

    def _chips(self, lane: str, serve) -> int:
        return self.lane_chips.get(lane, serve.chips)

    # -- host-side scheduling overhead (Fig 6a vs 6b) -----------------------
    def _step_time(self, device_s: float, serve) -> float:
        cpu = serve.scheduler_overhead_ms / 1e3
        if serve.async_scheduling:
            return max(device_s, cpu)
        return device_s + cpu

    def execute(self, plan: StepPlan, view: SchedView) -> StepOutputs:
        return self._assemble(plan, view, C.prefill_cost,
                              C.chunk_prefill_cost, C.decode_cost)

    def price_batch(self, plans: Sequence[StepPlan],
                    views: Sequence[SchedView]) -> "list[StepOutputs]":
        """Batched pricing: every cost any plan needs is collected,
        deduplicated by operating point, and priced through the
        ``perfmodel.batch`` array layer in one call per cost kind — the
        per-call ``lru_cache`` memoization of the scalar path becomes
        vectorized key dedup here.  Control flow is ``_assemble`` both
        times (a recording pass, then a lookup pass), so the batched and
        scalar paths cannot drift; the costs themselves are bit-identical
        by the batch layer's contract."""
        pre_k: dict = {}
        chk_k: dict = {}
        dec_k: dict = {}

        def rec_pre(cfg, seq_lens, tp):
            pre_k[(tuple(seq_lens), tp)] = None
            return C.ZERO_COST

        def rec_chk(cfg, chunk_tokens, ctx_so_far, tp):
            chk_k[(chunk_tokens, ctx_so_far, tp)] = None
            return C.ZERO_COST

        def rec_dec(cfg, bs, ctx_total, tp):
            dec_k[(bs, ctx_total, tp)] = None
            return C.ZERO_COST

        for p, v in zip(plans, views):
            self._assemble(p, v, rec_pre, rec_chk, rec_dec)

        if pre_k:
            ks = list(pre_k)
            got = B.prefill_cost(self.cfg, [k[0] for k in ks],
                                 np.array([k[1] for k in ks]))
            for i, k in enumerate(ks):
                pre_k[k] = got.item(i) if any(k[0]) else C.ZERO_COST
        if chk_k:
            ks = list(chk_k)
            got = B.chunk_prefill_cost(
                self.cfg, [k[0] for k in ks], [k[1] for k in ks],
                np.array([k[2] for k in ks]))
            for i, k in enumerate(ks):
                chk_k[k] = got.item(i)
        if dec_k:
            ks = list(dec_k)
            got = B.decode_cost(self.cfg, [k[0] for k in ks],
                                [k[1] for k in ks],
                                np.array([k[2] for k in ks]))
            for i, k in enumerate(ks):
                dec_k[k] = got.item(i) if k[0] else C.ZERO_COST

        def use_pre(cfg, seq_lens, tp):
            return pre_k[(tuple(seq_lens), tp)]

        def use_chk(cfg, chunk_tokens, ctx_so_far, tp):
            return chk_k[(chunk_tokens, ctx_so_far, tp)]

        def use_dec(cfg, bs, ctx_total, tp):
            return dec_k[(bs, ctx_total, tp)]

        return [self._assemble(p, v, use_pre, use_chk, use_dec)
                for p, v in zip(plans, views)]

    def _assemble(self, plan: StepPlan, view: SchedView, prefill_cost,
                  chunk_prefill_cost, decode_cost) -> StepOutputs:
        """The one pricing control flow: which costs a plan needs and how
        they couple through the interference model.  ``execute`` injects
        the memoized scalar pricers; ``price_batch`` injects recorders,
        then lookups into the batched results."""
        serve = view.serve
        p_out = d_out = h_out = None
        if plan.prefill is not None:
            chips = self._chips("prefill", serve)
            batch = plan.prefill.batch
            if any(r.cached_prefix_len for r in batch):
                # session prefix skip: each request only prefills its new
                # suffix, attending over the cached prefix as context
                cost = C.ZERO_COST
                for r in batch:
                    cost = cost + chunk_prefill_cost(
                        self.cfg, r.prefill_tokens_needed,
                        r.cached_prefix_len, chips)
            else:
                cost = prefill_cost(
                    self.cfg, [r.prompt_len for r in batch], chips)
            dlane = view.lanes.get("decode", None)
            if self.colocated and dlane is not None and dlane.busy and \
                    dlane.cost is not None:
                dur = I.overlapped_times(cost, dlane.cost, self.hw, chips,
                                         f_decode=dlane.f_decode).t_prefill
            else:
                dur = I.phase_time(cost, self.hw, chips)
            p_out = LaunchOutcome(self._step_time(dur, serve), cost)
        if plan.decode is not None:
            chips = self._chips("decode", serve)
            # running batch context from the queue's incremental counter
            # (identical integer sum, without the O(batch) walk)
            bs = len(view.running) + len(plan.decode.joins)
            ctx_total = float(view.running.ctx_tokens +
                              sum(r.context_len for r in plan.decode.joins))
            cost = decode_cost(self.cfg, bs, ctx_total, chips)
            if p_out is not None:
                p_cost = p_out.cost          # launched in this same plan
            else:
                plane = view.lanes.get("prefill", None)
                p_cost = plane.cost if plane is not None and plane.busy \
                    else None
            if self.colocated and p_cost is not None:
                dur = I.overlapped_times(p_cost, cost, self.hw, chips,
                                         f_decode=plan.decode.f_decode
                                         ).t_decode
            else:
                dur = I.phase_time(cost, self.hw, chips)
            d_out = LaunchOutcome(self._step_time(dur, serve), cost)
        if plan.hybrid is not None:
            chips = self._chips("step", serve)
            cost = C.ZERO_COST
            for r, take in plan.hybrid.chunks:
                cost = cost + chunk_prefill_cost(
                    self.cfg, take,
                    r.cached_prefix_len + r.prefill_tokens_done, chips)
            bs = len(view.running)
            if bs:
                ctx_total = float(view.running.ctx_tokens)
                cost = cost + decode_cost(self.cfg, bs, ctx_total, chips)
            dur = I.phase_time(cost, self.hw, chips)
            h_out = LaunchOutcome(self._step_time(dur, serve), cost)
        return StepOutputs(prefill=p_out, decode=d_out, hybrid=h_out)

    def transfer_seconds(self, r, serve) -> float:
        return C.kv_transfer_bytes(self.cfg, r.prompt_len) / \
            (serve.kv_transfer_gbps * 1e9)


def check_split_pools(cfg) -> None:
    """Raise for a model whose split-pool (disagg) serving is not run on
    the card: recurrent layers, whose state the decode side's first-token
    recompute would advance twice and whose rows would need a transfer of
    their own, and a sliding window, whose ring under a transfer is
    untried (ROADMAP A11)."""
    recurrent = sorted(set(cfg.layer_pattern) & {"mamba", "mlstm", "slstm"})
    if recurrent:
        raise NotImplementedError(
            f"{cfg.name}: split-pool (disagg) serving of recurrent layers "
            f"({', '.join(recurrent)}) is ROADMAP A11: the decode side's "
            f"first-token recompute would apply the last token to the state "
            f"a second time, and the state row would need a transfer of its "
            f"own")
    if cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: split-pool (disagg) serving under a sliding window "
            f"is ROADMAP A11: a transfer of its ring is untried")


class KernelExecutor(Executor):
    """Run a colocated engine's plans on the device, through the port's
    model and CUDA kernels, and report measured durations.

    Each launch runs when the engine applies its plan: a plan with both
    a prefill and a decode runs ONE ``fused_pd_forward`` (one
    ``unified_pd`` launch per attention layer) with the decode launch's
    ``f_decode``; a prefill alone runs ``forward`` (``flash_prefill``), a
    decode alone ``decode_forward`` (``paged_attention``).  Prompts are
    prefilled one at a time and unpadded (padding would run the Mamba
    scan over the padding): in a colocated plan the first prompt shares
    the fused launch and the rest follow it.  ``f_decode = None`` (the
    ARM's overallocation: both phases claim the whole chip) is passed as
    1.0, where every CTA takes decode tiles first.  A decode alone goes
    through ``DecodeGraphs``: on the card its step is captured once per
    (batch size, table width) and replayed, as the reference jits its
    decode step; block tables are padded to ``table_width``.

    Durations.  ``duration_s`` is wall-clock from the start of a launch
    until its sampled tokens reach the host, host work included and the
    modelled scheduler overhead not added.  The card runs one launch at
    a time, so ``busy_until`` keeps the engine time at which it finishes
    its last one: a launch applied at ``now`` returns
    ``max(0, busy_until - now) + measured``, and the engine's clock never
    shows two launches overlapping that did not.  The decode lane of a
    fused plan ends with the fused launch, its prefill lane after the
    remaining prompts.  Each ``cost`` is the perfmodel's ``StepCost`` for
    the same launch (``PerfModelExecutor`` on ``hw``): the engine and the
    ARM still read costs.

    The page-boundary write.  The engine appends a decoded token's KV
    slot only after the step that wrote it (``Engine._decode_done``), so
    a request whose token count sits on a page boundary writes into a
    block not yet handed out.  The pool holds one spare page per decode
    slot after the engine's blocks; such a request's block table ends in
    its slot's spare for that step, and the spare is copied into the
    block the engine appends before the next decode step.  Under a
    sliding window W the engine still hands out blocks for the whole
    context, and a request's block table is the ring of its first W /
    page blocks (``ring_table``): a spare page serves only positions
    below W, and is copied into the ring's block of its position; from W
    on the ring slot lies in a block the request already holds.

    Tokens.  ``prompts`` maps a request id to its prompt tokens and is
    read at each prefill, so a front end may fill it as requests arrive;
    ``tokens`` (default: a dict of its own) maps it to the tokens it has
    generated.  Workers share both, so a request that leaves one worker
    (a failover clone keeps its rid; a paused or migrated request keeps
    its ``tokens_generated`` too) is prefilled again on another.

    The re-prefill of a preempted request.  An evicted request (KV
    pressure, a gateway's backpressure pause, a cancel) comes back with
    its ``tokens_generated``; recompute on resume prefills its prompt and
    those tokens again from position 0, and the next greedy token is its
    token ``tokens_generated``.  ``reprefills_context`` tells the engine
    so: its scheduler admits, and it allocates, such a request for its
    ``context_len`` (``Scheduler.kv_tokens``), not its prompt alone.  A
    recurrent row starts again from zero state, as any prefill does.

    Recurrent state rows (Mamba, mLSTM, sLSTM).  A request holds a row
    from its prefill until it leaves the engine: its ``FinishedEvent``,
    or the ``preempted`` phase of an eviction (also while it waits to
    join the decode batch, which ``max_batch_slots`` does not bound).
    ``state_rows`` defaults to the engine's KV block count, which a
    request holding a row holds one of: free for a model without
    recurrent layers, whose rows hold nothing; a model with them passes
    fewer (an xLSTM-125M row is 19 MB).  Running out of rows raises, and
    a live row is never overwritten.

    Hybrid plans (``HybridEngine``, the chunked-prefill baseline).  A
    step with prompt chunks runs ONE ``hybrid_forward``: the chunks at
    their offsets (``prefill_tokens_done``; the paged, offset prefill over
    the pool) and the running decodes together, and its outcome is the
    step's ``hybrid`` lane.  A request's blocks are allocated whole at
    admission, so its block table is known from its first chunk; its
    state row is taken at its first chunk and carries a Mamba layer's
    state from chunk to chunk.  Its last chunk also carries the tokens a
    resumed request had generated (the scheduler chunks its prompt alone,
    ``prefill_tokens_needed``; its allocation holds its context), and the
    greedy token of that chunk's last position is its next one.  A step
    with decodes and no chunk goes through ``DecodeGraphs`` as a decode
    alone.  A sliding window and xLSTM layers are not chunked (ROADMAP
    A5), and a hybrid plan of such a model raises.

    Split pools (``DisaggEngine``, the disaggregated baseline) on one
    card (``OneCardServeConfig``).  ``bind`` allocates the decode pool as
    above and a second ``tf.init_cache``, the prefill pool, at ``kv_p``'s
    block count with no spare page; the model and its one copy of the
    weights serve both lanes.  The lanes
    take turns on the card, as every launch does (``busy_until``): a
    plan's decode launch runs first, then its prompts, one at a time,
    each into the prefill pool through ``kv_p``'s block table (its
    prompt, or a resumed request's context).  A prefill emits no token:
    the decode side recomputes the first one, as vLLM v1 does.  When a
    prefill is done the engine calls ``transfer_seconds``: the request's
    pages are copied, layer by layer, into staging while the engine still
    holds them (it frees them when the transfer arrives, and an
    ``AdmitRetry`` may keep the request from the decode pool for many
    steps while new prefills reuse them).  The staging is pages of the
    prefill pool itself, taken from ``kv_p``'s allocator: the scheduler
    admitted the prefill with room for them, and holds later prefills
    back while they stay staged, so staging needs no memory beyond the
    two pools and waits with the prefills instead of outgrowing the card.
    ``staged`` maps a request to its staging blocks.  The copy is
    timed with CUDA events after a synchronize, and the engine's clock
    is charged that time where the perfmodel charges
    ``kv_transfer_bytes`` over ``kv_transfer_gbps``.  At the request's
    first decode step (its join) the staging is copied into the blocks
    the decode pool gave it, inside that launch, and released after it.
    The join's step is an ordinary decode whose input is the context's
    last token at position ``context_len - 1``: it writes that
    position's K/V again and emits token ``tokens_generated``.  The
    decode pool's allocation holds the position each step writes (the
    engine admits a transfer for its whole context), so no step of a
    split-pool engine uses a spare page.  Staging is released at the
    join, and at a request's rejection, finish or preemption.  A model
    with recurrent layers (the recompute would apply the last token to
    the state twice, and the row would need a transfer of its own) or a
    sliding window (its ring under a transfer is untried) is refused at
    ``bind`` (ROADMAP A11).  Concurrent lanes, each with a share of the
    SMs, are ROADMAP A4.

    What it does not run raises ``NotImplementedError``: a KV transfer
    of a colocated engine, what-if ``price_batch`` pricing (it would run
    the model), and a prefill or chunk after a cached prefix (a
    session's, or a gateway checkpoint's restore; a split-pool prefill
    drops the claim, as the engine does).

    ``bind(engine)`` allocates the pools at the engine's KV block counts
    and subscribes to its events; ``log`` holds one record per launch,
    ``graph`` saying how a decode launch ran (``DecodeGraphs.ran``:
    "capture", "replay" or "eager"), ``plan`` which ``execute`` call it
    belongs to, ``resumed`` how many generated tokens a prefill ran over
    after the prompt, and ``host_end`` the host's ``time.perf_counter()``
    when its tokens reached the host; and one record per KV transfer
    (``kind`` "transfer": its rid, tokens, pages, ``bytes`` staged,
    ``ms`` measured and charged, ``priced_ms`` the perfmodel's charge,
    ``wall_s`` the host's seconds with the synchronize).
    """

    reprefills_context = True

    def __init__(self, model, *, prompts, serve, device,
                 hw: HardwareSpec = H100, state_rows: Optional[int] = None,
                 tokens: Optional[Dict[int, List[int]]] = None):
        self.model = model
        self.cfg = model.cfg
        self.serve = serve
        self.device = torch.device(device)
        if model.tok.device.type != self.device.type:
            raise ValueError(f"model on {model.tok.device}, executor on "
                             f"{self.device}")
        self.prompts = prompts
        self.tokens: Dict[int, List[int]] = {} if tokens is None else tokens
        self.state_rows = state_rows
        self._free_rows: List[int] = []
        self._row_of: Dict[int, int] = {}
        # rid -> (spare block, the position whose K/V it holds)
        self._spare: Dict[int, tuple] = {}
        self.cache = None
        # split pools: the prefill pool and its manager, and per request
        # in transfer the prefill-pool blocks its pages are staged in
        self.cache_p = self.kv_p = None
        self.staged: Dict[int, List[int]] = {}
        self._page_bytes = 0
        self._loop = None
        self.graphs: Optional[DecodeGraphs] = None
        self.num_blocks = 0
        self.busy_until = 0.0
        self._t = 0.0
        self._plans = 0
        self.log: List[dict] = []
        self._priced = PerfModelExecutor(self.cfg, hw, colocated=True)

    # -- set-up ---------------------------------------------------------------
    def bind(self, engine) -> None:
        """Allocate the paged pool: the engine's block count, whole, plus
        one spare page per decode slot, and the state rows; for a
        split-pool engine also the prefill pool at ``kv_p``'s block
        count; and take back a request's row, spare page and staging when
        it leaves the engine."""
        sched = engine.scheduler
        if not sched.colocated:
            check_split_pools(self.cfg)
            if not isinstance(engine.serve, OneCardServeConfig):
                raise NotImplementedError(
                    "KernelExecutor runs split pools on one card "
                    "(OneCardServeConfig); pools on chips of their own, "
                    "with a transfer between cards, are ROADMAP A11")
        if sched.mode == "hybrid":
            self._check_chunked()
        self.num_blocks = engine.kv.allocator.num_blocks
        if self.state_rows is None:
            self.state_rows = self.num_blocks
        self._free_rows = list(range(self.state_rows - 1, -1, -1))
        self.cache = tf.init_cache(
            self.cfg, self.num_blocks + self.serve.max_batch_slots,
            self.serve.page_size, self.state_rows, device=self.device,
            dtype=self.model.tok.dtype)
        if not sched.colocated:
            self.kv_p = engine.kv_p
            self.cache_p = tf.init_cache(
                self.cfg, self.kv_p.allocator.num_blocks,
                self.serve.page_size, 0, device=self.device,
                dtype=self.model.tok.dtype)
            self._page_bytes = sum(c[n][0].numel() * c[n].element_size()
                                   for c in self.cache_p for n in "kv")
            self._loop = engine.loop
            self._priced = PerfModelExecutor(
                self.cfg, self._priced.hw, colocated=False,
                lane_chips=sched.lane_chips(self.serve))
        self.graphs = DecodeGraphs(self.model, self.cache,
                                   max_batch=self.serve.max_batch_slots)
        engine.subscribe(self._on_event)

    @property
    def pool_bytes(self) -> int:
        """The K/V bytes of the pools: the decode pool, and the prefill
        pool of a split-pool engine."""
        return sum(t.numel() * t.element_size()
                   for c in self.cache + (self.cache_p or [])
                   for name, t in c.items() if name in ("k", "v"))

    @property
    def rows_free(self) -> int:
        return len(self._free_rows)

    def _on_event(self, ev) -> None:
        if isinstance(ev, (FinishedEvent, RejectedEvent)) or (
                isinstance(ev, PhaseEvent) and ev.phase == "preempted"):
            self._spare.pop(ev.rid, None)
            self._unstage(ev.rid)
            row = self._row_of.pop(ev.rid, None)
            if row is not None:
                self._free_rows.append(row)

    # -- what this executor does not run --------------------------------------
    def price_batch(self, plans, views):
        raise NotImplementedError(
            "KernelExecutor measures by running the model: what-if "
            "pricing of many plans is the perfmodel's (ROADMAP A11)")

    def transfer_seconds(self, r, serve) -> float:
        """Copy ``r``'s pages into staging, pages of the prefill pool that
        ``kv_p``'s allocator gives, and return the copy's measured seconds
        (CUDA events after a synchronize; the host's clock on the CPU)
        after whatever the card still runs (``busy_until``)."""
        if self.cache_p is None:
            raise NotImplementedError(
                "a colocated engine's prefill writes its decode pool: KV "
                "transfers are run for split-pool (disagg) engines only "
                "(ROADMAP A11)")
        if r.rid in self.staged:
            raise RuntimeError(f"request {r.rid} already holds staging")
        blocks = self.kv_p.blocks_of(r.rid)
        # the scheduler admitted the prefill with room for these
        staged = self.kv_p.allocator.alloc(len(blocks))
        src = self._ints(blocks, torch.int64)
        dst = self._ints(staged, torch.int64)
        now = self._loop.now
        wait = max(0.0, self.busy_until - now)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        _copy_pages(self.cache_p, dst, self.cache_p, src)
        if cuda:
            end.record()
            end.synchronize()
        host_end = time.perf_counter()
        seconds = start.elapsed_time(end) / 1e3 if cuda else host_end - t0
        self.staged[r.rid] = staged
        self.log.append(dict(
            kind="transfer", plan=self._plans, t_start=now + wait,
            wall_s=host_end - t0, host_end=host_end,
            device_ms=seconds * 1e3 if cuda else None, graph=None,
            rids=[r.rid], tokens=self.kv_p.tokens_of(r.rid),
            pages=len(blocks), bytes=len(blocks) * self._page_bytes,
            ms=seconds * 1e3,
            priced_ms=self._priced.transfer_seconds(r, serve) * 1e3,
            prefill_tokens=0, resumed=0, decode_bs=0, f_decode=None,
            arm_f_decode=None))
        self.busy_until = now + wait + seconds
        return wait + seconds

    def _unstage(self, rid: int) -> None:
        """Give ``rid``'s staging blocks, if it holds any, back to
        ``kv_p``'s allocator."""
        blocks = self.staged.pop(rid, None)
        if blocks is not None:
            self.kv_p.allocator.free(blocks)

    def _check_chunked(self) -> None:
        """Raise for a model whose prompts the hybrid steps cannot chunk."""
        cfg = self.cfg
        if cfg.sliding_window:
            raise NotImplementedError(
                f"{cfg.name}: hybrid steps chunk prompts, and a chunk "
                f"written into a sliding-window ring overwrites keys its own "
                f"earlier queries read (ROADMAP A5)")
        xlstm = sorted({cfg.mixer_at(i) for i in range(cfg.num_layers)} &
                       {"mlstm", "slstm"})
        if xlstm:
            raise NotImplementedError(
                f"{cfg.name}: hybrid steps chunk prompts, and chunked "
                f"{', '.join(xlstm)} state is not ported (ROADMAP A5)")

    # -- execution --------------------------------------------------------------
    @torch.no_grad()
    def execute(self, plan: StepPlan, view: SchedView) -> StepOutputs:
        if self.cache is None:
            raise RuntimeError("KernelExecutor.bind(engine) first")
        if plan.hybrid is not None:
            return self._execute_hybrid(plan, view)
        prefill = list(plan.prefill.batch) if plan.prefill else []
        split = self.cache_p is not None
        for r in prefill:
            # a split-pool prefill runs the whole prompt: the engine drops
            # the claim after pricing (the prefill pool holds no prefix)
            if r.cached_prefix_len > 0 and not split:
                raise NotImplementedError(
                    f"request {r.rid}: prefill after a cached prefix (a "
                    f"session's, or a restored KV checkpoint's) is ROADMAP "
                    f"A5")
        decode = list(view.running) + list(plan.decode.joins) \
            if plan.decode else []
        priced = self._priced.execute(plan, view)
        self._plans += 1
        wait = max(0.0, self.busy_until - view.now)
        self._t = view.now + wait
        spent = 0.0
        d_out = p_out = None
        if decode:
            f = plan.decode.f_decode
            if prefill and not split:
                spent += self._fused(prefill.pop(0), decode,
                                     1.0 if f is None else f, f, view.kv)
            else:
                spent += self._decode(decode, f, view.kv)
            d_out = LaunchOutcome(wait + spent, priced.decode.cost)
        for r in prefill:
            spent += self._prefill(r, view.kv_p if split else view.kv)
        if plan.prefill:
            p_out = LaunchOutcome(wait + spent, priced.prefill.cost)
        self.busy_until = view.now + wait + spent
        return StepOutputs(prefill=p_out, decode=d_out)

    def _execute_hybrid(self, plan: StepPlan, view: SchedView
                        ) -> StepOutputs:
        chunks = list(plan.hybrid.chunks)
        for r, _ in chunks:
            if r.cached_prefix_len > 0:
                raise NotImplementedError(
                    f"request {r.rid}: a chunk after a cached prefix (a "
                    f"session's, or a restored KV checkpoint's) is ROADMAP "
                    f"A5")
        decode = list(view.running)
        priced = self._priced.execute(plan, view)
        self._plans += 1
        wait = max(0.0, self.busy_until - view.now)
        self._t = view.now + wait
        if chunks:
            spent = self._hybrid(chunks, decode, view.kv)
        else:
            spent = self._decode(decode, None, view.kv)
        self.busy_until = view.now + wait + spent
        return StepOutputs(hybrid=LaunchOutcome(wait + spent,
                                                priced.hybrid.cost))

    def _launch(self, kind: str, run, **info) -> "tuple[list, float]":
        """Time ``run`` — it enqueues one launch and returns its sampled
        tokens on the device — until the tokens reach the host, with CUDA
        events around its device work on a GPU; log it."""
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        if cuda:
            start.record()
        toks = run()
        if cuda:
            end.record()
        out = toks.tolist()
        host_end = time.perf_counter()
        wall = host_end - t0
        self.log.append(dict(
            kind=kind, plan=self._plans, t_start=self._t, wall_s=wall,
            host_end=host_end,
            device_ms=start.elapsed_time(end) if cuda else None,
            graph=self.graphs.ran if kind == "decode" else None, **info))
        self._t += wall
        return out, wall

    def _take_row(self, rid: int) -> int:
        if rid in self._row_of:
            raise RuntimeError(f"request {rid} already holds state row "
                               f"{self._row_of[rid]}")
        if not self._free_rows:
            raise RuntimeError(f"no free state row for request {rid}: all "
                               f"{self.state_rows} are held")
        row = self._row_of[rid] = self._free_rows.pop()
        return row

    def _ints(self, rows, dtype=torch.int32):
        return torch.tensor(rows, dtype=dtype, device=self.device)

    def _context(self, r, kv) -> np.ndarray:
        """The tokens a prefill of ``r`` runs over: its prompt, then, for a
        request resumed after an eviction, the ``tokens_generated`` tokens
        it had generated (the engine allocated slots for them all)."""
        prompt = np.asarray(self.prompts[r.rid], dtype=np.int32)
        if len(prompt) != r.prompt_len:
            raise RuntimeError(f"request {r.rid}: prompt of {len(prompt)} "
                               f"tokens, the engine has {r.prompt_len}")
        g = r.tokens_generated
        done = self.tokens.get(r.rid, [])[:g]
        self.tokens[r.rid] = done
        if len(done) < g:
            raise RuntimeError(f"request {r.rid}: {g} tokens generated, "
                               f"{len(done)} of them recorded")
        if kv.tokens_of(r.rid) != r.context_len:
            raise RuntimeError(
                f"request {r.rid}: {kv.tokens_of(r.rid)} tokens allocated "
                f"for a prefill over {r.context_len}")
        if not g:
            return prompt
        return np.concatenate([prompt, np.asarray(done, dtype=np.int32)])

    def _prompt_inputs(self, r, kv):
        context = self._context(r, kv)
        row = self._take_row(r.rid)
        toks = torch.from_numpy(context[None]).to(self.device)
        pos = torch.arange(len(context), device=self.device)[None]
        table = ring_table(kv.blocks_of(r.rid), self.cfg.sliding_window,
                           self.serve.page_size)
        return (toks, pos, self._ints([table]),
                self._ints([row], torch.int64))

    def _flush_spares(self, kv) -> None:
        """Copy each spare page into the block the engine has since
        appended for the position it holds: its ring's block under a
        window (the same block, since a spare holds a position below W)."""
        page, window = self.serve.page_size, self.cfg.sliding_window
        pairs = []
        for rid, (spare, pos) in list(self._spare.items()):
            del self._spare[rid]
            try:
                blocks = kv.blocks_of(rid)
            except KeyError:          # preempted: its KV was freed
                continue
            if len(blocks) * page <= pos:
                raise RuntimeError(
                    f"request {rid}: no block for position {pos} before "
                    f"its next decode step")
            pairs.append((spare, blocks[ring_slots(pos, window) // page]))
        # every pool's pages in one multi-tensor copy: an indexed copy per
        # pool costs two launches and their host time each, and the index
        # tensors two host-to-device copies (a model without attention
        # layers has no pool)
        pools = [c[n] for c in self.cache if "k" in c for n in "kv"]
        if pairs and pools:
            torch._foreach_copy_([t[d] for t in pools for _, d in pairs],
                                 [t[s] for t in pools for s, _ in pairs])

    def _decode_inputs(self, decode, kv):
        """(tokens (B,1), cached lengths (B,), block tables padded to
        ``table_width``, state rows) of a decode batch; a request on a
        page boundary below the window (or with none) writes into its
        slot's spare page.  A request's input is its context's last
        token, at position ``n``: a split-pool joiner that has generated
        nothing yet recomputes its first token from its prompt's last."""
        page, window = self.serve.page_size, self.cfg.sliding_window
        # a split-pool engine allocates the position each step writes too
        # (the class docstring), so its requests never reach a spare page
        ahead = int(self.cache_p is not None)
        toks, lens, tables, rows = [], [], [], []
        for i, r in enumerate(decode):
            out = self.tokens[r.rid]
            n = r.prompt_len + len(out) - 1       # tokens with K/V cached
            if kv.tokens_of(r.rid) != n + ahead:
                raise RuntimeError(
                    f"request {r.rid}: {n} tokens cached, the engine's "
                    f"allocation holds {kv.tokens_of(r.rid)}")
            blocks = kv.blocks_of(r.rid)
            if n == len(blocks) * page and not (window and n >= window):
                spare = self.num_blocks + i
                blocks.append(spare)
                self._spare[r.rid] = (spare, n)
            toks.append([out[-1] if out else int(self.prompts[r.rid][-1])])
            lens.append(n)
            tables.append(ring_table(blocks, window, page))
            rows.append(self._row_of[r.rid])
        width = table_width(max(map(len, tables)), window, page)
        tables = [b + [0] * (width - len(b)) for b in tables]
        return (self._ints(toks), self._ints(lens), self._ints(tables),
                self._ints(rows, torch.int64))

    def _chunk_inputs(self, chunks, kv):
        """The packed inputs of a hybrid step's chunks: tokens, absolute
        positions, the ``Chunks`` layout, block tables (padded with 0)
        and state rows; and per chunk (rid, offset, rows, whether it ends
        the request's prefill, the generated tokens it carries)."""
        toks, offs, lens, tables, rows, info = [], [], [], [], [], []
        for r, take in chunks:
            context = self._context(r, kv)      # its allocation holds it
            off = r.prefill_tokens_done
            last = off + take >= r.prefill_tokens_needed
            seg = context[off:] if last else context[off:off + take]
            toks.append(seg)
            offs.append(off)
            lens.append(len(seg))
            tables.append(kv.blocks_of(r.rid))
            rows.append(self._take_row(r.rid) if off == 0
                        else self._row_of[r.rid])
            info.append((r.rid, off, len(seg), last,
                         r.tokens_generated if last else 0))
        pages = [len(b) for b in tables]
        tables = [b + [0] * (max(pages) - len(b)) for b in tables]
        pos = np.concatenate([np.arange(o, o + n) for o, n in
                              zip(offs, lens)])
        return (torch.from_numpy(np.concatenate(toks).astype(np.int32))
                .to(self.device), torch.from_numpy(pos).to(self.device),
                _fp.Chunks(lens, offs, pages), self._ints(tables),
                self._ints(rows, torch.int64), info)

    def _hybrid(self, chunks, decode, kv) -> float:
        vocab = self.cfg.vocab_size
        info = []

        def run():
            self._flush_spares(kv)
            if decode:
                d_in = self._decode_inputs(decode, kv)
            else:
                none = torch.zeros((0, 1), dtype=torch.int32,
                                   device=self.device)
                d_in = (none, none[:, 0], none, self._ints([], torch.int64))
            *c_in, got = self._chunk_inputs(chunks, kv)
            info.extend(got)
            c_logits, d_logits, _ = tf.hybrid_forward(
                self.model, *c_in, *d_in, self.cache)
            return torch.cat([tf.greedy_sample(c_logits, vocab),
                              tf.greedy_sample(d_logits, vocab)])[:, 0]

        out, wall = self._launch(
            "hybrid", run, rids=[r.rid for r, _ in chunks] +
            [r.rid for r in decode], decode_bs=len(decode), f_decode=None,
            arm_f_decode=None)
        self.log[-1].update(prefill_tokens=sum(i[2] for i in info),
                            resumed=sum(i[4] for i in info),
                            chunks=[i[:3] for i in info])
        for (rid, _, _, last, _), t in zip(info, out):
            if last:
                self.tokens[rid].append(t)
        for r, t in zip(decode, out[len(chunks):]):
            self.tokens[r.rid].append(t)
        return wall

    def _prefill(self, r, kv) -> float:
        """Prefill ``r`` alone: into the decode pool, emitting its first
        token, or (split pools) into the prefill pool, emitting none."""
        vocab = self.cfg.vocab_size
        split = self.cache_p is not None
        cache = self.cache_p if split else self.cache

        def run():
            toks, pos, table, row = self._prompt_inputs(r, kv)
            logits, aux = tf.forward(self.model, toks, pos, return_aux=True,
                                     last_only=True)
            tf.write_prefill_to_cache(cache, aux, table, row,
                                      window=self.cfg.sliding_window)
            return tf.greedy_sample(logits, vocab)[:, 0]

        out, wall = self._launch("prefill", run, rids=[r.rid],
                                 prefill_tokens=r.context_len,
                                 resumed=r.tokens_generated, decode_bs=0,
                                 f_decode=None, arm_f_decode=None)
        if not split:
            self.tokens[r.rid] += out
        return wall

    def _land(self, joins, kv) -> None:
        """Copy the split-pool joiners' staged pages into the blocks the
        decode pool gave each (its first ones: its allocation holds them
        all, and the position its step writes), all in one copy a layer."""
        src, dst = [], []
        for r in joins:
            staged = self.staged[r.rid]
            blocks = kv.blocks_of(r.rid)
            if len(blocks) < len(staged):
                raise RuntimeError(
                    f"request {r.rid}: {len(staged)} pages staged, "
                    f"{len(blocks)} blocks in the decode pool")
            src += staged
            dst += blocks[:len(staged)]
        if src:
            _copy_pages(self.cache, self._ints(dst, torch.int64),
                        self.cache_p, self._ints(src, torch.int64))

    def _decode(self, decode, arm_f, kv) -> float:
        joins = [r for r in decode if r.rid in self.staged]

        def run():
            self._flush_spares(kv)
            self._land(joins, kv)
            return self.graphs.step(*self._decode_inputs(decode, kv))

        out, wall = self._launch("decode", run,
                                 rids=[r.rid for r in decode],
                                 prefill_tokens=0, resumed=0,
                                 decode_bs=len(decode),
                                 f_decode=None, arm_f_decode=arm_f,
                                 joins=[r.rid for r in joins])
        for r, t in zip(decode, out):
            self.tokens[r.rid].append(t)
        for r in joins:
            self._unstage(r.rid)
        return wall

    def _fused(self, r_p, decode, f: float, arm_f, kv) -> float:
        vocab = self.cfg.vocab_size

        def run():
            self._flush_spares(kv)
            d_toks, lens, tables, rows = self._decode_inputs(decode, kv)
            p_toks, pos, p_table, p_row = self._prompt_inputs(r_p, kv)
            p_logits, aux, d_logits, _ = tf.fused_pd_forward(
                self.model, p_toks, pos, d_toks, lens[:, None], self.cache,
                tables, lens, rows, f_decode=f)
            tf.write_prefill_to_cache(self.cache, aux, p_table, p_row,
                                      window=self.cfg.sliding_window)
            return torch.cat([tf.greedy_sample(p_logits, vocab),
                              tf.greedy_sample(d_logits, vocab)])[:, 0]

        out, wall = self._launch("fused", run,
                                 rids=[r_p.rid] + [r.rid for r in decode],
                                 prefill_tokens=r_p.context_len,
                                 resumed=r_p.tokens_generated,
                                 decode_bs=len(decode), f_decode=f,
                                 arm_f_decode=arm_f)
        self.tokens[r_p.rid] += out[:1]
        for r, t in zip(decode, out[1:]):
            self.tokens[r.rid].append(t)
        return wall


def _copy_pages(dst_cache, dst: torch.Tensor, src_cache,
                src: torch.Tensor) -> None:
    """Copy pages ``src`` of every layer's K and V in ``src_cache`` into
    pages ``dst`` of ``dst_cache`` (an attention-only model's caches;
    int64 indices on the device)."""
    for d, s in zip(dst_cache, src_cache):
        for name in ("k", "v"):
            d[name].index_copy_(0, dst, s[name].index_select(0, src))
