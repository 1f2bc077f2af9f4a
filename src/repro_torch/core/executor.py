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
plans, ``flash_prefill`` and ``paged_attention`` for launches alone) and
reports measured durations.  The other classes are copies of
``repro/core/executor.py``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.events import FinishedEvent, PhaseEvent
from repro_torch.core.scheduler import SchedView, StepPlan
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

    What it does not run raises ``NotImplementedError``: hybrid plans,
    split-pool engines and their KV transfers (disagg), what-if
    ``price_batch`` pricing (it would run the model), and a prefill after
    a cached prefix (a session's, or a gateway checkpoint's restore).

    ``bind(engine)`` allocates the pool at the engine's KV block count
    and subscribes to its events; ``log`` holds one record per launch,
    ``graph`` saying how a decode launch ran (``DecodeGraphs.ran``:
    "capture", "replay" or "eager"), ``plan`` which ``execute`` call it
    belongs to, ``resumed`` how many generated tokens a prefill ran over
    after the prompt, and ``host_end`` the host's ``time.perf_counter()``
    when its tokens reached the host.
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
        one spare page per decode slot, and the state rows; and take back
        a request's row and spare page when it leaves the engine."""
        if not engine.scheduler.colocated:
            raise NotImplementedError(
                "KernelExecutor runs colocated engines only: split-pool "
                "(disagg) execution is the ROADMAP item 'hybrid and "
                "disagg real execution'")
        self.num_blocks = engine.kv.allocator.num_blocks
        if self.state_rows is None:
            self.state_rows = self.num_blocks
        self._free_rows = list(range(self.state_rows - 1, -1, -1))
        self.cache = tf.init_cache(
            self.cfg, self.num_blocks + self.serve.max_batch_slots,
            self.serve.page_size, self.state_rows, device=self.device,
            dtype=self.model.tok.dtype)
        self.graphs = DecodeGraphs(self.model, self.cache,
                                   max_batch=self.serve.max_batch_slots)
        engine.subscribe(self._on_event)

    @property
    def pool_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for c in self.cache
                   for name, t in c.items() if name in ("k", "v"))

    @property
    def rows_free(self) -> int:
        return len(self._free_rows)

    def _on_event(self, ev) -> None:
        if isinstance(ev, FinishedEvent) or (
                isinstance(ev, PhaseEvent) and ev.phase == "preempted"):
            self._spare.pop(ev.rid, None)
            row = self._row_of.pop(ev.rid, None)
            if row is not None:
                self._free_rows.append(row)

    # -- what this executor does not run --------------------------------------
    def price_batch(self, plans, views):
        raise NotImplementedError(
            "KernelExecutor measures by running the model: what-if "
            "pricing of many plans is the perfmodel's (ROADMAP item "
            "'hybrid and disagg real execution')")

    def transfer_seconds(self, r, serve) -> float:
        raise NotImplementedError(
            "KV transfers (disagg) are not run on the device yet (ROADMAP "
            "item 'hybrid and disagg real execution')")

    # -- execution --------------------------------------------------------------
    @torch.no_grad()
    def execute(self, plan: StepPlan, view: SchedView) -> StepOutputs:
        if plan.hybrid is not None:
            raise NotImplementedError(
                "KernelExecutor runs RAPID plans: hybrid (chunked-prefill) "
                "steps are the ROADMAP item 'hybrid and disagg real "
                "execution'")
        if self.cache is None:
            raise RuntimeError("KernelExecutor.bind(engine) first")
        prefill = list(plan.prefill.batch) if plan.prefill else []
        for r in prefill:
            if r.cached_prefix_len > 0:
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
            if prefill:
                spent += self._fused(prefill.pop(0), decode,
                                     1.0 if f is None else f, f, view.kv)
            else:
                spent += self._decode(decode, f, view.kv)
            d_out = LaunchOutcome(wait + spent, priced.decode.cost)
        for r in prefill:
            spent += self._prefill(r, view.kv)
        if plan.prefill:
            p_out = LaunchOutcome(wait + spent, priced.prefill.cost)
        self.busy_until = view.now + wait + spent
        return StepOutputs(prefill=p_out, decode=d_out)

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
        slot's spare page."""
        page, window = self.serve.page_size, self.cfg.sliding_window
        toks, lens, tables, rows = [], [], [], []
        for i, r in enumerate(decode):
            out = self.tokens[r.rid]
            n = r.prompt_len + len(out) - 1       # tokens with K/V cached
            if kv.tokens_of(r.rid) != n:
                raise RuntimeError(
                    f"request {r.rid}: {n} tokens cached, the engine's "
                    f"allocation holds {kv.tokens_of(r.rid)}")
            blocks = kv.blocks_of(r.rid)
            if n == len(blocks) * page and not (window and n >= window):
                spare = self.num_blocks + i
                blocks.append(spare)
                self._spare[r.rid] = (spare, n)
            toks.append([out[-1]])
            lens.append(n)
            tables.append(ring_table(blocks, window, page))
            rows.append(self._row_of[r.rid])
        width = table_width(max(map(len, tables)), window, page)
        tables = [b + [0] * (width - len(b)) for b in tables]
        return (self._ints(toks), self._ints(lens), self._ints(tables),
                self._ints(rows, torch.int64))

    def _prefill(self, r, kv) -> float:
        vocab = self.cfg.vocab_size

        def run():
            toks, pos, table, row = self._prompt_inputs(r, kv)
            logits, aux = tf.forward(self.model, toks, pos, return_aux=True,
                                     last_only=True)
            tf.write_prefill_to_cache(self.cache, aux, table, row,
                                      window=self.cfg.sliding_window)
            return tf.greedy_sample(logits, vocab)[:, 0]

        out, wall = self._launch("prefill", run, rids=[r.rid],
                                 prefill_tokens=r.context_len,
                                 resumed=r.tokens_generated, decode_bs=0,
                                 f_decode=None, arm_f_decode=None)
        self.tokens[r.rid] += out
        return wall

    def _decode(self, decode, arm_f, kv) -> float:
        def run():
            self._flush_spares(kv)
            return self.graphs.step(*self._decode_inputs(decode, kv))

        out, wall = self._launch("decode", run,
                                 rids=[r.rid for r in decode],
                                 prefill_tokens=0, resumed=0,
                                 decode_bs=len(decode),
                                 f_decode=None, arm_f_decode=arm_f)
        for r, t in zip(decode, out):
            self.tokens[r.rid].append(t)
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
