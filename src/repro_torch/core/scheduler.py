"""Scheduling policies for the generic serving engine (Serving API v2).

The paper's core claim (§4) is that prefill and decode are independently
schedulable actors on shared chips.  This module makes the *policy* half
of that claim a first-class object: a ``Scheduler`` is consulted by the
generic ``core.engines.Engine`` at every wake point (arrival, step
completion, KV-transfer arrival, admission retry) with a read-only
``SchedView`` of the engine state and returns a ``StepPlan`` — which
requests to reject or admit, which batches to launch on which lane, and
with what resource split.  Schedulers never touch the event loop and
never mutate engine state; the engine applies the plan and the
``core.executor`` prices the launched steps.

Adding a new scheduling policy is therefore a one-class change::

    class MyScheduler(Scheduler):
        mode = "mine"
        ...topology class attrs...
        def schedule(self, view): ...

    eng = Engine(cfg, serve, scheduler=MyScheduler(...))

The three built-ins reproduce the historical engines exactly (asserted
against golden traces in tests/test_parity.py):

  * ``RapidScheduler``  — the paper: concurrent whole-prompt prefill and
    decode actors on the same chips, decode-owned KV admission (Fig 4),
    adaptive resource split from the offline profile (§4.5.3).
  * ``HybridScheduler`` — Sarathi/vLLM-v1 chunked prefill: one lockstep
    batch per iteration, decodes first then prefill chunks up to the
    token budget.
  * ``DisaggScheduler`` — DistServe-style split pools with KV transfer
    on the critical path and decode-side admission backpressure.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.config import OneCardServeConfig
from repro_torch.core.queues import IndexedQueue
from repro_torch.core.request import Request, State
from repro_torch.core.resource_manager import (AdaptiveResourceManager,
                                               cached_decode_profile)
from repro_torch.kvcache import KVCacheManager, kv_pages_for
from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel.hw import TPU_V5E, HardwareSpec


# the most sequences a pool of a model without attention layers holds
MAX_STATE_SEQS = 1024


def kv_pool_blocks(cfg, hw: HardwareSpec, chips: int, page_size: int,
                   reserve_frac: float = 0.05,
                   max_seq_len: int = 32_768) -> int:
    """Pool size: chip-group HBM minus weights, minus activation reserve.

    A model without attention layers (xLSTM) caches no K/V: its blocks
    only count tokens, and what a request holds is its float32 state row.
    Its pool holds as many sequences of ``max_seq_len`` tokens as state
    rows fit the free memory, at most ``MAX_STATE_SEQS`` (the blocks are
    entries of a host list), where the reference divides by its zero
    bytes a token and has no pool for such a model."""
    total = chips * hw.hbm_bytes * (1.0 - reserve_frac)
    weights = C.weight_bytes(cfg)
    free = total - weights
    if free <= 0:
        raise ValueError(
            f"{cfg.name}: weights ({weights/2**30:.0f} GiB) exceed "
            f"{chips}x{hw.hbm_bytes/2**30:.0f} GiB; increase chips")
    per_block = page_size * cfg.kv_bytes_per_token()
    if per_block == 0:
        rows = min(int(free // cfg.state_bytes_per_seq(4)), MAX_STATE_SEQS)
        return max(64, rows * kv_pages_for(max_seq_len, page_size))
    return max(64, int(free // per_block))


# ---------------------------------------------------------------------------
# Wake points and the scheduler's view of the engine
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Wake:
    """Why the engine is consulting the scheduler.

    ``kind`` is one of ``arrival``, ``prefill_done``, ``decode_done``,
    ``step_done``, ``transfer_arrived``, ``admit_retry``.  ``request``
    carries the subject of transfer/retry wakes.  ``kv_freed`` is True
    when a request finished and released decode-pool blocks during this
    wake — the signal gating RAPID's admission drain (allocation can
    only progress after a free, and draining on *preemption*-freed
    blocks would re-admit the victim a step early).
    """
    kind: str
    request: Optional[Request] = None
    kv_freed: bool = False


@dataclasses.dataclass(frozen=True)
class LaneState:
    """One execution lane as the scheduler/executor sees it."""
    busy: bool = False
    cost: Optional[C.StepCost] = None   # in-flight step cost, if busy
    f_decode: Optional[float] = None    # decode lane's resource share


@dataclasses.dataclass(frozen=True)
class SchedView:
    """Read-only snapshot handed to ``Scheduler.schedule``.

    Queues and ``running`` are the live containers — schedulers must
    treat them as immutable and express changes through the returned
    ``StepPlan``.
    """
    now: float
    serve: object                       # ServeConfig
    queues: Mapping[str, IndexedQueue]
    running: IndexedQueue
    kv: KVCacheManager
    kv_p: Optional[KVCacheManager]
    lanes: Mapping[str, LaneState]
    wake: Wake


# ---------------------------------------------------------------------------
# StepPlan: everything a scheduler may ask the engine to do
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Admission:
    """Allocate decode-pool blocks for ``request`` and move it between
    queues.  ``from_queue is None`` means the request is an in-flight
    disagg transfer (held outside any queue).  ``truncate_to`` asks the
    engine to cap the request's ``max_new_tokens`` at admission (and
    mark it ``truncated``) so prompt+output fits the pool — colocated
    topologies truncate where disagg rejects (ROADMAP item 5)."""
    request: Request
    from_queue: Optional[str]
    to_queue: str
    state: State
    stamp_t_blocks: bool = True
    stamp_prefill_start: bool = False
    truncate_to: Optional[int] = None


@dataclasses.dataclass
class PrefillLaunch:
    """Start a whole-prompt prefill step over ``batch`` (popped from
    ``queue``).  ``pool="prefill"`` additionally allocates transient
    prefill-side KV (disagg)."""
    batch: List[Request]
    queue: str
    pool: Optional[str] = None


@dataclasses.dataclass
class DecodeLaunch:
    """Join ``joins`` into the running batch and start a decode step.
    ``f_decode`` is the adaptive resource split (None = overallocate)."""
    joins: List[Request]
    f_decode: Optional[float] = None


@dataclasses.dataclass
class HybridLaunch:
    """One lockstep hybrid iteration: the running decodes plus prefill
    ``chunks`` of (request, tokens)."""
    chunks: List[Tuple[Request, int]]


@dataclasses.dataclass
class AdmitRetry:
    """Re-consult the scheduler about ``request`` after ``delay_s``
    (disagg decode-pool backpressure)."""
    request: Request
    delay_s: float


@dataclasses.dataclass
class StepPlan:
    """What to do *now*: rejections, admissions, lane launches and timed
    retries.  The engine applies fields in declaration order; launches
    are priced by the executor with prefill before decode so a decode
    launched alongside a prefill sees it in flight (the historical
    kick-prefill-then-kick-decode coupling)."""
    rejects: List[Tuple[Request, Optional[str]]] = \
        dataclasses.field(default_factory=list)
    admits: List[Admission] = dataclasses.field(default_factory=list)
    prefill: Optional[PrefillLaunch] = None
    decode: Optional[DecodeLaunch] = None
    hybrid: Optional[HybridLaunch] = None
    retries: List[AdmitRetry] = dataclasses.field(default_factory=list)


# ---------------------------------------------------------------------------
# Scheduler protocol
# ---------------------------------------------------------------------------


class Scheduler:
    """Pure scheduling policy + engine topology declaration.

    Subclasses set the class attributes below (which queues exist, which
    lanes run, where arrivals and preempted victims go, how the load
    snapshot is accounted) and implement ``schedule(view) -> StepPlan``.
    """

    mode: str = "base"
    lanes: Tuple[str, ...] = ("prefill", "decode")
    queue_names: Tuple[str, ...] = ()
    arrival_queue: str = ""
    arrival_state: State = State.WAITING_KV
    requeue_queue: str = ""             # preempted victims (appendleft)
    requeue_state: State = State.WAITING_KV
    migration_queue: str = ""           # cluster rebalance peek/pop
    colocated: bool = True              # P and D share chips (interference)
    has_prefill_pool: bool = False      # transient prefill-side KV (disagg)
    prefill_route: str = "join"         # "join" | "transfer"
    prefill_emits_first_token: bool = True
    # LoadSnapshot accounting
    count_queues: Tuple[str, ...] = ()
    token_queues: Tuple[str, ...] = ()          # full prompt_len pending
    partial_token_queues: Tuple[str, ...] = ()  # prompt minus chunked-done
    unalloc_queues: Tuple[str, ...] = ()        # not yet holding KV pages
    # the port's addition: set by the engine when its executor prefills a
    # resumed request's whole context again (``KernelExecutor``), so such
    # a request is admitted and allocated for its ``context_len``; the
    # perfmodel prices the prompt alone, as the reference does
    reprefill_context: bool = False

    def schedule(self, view: SchedView) -> StepPlan:
        raise NotImplementedError

    def kv_tokens(self, r: Request) -> int:
        """The tokens whose KV the prefill of ``r`` writes: its prompt, or
        under ``reprefill_context`` its context (prompt and generated
        tokens; the prompt alone for a request that generated none)."""
        return r.context_len if self.reprefill_context else r.prompt_len

    # -- engine construction hooks ------------------------------------------
    def pool_blocks(self, cfg, serve, hw: HardwareSpec) -> Dict[str, int]:
        return {"decode": kv_pool_blocks(cfg, hw, serve.chips,
                                         serve.page_size,
                                         serve.kv_reserve_frac,
                                         serve.max_seq_len)}

    def lane_chips(self, serve) -> Dict[str, int]:
        return {lane: serve.chips for lane in self.lanes}

    def resize_lane(self, lane: str, chips: int, cfg, serve,
                    hw: HardwareSpec) -> Dict[str, int]:
        """Grow one lane's chip group at runtime (cluster autoscaler
        adding chips to one pool of a split-pool replica).  Returns the
        new ``pool_blocks`` mapping.  Colocated topologies share every
        chip between both phases, so per-lane resizing is undefined —
        the cluster scales those replicas whole."""
        raise NotImplementedError(
            f"{type(self).__name__} is colocated: per-pool scaling only "
            "applies to split-pool (disagg) topologies")

    # -- shared helpers ------------------------------------------------------
    @staticmethod
    def _fits_pool(prompt_len: int, kv: KVCacheManager,
                   page_size: int) -> bool:
        """Can the prompt *ever* fit this pool?"""
        return kv_pages_for(prompt_len, page_size) <= kv.allocator.num_blocks

    @staticmethod
    def _lifetime_cap(r: Request, kv: KVCacheManager,
                      page_size: int) -> Optional[int]:
        """Colocated pools: cap for the single-request decode stall
        (ROADMAP item 5).  A prompt that fits but whose prompt+output
        never will would, once running alone, self-preempt on every
        decode step forever.  Production systems truncate instead: cap
        ``max_new_tokens`` so the fully-grown context fits the pool.
        Generating N tokens appends N-1 tokens of KV beyond the prompt
        (the first token comes out of prefill; the last token's KV is
        never appended), so the exact bound is
        ``prompt + max_new - 1 <= pool_tokens``.  Returns the cap, or
        None when the request already fits over its lifetime."""
        pool_tokens = kv.allocator.num_blocks * page_size
        if r.prompt_len + r.max_new_tokens - 1 <= pool_tokens:
            return None
        return pool_tokens - r.prompt_len + 1

    @staticmethod
    def _pages_needed(r: Request, kv: KVCacheManager, page_size: int,
                      claimed: set, tokens: Optional[int] = None) -> int:
        """Pages admitting ``r`` would newly claim, net of any parked
        session prefix it can adopt.  ``claimed`` tracks sessions whose
        prefix an earlier admission in the SAME plan already adopts —
        two queued turns of one session must not both count the hit.
        Reduces to ``kv_pages_for(prompt_len)`` for sessionless
        requests.  ``tokens`` (the port's): what the allocation holds,
        default ``prompt_len`` (``kv_tokens``)."""
        tokens = r.prompt_len if tokens is None else tokens
        if r.session_id is None or r.session_id in claimed:
            return kv_pages_for(tokens, page_size)
        need = kv.pages_needed(tokens, r.session_id,
                               r.cached_prefix_len)
        claimed.add(r.session_id)
        return need


# ---------------------------------------------------------------------------
# RAPID (the paper)
# ---------------------------------------------------------------------------


class RapidScheduler(Scheduler):
    """Paper §4: concurrent P/D actors, decode-owned KV admission."""

    mode = "rapid"
    lanes = ("prefill", "decode")
    queue_names = ("waiting_kv", "waiting_prefill", "pending_join")
    arrival_queue = "waiting_kv"
    arrival_state = State.WAITING_KV
    requeue_queue = "waiting_kv"
    requeue_state = State.WAITING_KV
    migration_queue = "waiting_kv"
    count_queues = queue_names
    token_queues = ("waiting_kv", "waiting_prefill")
    unalloc_queues = ("waiting_kv",)

    def __init__(self, cfg, serve, hw: HardwareSpec = TPU_V5E,
                 avg_ctx_hint: int = 4096):
        profile = cached_decode_profile(
            cfg, hw, serve.chips, serve.slo.itl_ms / 1e3, avg_ctx_hint,
            tp=serve.chips)
        self.arm = AdaptiveResourceManager(profile)

    def schedule(self, view: SchedView) -> StepPlan:
        plan = StepPlan()
        serve = view.serve
        ps = serve.page_size
        admitted: List[Request] = []
        # -- Fig 4 drain: decode-side block allocation, FCFS -------------
        # drain at arrival and whenever a *finish* freed blocks; never on
        # preemption-freed blocks alone (at decode_done OR at a later
        # prefill_done) — the decode-owned protocol re-admits a preempted
        # victim only after a finish returns capacity
        if view.wake.kind == "arrival" or view.wake.kv_freed:
            # available_blocks = free + reclaimable session-parked pages;
            # identical to free_count on sessionless traces
            free = view.kv.available_blocks
            claimed = set()     # sessions whose parked prefix this plan
            for r in view.queues["waiting_kv"]:   # already hands out
                n = self.kv_tokens(r)
                if not self._fits_pool(n, view.kv, ps):
                    plan.rejects.append((r, "waiting_kv"))
                    continue
                need = self._pages_needed(r, view.kv, ps, claimed, n)
                if need > free:
                    break
                free -= need
                plan.admits.append(Admission(
                    r, "waiting_kv", "waiting_prefill",
                    State.WAITING_PREFILL,
                    truncate_to=self._lifetime_cap(r, view.kv, ps)))
                admitted.append(r)
        # -- prefill actor: whole prompts up to the token cap ------------
        if not view.lanes["prefill"].busy:
            batch: List[Request] = []
            tokens = 0
            for r in itertools.chain(view.queues["waiting_prefill"],
                                     admitted):
                if batch and tokens + r.prompt_len > serve.prefill_max_tokens:
                    break
                batch.append(r)
                tokens += r.prompt_len
            if batch:
                plan.prefill = PrefillLaunch(batch, "waiting_prefill")
        # -- decode actor: join then step --------------------------------
        if not view.lanes["decode"].busy:
            joins: List[Request] = []
            slots = len(view.running)
            for r in view.queues["pending_join"]:
                if slots >= serve.max_batch_slots:
                    break
                joins.append(r)
                slots += 1
            bs = len(view.running) + len(joins)
            if bs:
                prefill_active = view.lanes["prefill"].busy or \
                    plan.prefill is not None
                alloc = self.arm.allocate(bs, prefill_active)
                plan.decode = DecodeLaunch(joins, f_decode=alloc.f_decode)
        return plan


# ---------------------------------------------------------------------------
# Hybrid batching with chunked prefill (Sarathi / vLLM-v1)
# ---------------------------------------------------------------------------


class HybridScheduler(Scheduler):
    """One lockstep batch per iteration: decodes first, then prefill
    chunks up to the token budget — the §3.1 ITL coupling RAPID removes.

    The port's repair of the reference's stall: a request admitted in this
    plan is chunked with its cached-prefix claim capped at ``prompt_len -
    1``, the bound the engine clamps the claim to at admission (the last
    prompt position is always computed: its logits give the first token,
    as vLLM recomputes the last cached token).  The reference plans with
    the raw claim, so a lone request whose claim covers its prompt gets no
    chunk, no step is launched, and nothing wakes the engine again
    (prompt 16, claim 16: PREFILLING forever).  Where the claim is below
    the prompt, as on every trace the engine's golden records hold, the
    plans are the reference's."""

    mode = "hybrid"
    lanes = ("step",)
    queue_names = ("waiting", "chunking")
    arrival_queue = "waiting"
    arrival_state = State.WAITING_KV
    requeue_queue = "waiting"
    requeue_state = State.WAITING_KV
    migration_queue = "waiting"
    count_queues = ("waiting", "chunking")
    token_queues = ("waiting",)
    partial_token_queues = ("chunking",)
    unalloc_queues = ("waiting",)

    def __init__(self, cfg, serve, hw: HardwareSpec = TPU_V5E):
        del cfg, serve, hw                # stateless policy

    def schedule(self, view: SchedView) -> StepPlan:
        plan = StepPlan()
        if view.lanes["step"].busy:
            return plan
        serve = view.serve
        ps = serve.page_size
        # -- admission: blocks + batch slots, FCFS -----------------------
        free = view.kv.available_blocks
        slots = len(view.queues["chunking"]) + len(view.running)
        admitted: List[Request] = []
        claimed = set()
        for r in view.queues["waiting"]:
            n = self.kv_tokens(r)
            if not self._fits_pool(n, view.kv, ps):
                plan.rejects.append((r, "waiting"))
                continue
            need = self._pages_needed(r, view.kv, ps, claimed, n)
            if need > free or slots >= serve.max_batch_slots:
                break
            free -= need
            slots += 1
            plan.admits.append(Admission(
                r, "waiting", "chunking", State.PREFILLING,
                stamp_prefill_start=True,
                truncate_to=self._lifetime_cap(r, view.kv, ps)))
            admitted.append(r)
        # -- Sarathi: budget filled with decodes first, then chunks ------
        bs = len(view.running)
        budget = max(0, serve.token_budget - bs)
        chunks: List[Tuple[Request, int]] = []
        for r in itertools.chain(view.queues["chunking"], admitted):
            if budget <= 0:
                break
            # the engine's clamp at admission, for a request admitted now
            prefix = min(r.cached_prefix_len, r.prompt_len - 1)
            take = min(serve.chunk_size, budget,
                       r.prompt_len - prefix - r.prefill_tokens_done)
            if take <= 0:
                continue
            chunks.append((r, take))
            budget -= take
        if chunks or bs:
            plan.hybrid = HybridLaunch(chunks)
        return plan


# ---------------------------------------------------------------------------
# Disaggregated serving (DistServe-style, vLLM v1 transfer semantics)
# ---------------------------------------------------------------------------


class DisaggScheduler(Scheduler):
    """Split P/D pools; KV transfer on the critical path; decode-side
    admission with timed backpressure retries (§3.2).  Both pools admit
    and allocate ``kv_tokens`` (the port's: a resumed request's context
    under ``reprefill_context``, else its prompt, as the reference).

    On one card (``OneCardServeConfig``, the port's, ROADMAP C4) the two
    pools split what the card holds for KV after one copy of the weights,
    and a transfer's staged pages stay in the prefill pool until they join
    the decode pool (``KernelExecutor.transfer_seconds``): a prefill is
    admitted only with room for its pages twice over, its own and its
    staging's, and pages still staged count against the pool, so staging
    waits with the prefills it holds back and never outgrows the pool."""

    mode = "disagg"
    lanes = ("prefill", "decode")
    queue_names = ("waiting_prefill", "pending_join")
    arrival_queue = "waiting_prefill"
    arrival_state = State.WAITING_PREFILL
    requeue_queue = "waiting_prefill"
    requeue_state = State.WAITING_PREFILL
    migration_queue = "waiting_prefill"
    colocated = False
    has_prefill_pool = True
    prefill_route = "transfer"
    prefill_emits_first_token = False
    count_queues = ("waiting_prefill", "pending_join")
    token_queues = ("waiting_prefill",)
    unalloc_queues = ("waiting_prefill",)

    def __init__(self, cfg, serve, hw: HardwareSpec = TPU_V5E):
        del cfg, hw
        self.chips_p, self.chips_d = serve.disagg_split

    def pool_blocks(self, cfg, serve, hw: HardwareSpec) -> Dict[str, int]:
        if isinstance(serve, OneCardServeConfig):
            # one copy of the weights, shared by both lanes: what the card
            # holds for KV after it, split evenly between the two pools
            # (the reference's even split of one chip gives (0, 0))
            half = kv_pool_blocks(cfg, hw, 1, serve.page_size,
                                  serve.kv_reserve_frac) // 2
            return {"decode": half, "prefill": half}
        # each pool holds a full weight replica; long-lived KV capacity
        # only exists on the decode side (the §3.2.2 imbalance)
        return {
            "decode": kv_pool_blocks(cfg, hw, self.chips_d, serve.page_size,
                                     serve.kv_reserve_frac),
            "prefill": kv_pool_blocks(cfg, hw, self.chips_p, serve.page_size,
                                      serve.kv_reserve_frac),
        }

    def lane_chips(self, serve) -> Dict[str, int]:
        return {"prefill": self.chips_p, "decode": self.chips_d}

    def resize_lane(self, lane: str, chips: int, cfg, serve,
                    hw: HardwareSpec) -> Dict[str, int]:
        """Independent P/D pool scaling: grow ONE pool's chip group
        (the other pool — and its KV — is untouched)."""
        if lane not in ("prefill", "decode"):
            raise KeyError(f"disagg has no lane {lane!r}")
        if lane == "prefill":
            self.chips_p = chips
        else:
            self.chips_d = chips
        return self.pool_blocks(cfg, serve, hw)

    def schedule(self, view: SchedView) -> StepPlan:
        plan = StepPlan()
        serve = view.serve
        ps = serve.page_size
        # -- decode-side admission for a completed KV transfer -----------
        if view.wake.kind in ("transfer_arrived", "admit_retry"):
            r = view.wake.request
            if not self._fits_pool(r.prompt_len + r.max_new_tokens,
                                   view.kv, ps):
                # prompt + worst-case output can NEVER fit the decode
                # pool: reject instead of spinning the retry loop (or,
                # once admitted, self-preempting on every decode step —
                # the ROADMAP item 5 livelock) forever
                plan.rejects.append((r, None))
            elif kv_pages_for(self.kv_tokens(r), ps) > \
                    view.kv.allocator.free_count:
                # decode pool full: back-pressure; retry next decode step
                plan.retries.append(AdmitRetry(r, serve.slo.itl_ms / 1e3))
            else:
                plan.admits.append(Admission(
                    r, None, "pending_join", State.PREFILL_FINISHED,
                    stamp_t_blocks=False))
        # -- prefill pool admission + batch formation --------------------
        if not view.lanes["prefill"].busy:
            free_p = view.kv_p.allocator.free_count
            # on one card a prefill's pages are staged in its own pool
            times = 2 if isinstance(serve, OneCardServeConfig) else 1
            batch: List[Request] = []
            tokens = 0
            for r in view.queues["waiting_prefill"]:
                n = self.kv_tokens(r)
                need = times * kv_pages_for(n, ps)
                if need > view.kv_p.allocator.num_blocks or \
                        not self._fits_pool(
                            r.prompt_len + r.max_new_tokens, view.kv, ps):
                    # oversized for the prefill pool (queue-head wedge) or
                    # for the decode pool over its LIFETIME — a prompt
                    # whose prompt+output can never fit would either
                    # retry forever post-transfer or livelock decode by
                    # self-preempting on every step (ROADMAP item 5)
                    plan.rejects.append((r, "waiting_prefill"))
                    continue
                if need > free_p:
                    break
                if batch and tokens + r.prompt_len > serve.prefill_max_tokens:
                    break
                free_p -= need
                batch.append(r)
                tokens += r.prompt_len
            if batch:
                plan.prefill = PrefillLaunch(batch, "waiting_prefill",
                                             pool="prefill")
        # -- decode: join then step --------------------------------------
        # a transfer admitted in THIS plan joins immediately (it reaches
        # pending_join before the launch is applied)
        if not view.lanes["decode"].busy:
            joins: List[Request] = []
            slots = len(view.running)
            newly = [a.request for a in plan.admits
                     if a.to_queue == "pending_join"]
            for r in itertools.chain(view.queues["pending_join"], newly):
                if slots >= serve.max_batch_slots:
                    break
                joins.append(r)
                slots += 1
            if view.running or joins:
                plan.decode = DecodeLaunch(joins)
        return plan


SCHEDULERS = {
    "rapid": RapidScheduler,
    "hybrid": HybridScheduler,
    "disagg": DisaggScheduler,
}


def make_scheduler(mode: str, cfg, serve, hw: HardwareSpec = TPU_V5E,
                   **kwargs) -> Scheduler:
    if mode not in SCHEDULERS:
        raise KeyError(
            f"unknown scheduler mode {mode!r}; known: {sorted(SCHEDULERS)}")
    return SCHEDULERS[mode](cfg, serve, hw, **kwargs)
