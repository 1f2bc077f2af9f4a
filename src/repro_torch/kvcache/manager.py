"""Paged KV-cache block allocator — decode-owned (paper §4.5.1, Fig 4).

Only the decode side runs the KV cache manager.  Prompt block counts are
computable from the context length, so on admission the decode side
allocates the prompt's blocks and prefill writes into them: no KV
transfer, no locks, one owner.

A copy of ``repro/kvcache/manager.py``: the page pool
(``BlockAllocator``), the request lifecycle (allocate the prompt, append
a token, free, preempt, grow the pool), the session prefix cache, the
staging of checkpoint restores, the checkpoint store and the occupancy
accounting.  One deliberate difference: ``BlockAllocator.alloc(0)``
returns ``[]`` (the reference's slice ``_free[-0:]`` would take the
whole free list; it never calls it with 0).  A block freed twice raises
``RuntimeError``.

Session prefix cache: when a request carries a ``session_id``, its KV
can be parked on completion (``release_to_session``) instead of freed,
up to a ``session_cache_blocks`` budget, LRU-evicted; the session's next
turn adopts the parked pages for its shared prefix.  Parked pages are
always reclaimable, so caching can delay no request.  With the budget at
0 (or no session ids) every path reduces to plain free/alloc.

Device-side layout (consumed by ``kernels/paged_attention.py``):
    k_pages, v_pages : (num_blocks, page_size, kv_heads, head_dim), per layer
    block_tables     : (batch, max_blocks_per_seq) int32
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional


class OutOfBlocks(Exception):
    """Raised when the pool cannot satisfy an allocation (triggers
    engine-level preemption or admission back-pressure)."""


@dataclasses.dataclass(frozen=True, slots=True)
class KVCheckpoint:
    """A durable snapshot of a running request's KV cache, parked off the
    serving replica (gateway / peer worker).  ``generated`` is the number
    of output tokens covered; ``kv_tokens`` the context tokens whose KV
    the snapshot holds (= original prompt + generated - 1: the first
    output token comes from prefill, each decode step appends one KV
    entry before emitting)."""
    rid: int
    generated: int
    kv_tokens: int
    t: float                 # commit time (copy finished)


class CheckpointStore:
    """Gateway-side parking lot for request KV checkpoints.

    Newest-wins per request; a ``budget_blocks`` cap (0 = unbounded)
    models the host/peer memory actually reserved for recovery — when a
    new snapshot would exceed it, *oldest-commit-first* entries of other
    requests are evicted (their requests silently fall back to re-prefill
    failover), and a snapshot too large for the whole budget is refused.
    """

    def __init__(self, page_size: int, budget_blocks: int = 0):
        self.page_size = page_size
        self.budget_blocks = budget_blocks
        self._by_rid: "collections.OrderedDict[int, KVCheckpoint]" = \
            collections.OrderedDict()
        self.taken = 0           # snapshots committed
        self.evicted = 0         # snapshots dropped for budget
        self.refused = 0         # snapshots larger than the whole budget

    def _pages(self, ckpt: KVCheckpoint) -> int:
        return kv_pages_for(ckpt.kv_tokens, self.page_size)

    @property
    def blocks(self) -> int:
        return sum(self._pages(c) for c in self._by_rid.values())

    def __len__(self) -> int:
        return len(self._by_rid)

    def put(self, ckpt: KVCheckpoint) -> bool:
        """Commit a snapshot (replaces any older one for the same rid).
        Returns False when the snapshot alone exceeds the budget."""
        need = self._pages(ckpt)
        if self.budget_blocks and need > self.budget_blocks:
            self.refused += 1
            return False
        self._by_rid.pop(ckpt.rid, None)
        if self.budget_blocks:
            while self._by_rid and self.blocks + need > self.budget_blocks:
                self._by_rid.popitem(last=False)     # oldest commit first
                self.evicted += 1
        self._by_rid[ckpt.rid] = ckpt
        self.taken += 1
        return True

    def get(self, rid: int) -> Optional[KVCheckpoint]:
        return self._by_rid.get(rid)

    def drop(self, rid: int) -> None:
        self._by_rid.pop(rid, None)


def kv_pages_for(num_tokens: int, page_size: int) -> int:
    return -(-num_tokens // page_size)


def paged_cache_shape(cfg, num_blocks: int, page_size: int, tp: int = 1):
    return (num_blocks, page_size, cfg.kv_heads_padded(tp), cfg.head_dim)


class BlockAllocator:
    """Free-list page pool.  O(1) alloc/free, LIFO reuse for locality."""

    def __init__(self, num_blocks: int):
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise OutOfBlocks(f"need {n}, have {len(self._free)}")
        if n <= 0:
            return []
        out = self._free[-n:][::-1]
        del self._free[-n:]
        return out

    def free(self, blocks: List[int]) -> None:
        self._free.extend(reversed(blocks))
        if len(self._free) > self.num_blocks:
            raise RuntimeError("block freed twice")

    def grow(self, extra_blocks: int) -> None:
        """Append ``extra_blocks`` fresh pages to the pool (runtime pool
        scaling — e.g. the cluster autoscaler adding chips to a disagg
        prefill pool).  Pools only grow: shrinking would require evicting
        live KV out from under running requests."""
        if extra_blocks < 0:
            raise ValueError("block pools only grow; cannot shrink by "
                             f"{-extra_blocks} blocks")
        start = self.num_blocks
        self.num_blocks += extra_blocks
        self._free.extend(range(self.num_blocks - 1, start - 1, -1))


@dataclasses.dataclass
class _SeqAlloc:
    blocks: List[int]
    num_tokens: int          # tokens with cache entries (prompt + generated)
    page_size: int

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.page_size


class KVCacheManager:
    """Decode-owned per-request block bookkeeping (single owner => no
    locks; the prefill side only ever *reads* block IDs it was handed)."""

    def __init__(self, num_blocks: int, page_size: int,
                 session_cache_blocks: int = 0):
        self.allocator = BlockAllocator(num_blocks)
        self.page_size = page_size
        self._seqs: Dict[int, _SeqAlloc] = {}
        # parked per-session prefix KV, LRU-ordered (oldest first)
        self.session_cache_blocks = session_cache_blocks
        self._sessions: "collections.OrderedDict[str, _SeqAlloc]" = \
            collections.OrderedDict()
        self._session_block_count = 0
        # checkpoint restores staged by the gateway: rid -> context tokens
        # whose KV is being copied in from a parked snapshot (consumed at
        # allocate_prompt; compute for those tokens is skipped)
        self._staged_restores: Dict[int, int] = {}

    # -- session prefix cache ------------------------------------------------
    @property
    def session_blocks(self) -> int:
        """Blocks parked for finished sessions — allocated, but
        reclaimable at any time (LRU) by ``allocate_prompt``."""
        return self._session_block_count

    @property
    def available_blocks(self) -> int:
        """Free blocks plus reclaimable session-parked blocks — the
        quantity admission must project against (identical to
        ``allocator.free_count`` when no sessions are parked)."""
        return self.allocator.free_count + self._session_block_count

    def session_tokens(self, session_id: str) -> int:
        entry = self._sessions.get(session_id)
        return entry.num_tokens if entry is not None else 0

    def session_hit_tokens(self, session_id: Optional[str],
                           prompt_len: int, max_prefix: int) -> int:
        """Prefix tokens the next turn may actually skip: bounded by what
        is resident, by the caller's claimed shared prefix, and by
        ``prompt_len - 1`` (at least one token must be prefilled so the
        step produces the first output token)."""
        if session_id is None or max_prefix <= 0:
            return 0
        return max(0, min(max_prefix, self.session_tokens(session_id),
                          prompt_len - 1))

    def drop_session(self, session_id: str) -> None:
        """Invalidate a session's parked prefix (e.g. the cluster
        migrated the session to another replica)."""
        entry = self._sessions.pop(session_id, None)
        if entry is not None:
            self._session_block_count -= len(entry.blocks)
            self.allocator.free(entry.blocks)

    def release_to_session(self, rid: int, session_id: str) -> bool:
        """Park a finishing request's KV for its session instead of
        freeing it.  Returns True when parked; falls back to a plain
        ``free`` (returns False) when the budget is 0 or the entry alone
        exceeds it.  Evicts LRU sessions to stay within budget."""
        seq = self._seqs.pop(rid)
        if not 0 < len(seq.blocks) <= self.session_cache_blocks:
            self.allocator.free(seq.blocks)
            return False
        old = self._sessions.pop(session_id, None)
        if old is not None:
            self._session_block_count -= len(old.blocks)
            self.allocator.free(old.blocks)
        self._sessions[session_id] = seq
        self._session_block_count += len(seq.blocks)
        while self._session_block_count > self.session_cache_blocks:
            _, evicted = self._sessions.popitem(last=False)
            self._session_block_count -= len(evicted.blocks)
            self.allocator.free(evicted.blocks)
        return True

    def _alloc_evicting(self, n: int) -> List[int]:
        """Allocate ``n`` blocks, reclaiming LRU session prefixes as
        needed — parked KV can never starve live work."""
        if n <= 0:
            return []
        while n > self.allocator.free_count and self._sessions:
            _, evicted = self._sessions.popitem(last=False)
            self._session_block_count -= len(evicted.blocks)
            self.allocator.free(evicted.blocks)
        return self.allocator.alloc(n)

    # -- checkpoint restore staging (gateway failover) ----------------------
    def stage_restore(self, rid: int, kv_tokens: int) -> None:
        """Announce that ``kv_tokens`` context tokens of KV for ``rid``
        are being restored from a parked checkpoint: the next
        ``allocate_prompt(rid, ...)`` still claims the full page count
        (restored KV occupies real pages) but the engine skips prefill
        compute for the restored prefix (``restore_hit_tokens``)."""
        if kv_tokens > 0:
            self._staged_restores[rid] = kv_tokens

    def restore_hit_tokens(self, rid: int, prompt_len: int) -> int:
        """Prefix tokens a staged restore lets ``rid`` skip — same
        ``prompt_len - 1`` bound as the session cache (one token must be
        prefilled so the step emits the first output token)."""
        staged = self._staged_restores.get(rid, 0)
        if staged <= 0:
            return 0
        return max(0, min(staged, prompt_len - 1))

    def clear_restore(self, rid: int) -> None:
        self._staged_restores.pop(rid, None)

    # -- Fig 4 step 2: decode allocates the prompt's blocks ----------------
    def pages_needed(self, prompt_len: int,
                     session_id: Optional[str] = None,
                     max_prefix: int = 0) -> int:
        """Pages ``allocate_prompt`` would newly claim, net of pages
        adopted from the session's parked prefix (pure projection)."""
        total = kv_pages_for(prompt_len, self.page_size)
        hit = self.session_hit_tokens(session_id, prompt_len, max_prefix)
        if hit <= 0:
            return total
        entry = self._sessions[session_id]
        adopted = min(kv_pages_for(hit, self.page_size),
                      len(entry.blocks), total)
        return total - adopted

    def allocate_prompt(self, rid: int, prompt_len: int,
                        session_id: Optional[str] = None,
                        max_prefix: int = 0) -> List[int]:
        if rid in self._seqs:
            raise ValueError(f"request {rid} already allocated")
        total = kv_pages_for(prompt_len, self.page_size)
        adopted: List[int] = []
        hit = self.session_hit_tokens(session_id, prompt_len, max_prefix)
        if hit > 0:
            entry = self._sessions.pop(session_id)
            self._session_block_count -= len(entry.blocks)
            keep = min(kv_pages_for(hit, self.page_size),
                       len(entry.blocks), total)
            adopted = entry.blocks[:keep]
            if entry.blocks[keep:]:
                self.allocator.free(entry.blocks[keep:])
        try:
            blocks = adopted + self._alloc_evicting(total - len(adopted))
        except OutOfBlocks:
            if adopted:
                self.allocator.free(adopted)
            raise
        self._seqs[rid] = _SeqAlloc(blocks, prompt_len, self.page_size)
        self._staged_restores.pop(rid, None)     # restore consumed
        return blocks

    def can_allocate(self, prompt_len: int) -> bool:
        return kv_pages_for(prompt_len, self.page_size) <= \
            self.allocator.free_count

    # -- decode step: one new token per running request ---------------------
    def append_token(self, rid: int) -> Optional[int]:
        """Returns a newly-allocated block id when a page boundary is
        crossed, else None."""
        seq = self._seqs[rid]
        new_block = None
        if seq.num_tokens + 1 > seq.capacity:
            new_block = self.allocator.alloc(1)[0]
            seq.blocks.append(new_block)
        seq.num_tokens += 1
        return new_block

    def free(self, rid: int) -> None:
        seq = self._seqs.pop(rid)
        self.allocator.free(seq.blocks)

    def preempt(self, rid: int) -> int:
        """Free a request's blocks (victim of preemption); returns the
        number of tokens whose KV must be recomputed on resume."""
        seq = self._seqs[rid]
        tokens = seq.num_tokens
        self.free(rid)
        return tokens

    def grow(self, extra_blocks: int) -> None:
        """Runtime pool expansion (see ``BlockAllocator.grow``)."""
        self.allocator.grow(extra_blocks)

    # -- accounting ---------------------------------------------------------
    def blocks_of(self, rid: int) -> List[int]:
        return list(self._seqs[rid].blocks)

    def tokens_of(self, rid: int) -> int:
        return self._seqs[rid].num_tokens

    @property
    def num_requests(self) -> int:
        return len(self._seqs)

    @property
    def utilization(self) -> float:
        """Fraction of the pool holding live KV (paper §5.4 metric)."""
        if self.allocator.num_blocks == 0:
            return 0.0
        return self.allocator.used_count / self.allocator.num_blocks

    @property
    def token_occupancy(self) -> float:
        """Live tokens / pool token capacity — excludes page-tail waste."""
        cap = self.allocator.num_blocks * self.page_size
        live = sum(s.num_tokens for s in self._seqs.values())
        return live / cap if cap else 0.0
