"""Paged KV-cache block allocator — decode-owned (paper §4.5.1, Fig 4).

Only the decode side runs the KV cache manager.  Prompt block counts are
computable from the context length, so on admission the decode side
allocates the prompt's blocks and prefill writes into them: no KV
transfer, no locks, one owner.

A copy of ``repro/kvcache/manager.py`` restricted to the request
lifecycle the serving loop runs (allocate the prompt, append a token,
free, read the block table).  Session prefix caching and checkpoints
come with a later slice.

Device-side layout (consumed by ``kernels/paged_attention.py``):
    k_pages, v_pages : (num_blocks, page_size, kv_heads, head_dim), per layer
    block_tables     : (batch, max_blocks_per_seq) int32
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class OutOfBlocks(Exception):
    """Raised when the pool cannot satisfy an allocation."""


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


@dataclasses.dataclass
class _SeqAlloc:
    blocks: List[int]
    num_tokens: int          # tokens with cache entries (prompt + generated)
    page_size: int

    @property
    def capacity(self) -> int:
        return len(self.blocks) * self.page_size


class KVCacheManager:
    """Decode-owned per-request block bookkeeping."""

    def __init__(self, num_blocks: int, page_size: int):
        self.allocator = BlockAllocator(num_blocks)
        self.page_size = page_size
        self._seqs: Dict[int, _SeqAlloc] = {}

    def allocate_prompt(self, rid: int, prompt_len: int) -> List[int]:
        if rid in self._seqs:
            raise ValueError(f"request {rid} already allocated")
        blocks = self.allocator.alloc(kv_pages_for(prompt_len, self.page_size))
        self._seqs[rid] = _SeqAlloc(blocks, prompt_len, self.page_size)
        return blocks

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

    def blocks_of(self, rid: int) -> List[int]:
        return list(self._seqs[rid].blocks)
