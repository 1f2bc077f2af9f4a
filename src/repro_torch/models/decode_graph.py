"""The decode step captured once per batch shape and replayed: the
counterpart of the reference's ``jax.jit(decode_forward)``
(``examples/serve_real.py:55``).

``DecodeGraphs(model, cache, max_batch=...)`` holds one CUDA graph of
``decode_forward`` + ``greedy_sample`` per (batch size, table width) (and
the shape of explicit positions, where a caller gives them),
captured with ``torch.cuda.graph`` at the first step of that shape, as
``jax.jit`` compiles at its first call, and replayed at every later step
of that shape.  All its graphs share one memory pool.

What a graph needs of the step, and how it holds:
  * Every shape comes from the host: the batch size, the block tables'
    width and the MoE plan (``moe.moe_plan`` of the batch).  Nothing on
    the step syncs with the device.  ``paged_attention``'s split count
    follows the tables' width, so the width is part of a graph's key;
    ``table_width`` rounds a batch's widest table up to whole key splits,
    so that few widths occur and none adds a split that reads no key.
  * A graph's inputs are static tensors, filled with ``copy_`` before
    each replay: tokens (B,1), or an ``embed_stub`` model's embeddings
    (B,1,d); the cached lengths, block tables and state rows; and the
    positions, (B,1) or M-RoPE's (B,1,3), where the caller gives them (by
    default a step's positions are its cached lengths, computed inside
    the graph).  The KV pools and the recurrent state rows (Mamba, mLSTM,
    sLSTM) are gathered and updated in place by the replay, as by the
    eager step.
  * ``paged_attention`` keeps arrival counters per stream and replaces a
    stream's buffer when a larger one is asked for.  The capture stream's
    buffer is sized for ``max_batch`` sequences before the first capture
    and held here, so no capture replaces the buffer an earlier graph
    reads.
  * The kernel wrappers count their host calls.  A capture's calls run
    nothing, so its counts are taken back and added again at every
    replay.

The first step of a shape runs eagerly on the capture stream (it warms
cuBLAS and the kernels at that shape, and its outputs are that step's);
then the shape is captured.  On the card a capture or a replay works or
raises.  On the CPU ``step`` is the eager ``decode_forward``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ring_pages


def table_width(pages: int, window: Optional[int], page: int) -> int:
    """The block-table width of a decode batch whose widest table holds
    ``pages`` entries: ``pages`` rounded up to whole key splits of
    ``paged_attention`` (``SPLIT_KEYS // page`` pages each), or under a
    sliding window the ring's W / page.  Tables are padded to it with
    block 0, which the kernel never reads past ``seq_lens``."""
    ring = ring_pages(window, page)
    if ring is not None:
        if pages > ring:
            raise ValueError(f"a table of {pages} pages under a ring of "
                             f"{ring}: pass ring tables (ring_table)")
        return ring
    per = max(1, pa.SPLIT_KEYS // page)
    return -(-max(pages, 1) // per) * per


@dataclasses.dataclass
class Captured:
    """One captured decode step: its static inputs (tokens (B,1) int32 or
    embeddings (B,1,d), lens (B,) int32, tables (B,W) int32, state rows
    (B,) int64, and positions where given), its static outputs, and the
    kernel launches one replay runs."""
    graph: "torch.cuda.CUDAGraph"
    inputs: Tuple[torch.Tensor, ...]
    tokens: torch.Tensor
    logits: torch.Tensor
    launches: Dict[str, int]

    def fill(self, *inputs) -> None:
        for dst, src in zip(self.inputs, inputs):
            dst.copy_(src)

    def replay(self) -> None:
        self.graph.replay()
        ops.add_launches(self.launches)


class DecodeGraphs:
    """The decode steps of ``model`` over ``cache``, one CUDA graph per
    (batch size, table width) of at most ``max_batch`` sequences.
    ``captures`` and ``capture_s`` count the shapes captured and the host
    seconds their captures took; ``replays`` the steps replayed; ``ran``
    says how the last step ran: "capture" (the first of its shape),
    "replay", or "eager" (on the CPU)."""

    def __init__(self, model, cache, *, max_batch: int):
        self.model, self.cache, self.max_batch = model, cache, max_batch
        self.device = model.tok.device
        self.graphs: Dict[Tuple[int, ...], Captured] = {}
        self.logits = None
        self.ran = None
        self.captures = self.replays = 0
        self.capture_s = 0.0
        self._stream = self._pool = self._counters = None

    def _eager(self, tokens, lens, tables, rows, positions=None):
        if positions is None:
            positions = lens[:, None]
        logits, _ = tf.decode_forward(self.model, tokens, positions,
                                      self.cache, tables, lens, rows)
        return logits, tf.greedy_sample(logits,
                                        self.model.cfg.vocab_size)[:, 0]

    def step(self, tokens, lens, tables, rows, positions=None):
        """One decode step: tokens (B,1) int32 (an ``embed_stub`` model's
        embeddings (B,1,d)); lens (B,) int32 tokens cached; tables (B,W)
        int32 padded to ``table_width``; rows (B,) int64 recurrent state
        rows; positions (B,1) or (B,1,3), by default ``lens``.  Returns
        the greedy next tokens (B,) int32 on the device; ``logits`` holds
        the step's logits (B,1,Vp).  Both outputs are valid until the next
        step."""
        inputs = (tokens, lens, tables, rows) + (
            () if positions is None else (positions,))
        if self.device.type == "cpu":
            self.ran = "eager"
            self.logits, toks = self._eager(*inputs)
            return toks
        key = tuple(tables.shape) + (
            () if positions is None else tuple(positions.shape))
        g = self.graphs.get(key)
        self.ran = "capture" if g is None else "replay"
        if g is None:
            return self._capture(key, inputs)
        g.fill(*inputs)
        g.replay()
        self.replays += 1
        self.logits = g.logits
        return g.tokens

    def _capture(self, key, inputs):
        B = inputs[2].shape[0]
        if B > self.max_batch:
            raise ValueError(f"a decode batch of {B} over max_batch "
                             f"{self.max_batch}")
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
            hkv = self.model.cfg.kv_heads_padded(1)
            self._counters = pa.counters(self.device, self.max_batch * hkv,
                                         self._stream.cuda_stream)
        inputs = tuple(t.clone() for t in inputs)
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            logits, toks = self._eager(*inputs)
        cur.wait_stream(self._stream)
        for t in (logits, toks):
            t.record_stream(cur)
        t0 = time.perf_counter()
        before = ops.launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool, stream=self._stream):
            g_logits, g_toks = self._eager(*inputs)
        after = ops.launches()
        counts = {k: after[k] - before[k] for k in after}
        ops.add_launches({k: -n for k, n in counts.items()})
        self.graphs[key] = Captured(graph, inputs, g_toks, g_logits, counts)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        self.logits = logits
        return toks

    def pool_bytes(self) -> Optional[int]:
        """Device memory the graphs' pool holds (None before a capture)."""
        if self._pool is None:
            return None
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == tuple(self._pool))

    def stats(self) -> dict:
        return {"graphs": self.captures, "capture_s": self.capture_s,
                "replays": self.replays, "pool_bytes": self.pool_bytes()}
