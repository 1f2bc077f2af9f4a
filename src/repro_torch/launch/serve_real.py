"""End-to-end REAL serving on the port: a seeded request stream
through the RAPID control flow — decode-owned block allocation,
whole-prompt prefill, batched paged decode, continuous batching, and the
concurrent prefill+decode step — with per-request TTFT and ITL on the
wall clock.

A request holds one decode slot from admission to its last token; the
slot is also the row of its recurrent state in every Mamba, mLSTM and
sLSTM layer.  A step prefills at most one prompt, unpadded: padding a
batch of prompts would run the recurrent scans over the padding and
corrupt the final state.

The requests are tokens.  A model whose frontend takes embeddings
(``embed_stub``: qwen2-vl-72b, musicgen-large) is refused by name before
it loads: the reference runs those only through the cells of
``launch/steps.py``, which draw stub embeddings and positions.

Each step is one of three kinds:
  * fused   — a waiting prompt and active decode slots: ``fused_pd_forward``
              (one ``unified_pd`` launch per layer, ``--f-decode``);
  * prefill — a waiting prompt and no active decode: ``forward`` through
              ``flash_prefill``;
  * decode  — active decode slots and no prompt to admit:
              ``decode_forward`` through ``paged_attention``, captured
              once per (batch size, table width) and replayed on the card
              (``DecodeGraphs``), as the reference jits its decode step.

    python -m repro_torch.launch.serve_real --full           # on the H100
    PYTHONPATH=src python -m repro_torch.launch.serve_real \\
        --device cpu --dtype float32                         # reduced, CPU
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import get_one_card_config, get_reduced_config, \
    replace
from repro_torch.kvcache import KVCacheManager, kv_pages_for
from repro_torch.models.attention import ring_table
from repro_torch.models.decode_graph import DecodeGraphs, table_width
from repro_torch.models.transformer import (forward, fused_pd_forward,
                                            greedy_sample, init_cache,
                                            init_model,
                                            write_prefill_to_cache)

SLOTS = 4      # decode batch slots
PAGE = 16      # tokens per KV page


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # int32 tokens
    max_new: int
    tokens: List[int] = dataclasses.field(default_factory=list)
    seq_len: int = 0              # tokens with K/V in the pool
    t_arrive: float = 0.0
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None
    itl: List[float] = dataclasses.field(default_factory=list)


def make_requests(cfg, n: int, seed: int, prompt_range=(6, 24),
                  new_range=(4, 12)) -> List[Request]:
    """``n`` requests with uniform prompt lengths in ``prompt_range`` and
    new-token budgets in ``new_range`` (both inclusive), from ``seed``."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        plen = int(rng.integers(prompt_range[0], prompt_range[1] + 1))
        toks = rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32)
        out.append(Request(rid, toks, int(rng.integers(new_range[0],
                                                       new_range[1] + 1))))
    return out


def check_tokens(cfg) -> None:
    """Raise for a model that takes no tokens (``embed_stub``)."""
    if cfg.frontend != "token":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r} takes embeddings, not "
            f"tokens; the serving entry points take tokens, and the model "
            f"runs through launch/steps.py's cells (stub inputs)")


def resolve_device(device: Optional[str]) -> torch.device:
    """``cuda`` unless the caller asks for the CPU; no silent fallback."""
    if device is None or device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: serve_real runs on the GPU "
                               "(pass --device cpu to run on the CPU)")
        return torch.device(device or "cuda")
    return torch.device(device)


@torch.no_grad()
def serve(model, requests: List[Request], *, slots: int = SLOTS,
          page: int = PAGE, f_decode: float = 0.5) -> dict:
    """Serve ``requests`` (all arriving now) to completion.  Returns a
    summary with the finished requests, step counts by kind and whether
    the KV pool and the decode slots ended fully reclaimed.  It builds no
    autograd graph, so a model being trained serves as it is.  Under a
    sliding window a request holds blocks for its whole context, and its
    block table is the ring of its first W / page blocks."""
    cfg = model.cfg
    check_tokens(cfg)
    window = cfg.sliding_window
    dev, dtype = model.tok.device, model.tok.dtype
    max_ctx = max(len(r.prompt) + r.max_new for r in requests)
    kv = KVCacheManager(slots * kv_pages_for(max_ctx, page), page)
    cache = init_cache(cfg, kv.allocator.num_blocks, page, slots,
                       device=dev, dtype=dtype)
    graphs = DecodeGraphs(model, cache, max_batch=slots)
    waiting = collections.deque(requests)
    slot_req: List[Optional[Request]] = [None] * slots
    free_slots = collections.deque(range(slots))
    done: List[Request] = []
    steps = collections.Counter()
    step_s = collections.Counter()      # host seconds by step kind
    # decode steps and their host seconds by how they ran (DecodeGraphs.ran)
    decode_runs, decode_s = collections.Counter(), collections.Counter()

    def tensor(rows):
        return torch.tensor(rows, dtype=torch.int32, device=dev)

    def tables(rids):
        """Block tables padded with block 0 to ``table_width``."""
        blocks = [ring_table(kv.blocks_of(rid), window, page)
                  for rid in rids]
        width = table_width(max(map(len, blocks)), window, page)
        return tensor([b + [0] * (width - len(b)) for b in blocks])

    def finish_if_done(s, now):
        r = slot_req[s]
        if len(r.tokens) >= r.max_new:
            kv.free(r.rid)
            r.t_done = now
            done.append(r)
            slot_req[s] = None
            free_slots.append(s)

    t0 = time.perf_counter()
    for r in requests:
        r.t_arrive = t0
    while waiting or any(slot_req):
        t_step = time.perf_counter()
        active = [s for s in range(slots) if slot_req[s] is not None]
        new = waiting.popleft() if waiting and free_slots else None
        if new is not None:
            new_slot = free_slots.popleft()
            kv.allocate_prompt(new.rid, len(new.prompt))
            p_tok = tensor(new.prompt[None])
            p_pos = torch.arange(len(new.prompt), device=dev)[None]
            p_tab = tables([new.rid])
            p_slot = torch.tensor([new_slot], device=dev)
        if active:
            reqs = [slot_req[s] for s in active]
            for r in reqs:
                kv.append_token(r.rid)   # the page this step writes into
            d_tok = tensor([[r.tokens[-1]] for r in reqs])
            d_lens = tensor([r.seq_len for r in reqs])
            d_tab = tables([r.rid for r in reqs])
            d_slots = torch.tensor(active, device=dev)
        kind = ("fused" if new is not None and active else
                "prefill" if new is not None else "decode")
        steps[kind] += 1
        if kind == "fused":
            p_logits, aux, d_logits, cache = fused_pd_forward(
                model, p_tok, p_pos, d_tok, d_lens[:, None], cache, d_tab,
                d_lens, d_slots, f_decode=f_decode)
            write_prefill_to_cache(cache, aux, p_tab, p_slot, window=window)
            d_next = greedy_sample(d_logits, cfg.vocab_size)[:, 0].tolist()
        elif kind == "prefill":
            p_logits, aux = forward(model, p_tok, p_pos, return_aux=True,
                                    last_only=True)
            write_prefill_to_cache(cache, aux, p_tab, p_slot, window=window)
            d_next = []
        else:
            d_next = graphs.step(d_tok, d_lens, d_tab, d_slots).tolist()
        if new is not None:
            p_next = int(greedy_sample(p_logits, cfg.vocab_size)[0, 0])
        now = time.perf_counter()
        step_s[kind] += now - t_step
        if kind == "decode":
            decode_runs[graphs.ran] += 1
            decode_s[graphs.ran] += now - t_step
        for s, tok in zip(active, d_next):
            r = slot_req[s]
            r.tokens.append(tok)
            r.seq_len += 1
            r.itl.append(now - r.t_last)
            r.t_last = now
            finish_if_done(s, now)
        if new is not None:
            new.tokens = [p_next]
            new.seq_len = len(new.prompt)
            new.t_first = new.t_last = now
            slot_req[new_slot] = new
            finish_if_done(new_slot, now)
    wall = time.perf_counter() - t0
    done.sort(key=lambda r: r.rid)
    return {"requests": done, "steps": dict(steps), "step_s": dict(step_s),
            "decode_step_mean_s": {k: decode_s[k] / n
                                   for k, n in decode_runs.items()},
            "decode_graphs": graphs.stats(), "wall_s": wall,
            "pool_reclaimed": (kv.allocator.free_count ==
                               kv.allocator.num_blocks),
            "state_slots_reclaimed": sorted(free_slots) == list(range(slots))}


def summarize(result: dict) -> dict:
    """TTFT/ITL/throughput of a ``serve`` result, on the host wall clock."""
    reqs = result["requests"]
    ttft = [r.t_first - r.t_arrive for r in reqs]
    itl = [x for r in reqs for x in r.itl]
    n_tok = sum(len(r.tokens) for r in reqs)
    return {"requests": len(reqs), "tokens": n_tok,
            "wall_s": result["wall_s"],
            "tokens_per_s": n_tok / result["wall_s"],
            "ttft_mean_s": float(np.mean(ttft)),
            "ttft_p95_s": float(np.percentile(ttft, 95)),
            "itl_mean_s": float(np.mean(itl)) if itl else None,
            "itl_p95_s": float(np.percentile(itl, 95)) if itl else None,
            "steps": result["steps"],
            "step_mean_s": {k: result["step_s"][k] / n
                            for k, n in result["steps"].items()},
            "decode_step_mean_s": result["decode_step_mean_s"],
            "decode_graphs": result["decode_graphs"],
            "pool_reclaimed": result["pool_reclaimed"],
            "state_slots_reclaimed": result["state_slots_reclaimed"]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-8b")
    ap.add_argument("--full", action="store_true",
                    help="the published widths: the published config, or "
                    "its one-card cut where one card cannot hold it "
                    "(default: reduced)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default=None,
                    help="float32 or bfloat16 (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--f-decode", type=float, default=0.5)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_one_card_config(args.arch) if args.full else \
        get_reduced_config(args.arch)
    try:
        check_tokens(cfg)
    except NotImplementedError as e:
        ap.error(str(e))
    if args.dtype:
        cfg = replace(cfg, dtype=args.dtype)
    model = init_model(cfg, seed=args.seed, device=device)
    if args.full:
        reqs = make_requests(cfg, args.requests, args.seed, (128, 2048),
                             (16, 64))
    else:
        reqs = make_requests(cfg, args.requests, args.seed)
    result = serve(model, reqs, f_decode=args.f_decode)
    print(json.dumps(summarize(result)))
    if not (result["pool_reclaimed"] and result["state_slots_reclaimed"]):
        raise RuntimeError("KV pool or decode slots not fully reclaimed")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
