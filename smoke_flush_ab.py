#!/usr/bin/env python3
"""Phase 9 of ``chip_smoke.py`` (the gateway's stamp check, ROADMAP C8)
with the executor's spare-page flush in two forms, in turns on one
granite-8b: "n", one multi-tensor copy of every pool's pages
(``KernelExecutor._flush_spares``, the port's), and "o", an indexed copy
per pool with its index tensors copied to the card (the form it replaced).
Needs one GPU.

    python3 smoke_flush_ab.py            # the order onnoonnoon
    python3 smoke_flush_ab.py nooonn     # any order of n and o

Prints one JSON line a run: its stamp lags' p99 and max net of plans (ms)
or its failure, the flush, and the decode launches with their mean host
time (ms, from the executor's log).
"""
import gc
import json
import sys
import time

import chip_smoke as cs
import torch
from repro_torch.core import executor as exmod
from repro_torch.models.attention import ring_slots

FOREACH = exmod.KernelExecutor._flush_spares


def indexed_flush(self, kv):
    page, window = self.serve.page_size, self.cfg.sliding_window
    src, dst = [], []
    for rid, (spare, pos) in list(self._spare.items()):
        del self._spare[rid]
        try:
            blocks = kv.blocks_of(rid)
        except KeyError:
            continue
        src.append(spare)
        dst.append(blocks[ring_slots(pos, window) // page])
    if src:
        src, dst = self._ints(src, torch.int64), self._ints(dst, torch.int64)
        for c in self.cache:
            if "k" in c:
                c["k"][dst] = c["k"][src]
                c["v"][dst] = c["v"][src]


def main(order: str) -> int:
    if not torch.cuda.is_available():
        print("smoke_flush_ab: no CUDA device", file=sys.stderr)
        return 1
    logs, bind = [], exmod.KernelExecutor.bind

    def logged_bind(self, engine):
        bind(self, engine)
        logs.append(self.log)

    exmod.KernelExecutor.bind = logged_bind
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.build.build_all()
    model = cs.init_full(cs.get_config("granite-8b"))
    cs.serve_full(model)
    for i, arm in enumerate(order):
        exmod.KernelExecutor._flush_spares = \
            FOREACH if arm == "n" else indexed_flush
        t = time.perf_counter()
        try:
            r = cs.gateway_phase(model)[1]
        except cs.PhaseFailed as e:
            r = {"failed": str(e)}
        dec = [e["wall_s"] for e in logs[-1] if e["kind"] == "decode"]
        r.update(run=i, flush="foreach" if arm == "n" else "indexed",
                 seconds=time.perf_counter() - t, decode_launches=len(dec),
                 decode_host_ms_mean=sum(dec) / max(len(dec), 1) * 1e3)
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1] if len(sys.argv) > 1 else "onnoonnoon"))
