"""Training launcher: a model on synthetic tokens, with checkpoints and
restart.

Counterpart of ``repro/launch/train.py``'s real run: the reduced config
by default, or the published widths with ``--full``, trained from seeded
random weights on ``TokenPipeline``'s stream through
``TrainingSupervisor`` (a checkpoint every ``--ckpt-every`` steps).  The
moments take the config's ``opt_dtype``.  On the card it also reports
seconds per step (the first step, which allocates everything, apart)
and peak device memory.  Configs that take no tokens (``embed_stub``,
M-RoPE positions) wait for the port's launch cells.

    python -m repro_torch.launch.train --arch minicpm-2b --full \\
        --steps 6 --batch 2 --seq-len 4096                     # on the H100
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
        --device cpu --steps 6                                 # reduced, CPU
"""
from __future__ import annotations

import argparse
import statistics
import tempfile
import time

import numpy as np
import torch

from repro_torch.config import (get_one_card_config, get_reduced_config,
                                list_archs)
from repro_torch.data import TokenPipeline
from repro_torch.launch.serve_real import resolve_device
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.resilience import TrainingSupervisor
from repro_torch.training.train_lib import init_train_state, make_train_step


def check_trainable(cfg) -> None:
    if cfg.frontend != "token" or cfg.rope_type == "mrope":
        raise NotImplementedError(
            f"{cfg.name}: frontend {cfg.frontend!r}, rope {cfg.rope_type!r}: "
            "only token models with plain RoPE train on the port yet")


def make_batch(pipe: TokenPipeline, device) -> dict:
    x, y = pipe.next_batch()
    B, S = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=device).expand(B, S)
    return {"inputs": torch.from_numpy(x).to(device),
            "labels": torch.from_numpy(y).to(device), "positions": pos}


def run(cfg, opt: OptConfig, *, steps: int, batch: int, seq_len: int,
        microbatches: int, ckpt_dir: str, ckpt_every: int,
        compress_grads: bool, seed: int, device, failures=None) -> dict:
    """Train ``cfg`` for ``steps`` batches under the supervisor.  Returns
    the final state, the supervisor, and per step the metrics (loss,
    grad_norm, lr, step) and host seconds (each step ends in a host read
    of its loss)."""
    state = init_train_state(cfg, opt, device=device, seed=seed)
    train_step = make_train_step(cfg, opt, microbatches=microbatches,
                                 compress_grads=compress_grads)
    metrics, seconds = [], []

    def step_fn(state, batch):
        t = time.perf_counter()
        state, m = train_step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        seconds.append(time.perf_counter() - t)
        metrics.append(m)
        return state, m

    pipe = TokenPipeline(cfg.vocab_size, batch, seq_len, seed=seed)
    sup = TrainingSupervisor(step_fn, CheckpointManager(ckpt_dir, keep=2),
                             ckpt_every=ckpt_every)
    state = sup.run(state, (make_batch(pipe, device) for _ in range(steps)),
                    failures=failures)
    return {"state": state, "supervisor": sup, "metrics": metrics,
            "seconds": seconds}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", required=True, choices=list_archs())
    p.add_argument("--full", action="store_true",
                   help="the published widths: the published config, or "
                   "its one-card cut where one card cannot hold it "
                   "(default: reduced)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--microbatches", type=int, default=2)
    p.add_argument("--ckpt-dir", default=None,
                   help="default: a temporary directory, removed at exit")
    p.add_argument("--ckpt-every", type=int, default=20)
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_one_card_config(args.arch) if args.full else \
        get_reduced_config(args.arch)
    check_trainable(cfg)
    opt = OptConfig(lr=args.lr, warmup_steps=5,
                    stable_steps=max(10, args.steps), decay_steps=10,
                    moment_dtype=cfg.opt_dtype)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    print(f"training {args.arch} ({'full' if args.full else 'reduced'}: "
          f"{cfg.num_layers}L d={cfg.d_model}) for {args.steps} steps",
          flush=True)
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_") as tmp:
        out = run(cfg, opt, steps=args.steps, batch=args.batch,
                  seq_len=args.seq_len, microbatches=args.microbatches,
                  ckpt_dir=args.ckpt_dir or tmp,
                  ckpt_every=args.ckpt_every,
                  compress_grads=args.compress_grads, seed=args.seed,
                  device=device)
    sup = out["supervisor"]
    losses = [e["loss"] for e in sup.log if e["event"] == "step"]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} in "
          f"{time.time() - t0:.0f}s ({len(losses)} steps, "
          f"{sup.restarts} restarts)", flush=True)
    s = out["seconds"]
    out["first_step_s"] = s[0]
    out["step_s"] = statistics.median(s[1:]) if len(s) > 1 else s[0]
    out["tokens_per_s"] = args.batch * args.seq_len / out["step_s"]
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if on_card else None
    if on_card:
        print(f"seconds per step {out['step_s']:.3f} (median after the "
              f"first; first {s[0]:.3f}), {out['tokens_per_s']:.0f} tokens/s, "
              f"peak memory {out['peak_bytes'] / 1e9:.2f} GB on "
              f"{torch.cuda.get_device_name(device)}", flush=True)
    out["losses"] = losses
    out["grad_norms"] = [m["grad_norm"] for m in out["metrics"]]
    out["finite"] = bool(np.isfinite(losses + out["grad_norms"]).all())
    return out


if __name__ == "__main__":
    main()
