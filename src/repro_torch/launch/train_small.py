"""Train a scaled xLSTM with the whole training substrate: microbatched
gradient accumulation, the WSD schedule, async checkpoints, an injected
failure and restart, and gradient compression; the loss must descend
through all of it.

Counterpart of ``examples/train_small.py``: the reduced xlstm-125m scaled
to 6 layers, d 128 and a vocab of 2048 (about 1.7M parameters), 2
microbatches with compression, an async checkpoint every
``--ckpt-every`` steps (50) and one failure at ``--fail-at``, after
which the supervisor restores the latest checkpoint and goes on with the
next batch.  Prints ``OK`` when the final loss is a nat below the first.

    python -m repro_torch.launch.train_small --steps 60 --fail-at 30 \\
        --ckpt-every 10                                       # on the H100
    PYTHONPATH=src python -m repro_torch.launch.train_small --device cpu
"""
from __future__ import annotations

import argparse
import tempfile
import time

from repro_torch.config import get_reduced_config, replace
from repro_torch.launch.serve_real import resolve_device
from repro_torch.launch.train import run
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.resilience import FailureEvent


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a temporary directory, removed at exit")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=150)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = replace(get_reduced_config("xlstm-125m"),
                  num_layers=6, d_model=128, vocab_size=2048)
    opt = OptConfig(lr=3e-3, warmup_steps=20, stable_steps=args.steps,
                    decay_steps=50, grad_accum_dtype="float32")
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_small_") as tmp:
        out = run(cfg, opt, steps=args.steps, batch=args.batch,
                  seq_len=args.seq_len, microbatches=2,
                  ckpt_dir=args.ckpt_dir or tmp, ckpt_every=args.ckpt_every,
                  compress_grads=True, seed=0, device=device,
                  failures=[FailureEvent(step=args.fail_at)])
    n_params = sum(p.numel() for p in out["state"].model.parameters())
    sup = out["supervisor"]
    losses = [e["loss"] for e in sup.log if e["event"] == "step"]
    dt = time.time() - t0
    print(f"model: {cfg.num_layers}L d={cfg.d_model} "
          f"({n_params / 1e6:.1f}M params)")
    print(f"steps: {len(losses)}  restarts: {sup.restarts}  "
          f"wall: {dt:.0f}s ({dt / max(len(losses), 1) * 1e3:.0f} ms/step)")
    print(f"loss: {losses[0]:.3f} -> min {min(losses):.3f} "
          f"-> final {losses[-1]:.3f}")
    if not losses[-1] < losses[0] - 1.0:
        raise RuntimeError("training failed to learn: loss "
                           f"{losses[0]:.3f} -> {losses[-1]:.3f}")
    print("OK", flush=True)
    out["losses"] = losses
    return out


if __name__ == "__main__":
    main()
