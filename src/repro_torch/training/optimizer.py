"""AdamW with a configurable moment dtype, and the WSD schedule.

Counterpart of ``repro/training/optimizer.py``, written as the reference
writes it, in plain tensor ops (not ``torch.optim.AdamW``, whose update
differs: it decays the parameter before the step and leaves norms and
embeddings to the caller's parameter groups):

  * the clip scale min(1, grad_clip / max(|g|, 1e-9)) is folded into each
    leaf's update, so no clipped copy of every gradient is made;
  * the learning rate comes from the incremented count;
  * bias correction divides by 1 - b ** count;
  * weight decay is added to the step of EVERY leaf, norms and
    embeddings included;
  * the moments are stored back in ``moment_dtype`` after each step.

Leaves are updated one at a time, largest first, as the reference orders
them (``:98-121``): only one leaf's float32 temporaries are live at once.
At MiniCPM-2B's widths the embedding's are 1.1 GB each; updating every
leaf at once (``torch._foreach_*``) would hold some 33 GB of them.

Parameters, gradients and moments are dicts of tensors keyed by the
parameter's name (``named_parameters``); the count is an int32 tensor on
the parameters' device, so no step waits on the host.

WSD (warmup-stable-decay) is MiniCPM's schedule (arXiv:2404.06395).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"
    grad_accum_dtype: str = "float32"
    # WSD schedule
    warmup_steps: int = 100
    stable_steps: int = 10_000
    decay_steps: int = 1_000
    min_lr_frac: float = 0.1


def wsd_schedule(step, opt: OptConfig):
    """Warmup -> stable -> (cosine) decay; returns the learning rate as a
    float32 tensor (on ``step``'s device when it is a tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    w, s, d = opt.warmup_steps, opt.stable_steps, opt.decay_steps
    warm = step / max(w, 1)
    in_decay = torch.clamp((step - w - s) / max(d, 1), 0.0, 1.0)
    decay = opt.min_lr_frac + (1 - opt.min_lr_frac) * 0.5 * \
        (1 + torch.cos(math.pi * in_decay))
    return torch.where(step < w, warm, decay) * opt.lr


@dataclasses.dataclass
class AdamWState:
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: torch.Tensor


def adamw_init(params: Dict[str, torch.Tensor], opt: OptConfig) -> AdamWState:
    dt = getattr(torch, opt.moment_dtype)
    dev = next(iter(params.values())).device
    return AdamWState(
        mu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()},
        nu={n: torch.zeros(p.shape, dtype=dt, device=p.device)
            for n, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in grads.values()))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {n: (g.float() * scale).to(g.dtype) for n, g in grads.items()}, gn


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: AdamWState,
                 opt: OptConfig):
    """One AdamW step, written into ``params`` and ``state``'s moments in
    place (each in its own dtype), as the reference's jitted step reuses
    its donated buffers: new copies of MiniCPM-2B's parameters and moments
    beside the old ones would be 27 GB more.  Returns (params, state with
    the incremented count, {"grad_norm", "lr"})."""
    gnorm = global_norm(grads)
    clip_scale = torch.clamp(
        opt.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    lr = wsd_schedule(count, opt)
    b1, b2 = opt.beta1, opt.beta2
    cf = count.float()
    c1 = 1.0 - torch.pow(torch.full_like(cf, b1), cf)
    c2 = 1.0 - torch.pow(torch.full_like(cf, b2), cf)

    def upd(p, g, m, v):
        g32 = g.float() * clip_scale
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + torch.square(g32) * (1 - b2)
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + opt.eps)
        step = step + opt.weight_decay * p.float()
        p.copy_(p.float() - lr * step)      # copy_ rounds as .to() does
        m.copy_(m32)
        v.copy_(v32)

    # biggest leaves first (a stable sort, as the reference's): they set
    # the high-water mark of the temporaries
    for n in sorted(params, key=lambda n: -params[n].numel()):
        upd(params[n], grads[n], state.mu[n], state.nu[n])
    return params, AdamWState(state.mu, state.nu, count), \
        {"grad_norm": gnorm, "lr": lr}
