"""Primitive layers: norms, activations, RoPE, embeddings, and parameter init.

Counterpart of ``repro/models/layers.py``.  Weights keep the reference's
(in, out) layout, so ``x @ w`` is the reference's ``einsum("bsd,dh")``.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn


class ParamInit:
    """Draws parameters as the reference does: normal * 1/sqrt(fan_in)
    (fan_in = shape[0]) unless a scale is given, ones, or zeros; drawn in
    float32 from an explicit ``torch.Generator`` on ``device``, then cast.
    With no generator, ``normal`` leaves the tensor uninitialised for a
    caller that loads weights (``convert.py``)."""

    def __init__(self, generator, device, dtype):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def normal(self, *shape, scale=None) -> nn.Parameter:
        if self.generator is None:
            return nn.Parameter(torch.empty(shape, device=self.device,
                                            dtype=self.dtype),
                                requires_grad=False)
        scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
        x = torch.randn(shape, generator=self.generator, device=self.device,
                        dtype=torch.float32).mul_(scale)
        return nn.Parameter(x.to(self.dtype), requires_grad=False)

    def ones(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.ones(shape, device=self.device,
                                       dtype=self.dtype), requires_grad=False)

    def zeros(self, *shape) -> nn.Parameter:
        return nn.Parameter(torch.zeros(shape, device=self.device,
                                        dtype=self.dtype), requires_grad=False)


def rmsnorm(x, w, eps: float = 1e-5):
    """f32 statistics, cast to x's dtype, then scale by w (reference order)."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh"),
            "relu": F.relu}[name]


def rope_cos_sin(positions, head_dim: int, theta: float,
                 dtype=torch.float32):
    """positions (..., S) -> cos/sin (..., S, head_dim//2)."""
    half = head_dim // 2
    # theta stays a Python scalar: a device tensor made from it would be a
    # blocking host-to-device copy in every layer
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope(x, cos, sin):
    """Half-split rotation.  x (..., S, H, D); cos/sin (..., S, D/2)
    broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def embed_tokens(model, tokens):
    return F.embedding(tokens.long(), model.tok)


def lm_logits(model, x):
    """Final norm, then the (tied) LM head over the padded vocab."""
    w = model.tok.t() if model.cfg.tie_embeddings else model.lm_head
    return rmsnorm(x, model.final_norm, model.cfg.norm_eps) @ w
