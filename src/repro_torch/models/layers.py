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
    (fan_in = shape[0]) unless a scale is given, ones, zeros, or a
    constant; drawn in float32 from an explicit ``torch.Generator`` on
    ``device``, then cast.  With no generator, ``normal`` leaves the
    tensor uninitialised for a caller that loads weights (``convert.py``).
    Parameters are made with ``requires_grad=False`` (served models build
    no graph); ``requires_grad_()`` on the model makes it trainable."""

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
        return self.full(*shape, value=1.0)

    def zeros(self, *shape) -> nn.Parameter:
        return self.full(*shape, value=0.0)

    def full(self, *shape, value: float) -> nn.Parameter:
        return nn.Parameter(torch.full(shape, value, device=self.device,
                                       dtype=self.dtype), requires_grad=False)


def chunk_size(n: int, chunk: int) -> int:
    """The largest divisor of n not above ``chunk``: the reference's size
    for a sequence's chunks (xLSTM scans, the chunked cross-entropy)."""
    c = min(chunk, n)
    while n % c:
        c -= 1
    return c


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


def mrope_cos_sin(positions3, head_dim: int, theta: float,
                  sections=(2, 1, 1), dtype=torch.float32):
    """M-RoPE (Qwen2-VL): positions3 (..., S, 3), the (t, h, w) ids ->
    cos/sin (..., S, head_dim//2).  The rotary half is split into
    ``sections`` (in proportion; the last takes the remainder), each
    rotated by its own stream's positions at its own slice of the
    frequencies.  Where the three streams coincide (text) this is RoPE."""
    half = head_dim // 2
    tot = sum(sections)
    sizes = [half * s // tot for s in sections]
    sizes[-1] = half - sum(sizes[:-1])
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions3.device) / half
    freqs = 1.0 / (theta ** exps)
    pos = positions3.float()
    ang, off = [], 0
    for i, sz in enumerate(sizes):
        ang.append(pos[..., i, None] * freqs[off:off + sz])
        off += sz
    ang = torch.cat(ang, dim=-1)
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
