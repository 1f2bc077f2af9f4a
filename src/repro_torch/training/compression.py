"""Gradient compression: int8 blocks of 256 with a float32 scale each.

Counterpart of ``repro/training/compression.py``.  Each leaf is flattened
in float32, padded with zeros to whole blocks, and each block stored as
round(x / scale) clipped to [-127, 127], scale = max|x| / 127 floored at
1e-12.  ``torch.round`` rounds half to even as ``jnp.round`` does, so on
the same input ``q`` and ``scale`` are the reference's exactly.  The
round trip (quantize, then dequantize) stands for the int8 all-reduce a
multi-card run would send; one card has no reduction to send it over.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK = 256


def _quantize(g):
    flat = g.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = F.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(g.shape), pad


def _dequantize(q, scale, shape, pad):
    flat = (q.float() * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape)


def compress_gradients(grads):
    """{name: gradient} -> {name: (q int8 (n, 256), scale f32 (n, 1),
    shape, pad)}."""
    return {n: _quantize(g) for n, g in grads.items()}


def decompress_gradients(compressed):
    return {n: _dequantize(*t) for n, t in compressed.items()}
