"""Mamba (S6) selective-state-space mixer.

Counterpart of ``repro/models/mamba.py``.  Prefill runs the selective scan
on the path the caller chooses: ``kernel`` (``ops.ssm_scan``, the CUDA
kernel on the card; its plain version on a CPU tensor) or ``ref`` (the
plain sequential scan, ``ref.ssm_scan``).  Both start from a zero state,
or from a given ``state`` (conv window and SSM state) to continue a
sequence, as the reference's ``mamba_forward(state=)`` does; the serving
path prefills whole prompts, from zero.  Decode is the reference's O(1)
single-token step in plain PyTorch; the reference has no kernel for it
either.

The recurrent state of one sequence takes the place of its KV cache:
the conv window ``conv`` (d_conv-1, din) in the model dtype and the SSM
state ``ssm`` (din, ds) in float32.  ``A_log`` and ``D`` stay float32 in
a bf16 model, as in the reference.

The two halves of the mixer between its projections (``prefill_mixer``
and ``decode_mixer``) are separate so that the concurrent step runs one
``in_proj`` and one ``out_proj`` product over its prefill and decode rows.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import sharding
from repro_torch.kernels import ops, ref
from repro_torch.models.attention import check_impl
from repro_torch.models.layers import ParamInit, mm


class Mamba(nn.Module):
    """in_proj (d, 2 din), conv_w (d_conv, din), conv_b (din,),
    x_proj (din, R + 2 ds), dt_proj (R, din), dt_bias (din,),
    A_log (din, ds) f32, D (din,) f32, out_proj (din, d)."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        m = cfg.mamba
        d, din, R = cfg.d_model, cfg.d_inner, cfg.dt_rank
        self.in_proj = init.normal(d, 2 * din)
        self.conv_w = init.normal(m.d_conv, din)
        self.conv_b = init.zeros(din)
        self.x_proj = init.normal(din, R + 2 * m.d_state)
        self.dt_proj = init.normal(R, din)
        self.dt_bias = init.zeros(din)
        a = torch.arange(1, m.d_state + 1, device=init.device,
                         dtype=torch.float32)
        self.A_log = nn.Parameter(torch.log(a).expand(din, -1).contiguous(),
                                  requires_grad=False)
        self.D = nn.Parameter(torch.ones(din, device=init.device,
                                         dtype=torch.float32),
                              requires_grad=False)
        self.out_proj = init.normal(din, d)


def param_specs(cfg) -> dict:
    """The logical axes of each parameter (the reference's specs): the
    inner width over "model"."""
    return {"in_proj": (None, "model"), "conv_w": (None, "model"),
            "conv_b": ("model",), "x_proj": ("model", None),
            "dt_proj": (None, "model"), "dt_bias": ("model",),
            "A_log": ("model", None), "D": ("model",),
            "out_proj": ("model", None)}


STATE_SPECS = {"conv": ("batch", None, "model"),
               "ssm": ("batch", "model", None)}


def ssm_inputs(p: Mamba, cfg, xs):
    """xs (..., din) -> dt (..., din), Bm/Cm (..., ds), all float32."""
    R, ds = cfg.dt_rank, cfg.mamba.d_state
    dt, Bm, Cm = torch.split(mm(xs, p.x_proj), [R, ds, ds], dim=-1)
    dt = F.softplus((mm(dt, p.dt_proj) + p.dt_bias).float())
    return dt, Bm.float(), Cm.float()


def _window(cfg, x, conv):
    """x (B, L, din) behind the d_conv-1 inputs before it: ``conv``
    (B, d_conv-1, din), or zeros at the start of a sequence."""
    if conv is None:
        return F.pad(x, (0, 0, cfg.mamba.d_conv - 1, 0))
    return torch.cat([conv.to(x.dtype), x], dim=1)


def causal_conv(p: Mamba, cfg, x, conv=None):
    """Depthwise causal conv of x (B, L, din), from the window ``conv``
    (B, d_conv-1, din) or from zeros."""
    k, L = cfg.mamba.d_conv, x.shape[1]
    xp = _window(cfg, x, conv)
    return sum(xp[:, i:i + L] * p.conv_w[i] for i in range(k)) + p.conv_b


def conv_tail(cfg, xs_raw, conv=None):
    """The last d_conv-1 pre-activation conv inputs, for decode to
    continue from; taken from the window ``conv`` (or zeros) too when the
    prompt is shorter."""
    full = _window(cfg, xs_raw, conv)
    return full[:, full.shape[1] - (cfg.mamba.d_conv - 1):]


def scan_args(p: Mamba, cfg, xz, conv=None):
    """The selective scan's arguments for prompts (or their next chunks).
    xz (B, L, 2 din), the ``in_proj`` output; ``conv`` the window before
    it, or None at the start.  Returns xs (B, L, din), dt, A (din, ds),
    Bm, Cm (B, L, ds), all float32."""
    xs = F.silu(causal_conv(p, cfg, xz[..., :cfg.d_inner], conv))
    dt, Bm, Cm = ssm_inputs(p, cfg, xs)
    return xs.float(), dt, -torch.exp(p.A_log), Bm, Cm


def prefill_mixer(p: Mamba, cfg, xz, *, impl: str, state=None):
    """The mixer between its projections over whole prompts, or over their
    next tokens from ``state`` {"conv", "ssm"} as ``decode_mixer`` takes it.
    xz (B, L, 2 din), the ``in_proj`` output.  Returns the gated y
    (B, L, din) in xz's dtype and the final state {"conv", "ssm"}."""
    check_impl(impl)
    din = cfg.d_inner
    xs_raw, z = xz[..., :din], xz[..., din:]
    conv, h0 = (None, None) if state is None else (state["conv"],
                                                   state["ssm"])
    args = scan_args(p, cfg, xz, conv)
    scan = ops.ssm_scan if impl == "kernel" else ref.ssm_scan
    if sharding.is_dtensor(args[0]):
        y, h_last = _scan_shards(scan, args, h0)
    else:
        y, h_last = scan(*args, h0=h0)
    y = y + args[0] * p.D
    y = y.to(xz.dtype) * F.silu(z)
    return y, {"conv": conv_tail(cfg, xs_raw, conv), "ssm": h_last}


def _scan_shards(scan, args, h0):
    """The scan under a mesh, on each chip's sequences with every channel
    (the inputs gathered over the other axes): the scan is independent
    across sequences."""
    from torch.distributed.tensor import Replicate, Shard

    def batch_only(t):
        if t is None:
            return None
        return t.redistribute(t.device_mesh, [
            pl if pl == Shard(0) and t.dim() == 3 else Replicate()
            for pl in t.placements])

    xs, dt, A, Bm, Cm = [batch_only(t) for t in args]
    # A holds no batch dim: each chip's gradient of it is its sequences'
    A = sharding.local_weight(A, xs)
    return sharding.on_shards(lambda *a: scan(*a[:5], h0=a[5]), xs, dt, A,
                              Bm, Cm, batch_only(h0), like=(xs, xs))


def decode_mixer(p: Mamba, cfg, xz, state):
    """The mixer between its projections for one token per row.
    xz (B, 2 din); state {"conv" (B, d_conv-1, din), "ssm" (B, din, ds)
    f32}.  Returns the gated y (B, din) and the new state."""
    din = cfg.d_inner
    xs_raw, z = xz[..., :din], xz[..., din:]
    conv_in = torch.cat([state["conv"].to(xz.dtype), xs_raw[:, None]], dim=1)
    xs = F.silu(sum(conv_in[:, i] * p.conv_w[i]
                    for i in range(cfg.mamba.d_conv)) + p.conv_b)
    dt, Bm, Cm = ssm_inputs(p, cfg, xs)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt[..., None] * A)                      # (B, din, ds)
    b = (dt * xs.float())[..., None] * Bm[:, None]
    h = a * state["ssm"] + b
    y = torch.einsum("bds,bs->bd", h, Cm) + xs.float() * p.D
    y = y.to(xz.dtype) * F.silu(z)
    return y, {"conv": conv_in[:, 1:], "ssm": h}


def mamba_forward(p: Mamba, cfg, x, *, impl: str = "kernel", state=None):
    """Prefill from a zero state, or from ``state`` {"conv" (B, d_conv-1,
    din), "ssm" (B, din, ds) f32}.  x (B, L, d) -> (out (B, L, d), final
    state)."""
    y, state = prefill_mixer(p, cfg, mm(x, p.in_proj), impl=impl,
                             state=state)
    return mm(y, p.out_proj), state


def mamba_decode_step(p: Mamba, cfg, x, state):
    """Single-token decode.  x (B, 1, d); state as ``decode_mixer``.
    Returns (out (B, 1, d), new state)."""
    y, new_state = decode_mixer(p, cfg, x[:, 0] @ p.in_proj, state)
    return (y @ p.out_proj)[:, None], new_state
