"""Feed-forward blocks.  Counterpart of ``repro/models/moe.py``; this slice
ports the dense FFN only (GLU and plain forms)."""
from __future__ import annotations

from torch import nn

from repro_torch.models.layers import ParamInit, act_fn


class DenseFFN(nn.Module):
    """w_gate (d, f) when GLU, w_in (d, f), w_out (f, d)."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.ffn_glu:
            self.w_gate = init.normal(d, f)
        self.w_in = init.normal(d, f)
        self.w_out = init.normal(f, d)


def init_dense_ffn(init: ParamInit, cfg) -> DenseFFN:
    return DenseFFN(init, cfg)


def dense_ffn(p: DenseFFN, cfg, x):
    act = act_fn(cfg.act)
    if cfg.ffn_glu:
        h = act(x @ p.w_gate) * (x @ p.w_in)
    else:
        h = act(x @ p.w_in)
    return h @ p.w_out
