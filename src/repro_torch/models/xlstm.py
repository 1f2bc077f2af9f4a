"""xLSTM mixers: mLSTM (matrix memory, chunkwise) and sLSTM (scalar memory).

Counterpart of ``repro/models/xlstm.py``: full sequences (training and
prefill) and the O(1) decode steps (``mlstm_decode_step``,
``slstm_decode_step``) on a state row per sequence.  The reference has no
Pallas kernel for either mixer, so both run in plain PyTorch.

mLSTM, pre-up-projection block (proj factor 2): the sequence runs in
chunks of 128, the last one shorter; within a chunk the gated quadratic
form is computed in parallel, and the stabilised matrix state (C, n, m)
is carried from chunk to chunk.  The reference takes the largest divisor
of the length not above 128, which is 2 for a 1762-token prompt (881
chunks); the two differ only in float32 rounding.
The exp input gate and the log-sigmoid forget gate are kept in log space
under the max-stabiliser m, and the normaliser is floored at
max(|den|, exp(-m)), as in the reference.

sLSTM: scalar memory with head-block-diagonal recurrent weights.  It is
sequential (h_{t-1} feeds the gates), so it runs token by token; the
input projections W_g x_t are not recurrent and are computed for the
whole sequence first, and the token loop runs in chunks of 64 (the last
one shorter), each one
autograd node that keeps only its inputs and recomputes the chunk in
its backward (``_SLSTMChunk``), so the backward holds one chunk's
per-token values at a time (``lm_loss`` leaves an sLSTM layer out of its
per-layer remat for that reason).  A GLU up-projection (factor 4/3)
follows the cell.

States are float32: mLSTM {"C" (B,H,Dh,Dh), "n" (B,H,Dh), "m" (B,H)},
sLSTM {"c", "n", "h", "m"} each (B,d).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import ParamInit

NEG_INF = -1e30
GATES = ("z", "i", "f", "o")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_dims(cfg):
    """(din, H, Dh): the inner width padded to a multiple of the heads."""
    x = cfg.xlstm
    H = x.num_heads
    din = int(math.ceil(int(x.proj_factor * cfg.d_model) / H) * H)
    return din, H, din // H


class MLSTM(nn.Module):
    """w_up (d, 2 din), wq/wk/wv (din, din), w_i/w_f (din, H),
    b_i/b_f (H,) (the forget bias starts at 3), w_down (din, d)."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        d = cfg.d_model
        din, H, _ = mlstm_dims(cfg)
        self.w_up = init.normal(d, 2 * din)
        self.wq = init.normal(din, din)
        self.wk = init.normal(din, din)
        self.wv = init.normal(din, din)
        self.w_i = init.normal(din, H)
        self.b_i = init.zeros(H)
        self.w_f = init.normal(din, H)
        self.b_f = init.full(H, value=3.0)
        self.w_down = init.normal(din, d)


def mlstm_specs(cfg) -> dict:
    """The logical axes of each parameter (the reference's specs)."""
    return {"w_up": (None, "model"), "wq": (None, "model"),
            "wk": (None, "model"), "wv": (None, "model"),
            "w_i": (None, None), "b_i": (None,), "w_f": (None, None),
            "b_f": (None,), "w_down": ("model", None)}


MLSTM_STATE_SPECS = {"C": ("batch", None, None, None),
                     "n": ("batch", None, None), "m": ("batch", None)}


def mlstm_init_state(cfg, batch: int, *, device):
    _, H, Dh = mlstm_dims(cfg)
    f32 = dict(device=device, dtype=torch.float32)
    return {"C": torch.zeros(batch, H, Dh, Dh, **f32),
            "n": torch.zeros(batch, H, Dh, **f32),
            "m": torch.full((batch, H), NEG_INF, **f32)}


def _mlstm_qkvgates(p: MLSTM, cfg, x):
    """x (B,L,d) -> q, k, v (B,L,H,Dh) in x's dtype; log_i, log_f (B,L,H)
    float32; z (B,L,din) the output gate's input."""
    _, H, Dh = mlstm_dims(cfg)
    B, L, _ = x.shape
    xs, z = (x @ p.w_up).chunk(2, dim=-1)
    q = (xs @ p.wq).view(B, L, H, Dh)
    k = (xs @ p.wk).view(B, L, H, Dh) / (Dh ** 0.5)
    v = (xs @ p.wv).view(B, L, H, Dh)
    xs32 = xs.float()
    log_i = xs32 @ p.w_i.float() + p.b_i
    log_f = F.logsigmoid(xs32 @ p.w_f.float() + p.b_f)
    return q, k, v, log_i, log_f, z


def mlstm_chunk_scan(q, k, v, log_i, log_f, state, *, chunk: int = 128):
    """Chunkwise mLSTM.  q/k/v (B,L,H,Dh), gates (B,L,H) float32, state
    {"C", "n", "m"}.  Returns h (B,L,H,Dh) float32 and the final state."""
    B, L, H, Dh = q.shape
    c = min(chunk, L)
    tri = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = (state[k_].float() for k_ in ("C", "n", "m"))
    hs = []
    for s0 in range(0, L, c):
        if L - s0 < c:                  # the last chunk, shorter
            tri = tri[:L - s0, :L - s0]
        qt, kt, vt = (t[:, s0:s0 + c].float() for t in (q, k, v))
        li, lf = log_i[:, s0:s0 + c], log_f[:, s0:s0 + c]    # (B,c,H)
        Fc = torch.cumsum(lf, dim=1)          # inclusive log-f prefix
        # intra-chunk decay D[t,s] = F_t - F_s + log i_s for s <= t
        Dmat = Fc[:, :, None] - Fc[:, None, :] + li[:, None, :, :]
        Dmat = Dmat.masked_fill(~tri[None, :, :, None], NEG_INF)
        m_inter = Fc + m0[:, None]                           # (B,c,H)
        m_t = torch.maximum(Dmat.amax(dim=2), m_inter)
        w_intra = torch.exp(Dmat - m_t[:, :, None])          # (B,t,s,H)
        w_inter = torch.exp(m_inter - m_t)
        sw = torch.einsum("bthd,bshd->btsh", qt, kt) * w_intra
        num = torch.einsum("btsh,bshd->bthd", sw, vt) + \
            w_inter[..., None] * torch.einsum("bthd,bhde->bthe", qt, C0)
        den = sw.sum(dim=2) + w_inter * torch.einsum("bthd,bhd->bth", qt, n0)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state at the end of the chunk
        Fl = Fc[:, -1]                                       # (B,H)
        decay_s = Fl[:, None] - Fc + li                      # (B,c,H)
        m_new = torch.maximum(Fl + m0, decay_s.amax(dim=1))
        w_s = torch.exp(decay_s - m_new[:, None])
        w_0 = torch.exp(Fl + m0 - m_new)
        ks = w_s[..., None] * kt
        C0 = w_0[..., None, None] * C0 + torch.einsum("bshd,bshe->bhde",
                                                      ks, vt)
        n0 = w_0[..., None] * n0 + ks.sum(dim=1)
        m0 = m_new
    return torch.cat(hs, dim=1), {"C": C0, "n": n0, "m": m0}


def mlstm_forward(p: MLSTM, cfg, x, *, state=None, chunk: int = 128):
    """x (B,L,d) from ``state`` (or zero) -> (out (B,L,d), final state)."""
    B, L, _ = x.shape
    din = mlstm_dims(cfg)[0]
    q, k, v, log_i, log_f, z = _mlstm_qkvgates(p, cfg, x)
    st = state if state is not None else \
        mlstm_init_state(cfg, B, device=x.device)
    h, new_state = mlstm_chunk_scan(q, k, v, log_i, log_f, st, chunk=chunk)
    h = h.reshape(B, L, din).to(x.dtype) * F.silu(z)
    return h @ p.w_down, new_state


def mlstm_decode_step(p: MLSTM, cfg, x, state):
    """x (B,1,d) from ``state`` {"C", "n", "m"} -> (out (B,1,d), the new
    state): the recurrent update of one token, in float32."""
    B = x.shape[0]
    din = mlstm_dims(cfg)[0]
    q, k, v, log_i, log_f, z = _mlstm_qkvgates(p, cfg, x)
    q1, k1, v1 = (t[:, 0].float() for t in (q, k, v))         # (B,H,Dh)
    li, lf = log_i[:, 0], log_f[:, 0]                          # (B,H)
    C0, n0, m0 = (state[k_].float() for k_ in ("C", "n", "m"))
    m_t = torch.maximum(lf + m0, li)
    fp = torch.exp(lf + m0 - m_t)
    ip = torch.exp(li - m_t)
    C = fp[..., None, None] * C0 + \
        ip[..., None, None] * (k1[..., :, None] * v1[..., None, :])
    n = fp[..., None] * n0 + ip[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, C)
    den = torch.einsum("bhd,bhd->bh", q1, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]
    h = h.reshape(B, 1, din).to(x.dtype) * F.silu(z)
    return h @ p.w_down, {"C": C, "n": n, "m": m_t}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_dims(cfg):
    """(H, Dh) of the recurrent head blocks."""
    H = cfg.xlstm.num_heads
    if cfg.d_model % H:
        raise ValueError(f"d_model {cfg.d_model} is not a multiple of "
                         f"{H} sLSTM heads")
    return H, cfg.d_model // H


class SLSTM(nn.Module):
    """w_g (d, d), r_g (H, Dh, Dh), b_g (d,) for each gate g in z, i, f, o
    (the forget bias starts at 3); the GLU up_gate/up (d, f), down (f, d),
    f = 4d/3 rounded up to a multiple of 64."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        d = cfg.d_model
        H, Dh = slstm_dims(cfg)
        for g in GATES:
            setattr(self, f"w_{g}", init.normal(d, d))
            setattr(self, f"r_{g}",
                    init.normal(H, Dh, Dh, scale=1.0 / math.sqrt(Dh)))
            setattr(self, f"b_{g}", init.full(d, value=3.0 if g == "f"
                                              else 0.0))
        f = int(math.ceil(4 * d / 3 / 64) * 64)
        self.up_gate = init.normal(d, f)
        self.up = init.normal(d, f)
        self.down = init.normal(f, d)


def slstm_specs(cfg) -> dict:
    """The logical axes of each parameter (the reference's specs)."""
    specs = {"up_gate": (None, "model"), "up": (None, "model"),
             "down": ("model", None)}
    for g in GATES:
        specs.update({f"w_{g}": (None, "model"), f"r_{g}": (None, None, None),
                      f"b_{g}": (None,)})
    return specs


SLSTM_STATE_SPECS = {k: ("batch", None) for k in ("c", "n", "h", "m")}


def slstm_init_state(cfg, batch: int, *, device):
    d = cfg.d_model
    f32 = dict(device=device, dtype=torch.float32)
    return {"c": torch.zeros(batch, d, **f32),
            "n": torch.zeros(batch, d, **f32),
            "h": torch.zeros(batch, d, **f32),
            "m": torch.full((batch, d), NEG_INF, **f32)}


def _slstm_step(c, n, h, m, pre_x, r):
    """One token, every tensor head-major (H, B, Dh) float32: the state
    c, n, h, m; pre_x (H, B, 4 Dh) the token's W_g x_t + b_g of the gates
    z, i, f, o; r (H, Dh, 4 Dh) their recurrent weights side by side, so
    one batched product adds all four R_g h_{t-1}.  Returns the new state
    and the values its backward reads."""
    H, B, Dh = h.shape
    pre = torch.baddbmm(pre_x, h, r).view(H, B, 4, Dh)
    z, log_i, f_pre, o = pre.unbind(2)
    z, o = torch.tanh(z), torch.sigmoid(o)
    a = F.logsigmoid(f_pre) + m
    m_t = torch.maximum(a, log_i)
    fg = torch.exp(a - m_t)
    ig = torch.exp(log_i - m_t)
    c_t = torch.addcmul(fg * c, ig, z)
    n_t = torch.addcmul(ig, fg, n)
    q = torch.clamp(n_t, min=1.0)
    h_t = o * c_t / q
    return (c_t, n_t, h_t, m_t), (f_pre, z, o, a, log_i, fg, ig, q)


class _SLSTMChunk(torch.autograd.Function):
    """The cell over a chunk of tokens, as one autograd node.

    The token loop runs on the host, one small launch per op and token,
    so recording every op for autograd (and checkpointing the chunk, which
    recomputes it) would cost several times the arithmetic.  The forward
    runs without a graph and keeps only the chunk's inputs, as a
    checkpointed chunk does; the backward recomputes the chunk's gate
    values and runs the cell's derivative token by token, in reverse.
    Inputs: the state c, n, h, m (H, B, Dh), pre_x (T, H, B, 4 Dh) and r
    (H, Dh, 4 Dh), all float32; outputs: the final state and h of every
    token (T, H, B, Dh).  Where ``torch.clamp``/``maximum`` meet a tie the
    gradient takes the first argument's side, as autograd's clamp does."""

    @staticmethod
    def forward(ctx, c, n, h, m, pre_x, r):
        ctx.save_for_backward(c, n, h, m, pre_x, r)
        hs = []
        for t in range(pre_x.shape[0]):
            (c, n, h, m), _ = _slstm_step(c, n, h, m, pre_x[t], r)
            hs.append(h)
        return c, n, h, m, torch.stack(hs)

    @staticmethod
    def backward(ctx, dc, dn, dh, dm, dhs):
        c, n, h, m, pre_x, r = ctx.saved_tensors
        T, (H, B, Dh) = pre_x.shape[0], h.shape
        steps = []
        for t in range(T):
            state = (c, n, h, m)
            (c, n, h, m), saved = _slstm_step(c, n, h, m, pre_x[t], r)
            steps.append((state, (c, n, h), saved))
        dpre_x = torch.empty_like(pre_x)
        dr = torch.zeros_like(r)
        for t in range(T - 1, -1, -1):
            (c0, n0, h0, _), (c_t, n_t, h_t), saved = steps[t]
            f_pre, z, o, a, log_i, fg, ig, q = saved
            dh = dh + dhs[t]
            do = dh * c_t / q
            dc = dc + dh * o / q
            dn = dn - (dh * h_t / q) * (n_t >= 1.0)
            dfg = dc * c0 + dn * n0
            dig = dc * z + dn
            dz = dc * ig
            e_f, e_i = dfg * fg, dig * ig
            dm = dm - e_f - e_i
            wa = (a >= log_i).float()
            da = e_f + dm * wa
            dlog_i = e_i + dm * (1 - wa)
            dpre = torch.stack([dz * (1 - z * z), dlog_i,
                                da * torch.sigmoid(-f_pre),
                                do * o * (1 - o)], dim=2).view(H, B, -1)
            dpre_x[t] = dpre
            dr.baddbmm_(h0.transpose(1, 2), dpre)
            dh = torch.bmm(dpre, r.transpose(1, 2))
            dc, dn, dm = dc * fg, dn * fg, da
        return dc, dn, dh, dm, dpre_x, dr


def slstm_forward(p: SLSTM, cfg, x, *, state=None, chunk: int = 64):
    """x (B,L,d) from ``state`` (or zero) -> (out (B,L,d), final state)."""
    B, L, d = x.shape
    H, Dh = slstm_dims(cfg)
    st = state if state is not None else \
        slstm_init_state(cfg, B, device=x.device)
    # the state head-major, (H, B, Dh), as the cell takes it
    leaves = [st[k].float().view(B, H, Dh).transpose(0, 1).contiguous()
              for k in ("c", "n", "h", "m")]
    # the non-recurrent input projections and biases of the four gates,
    # batched over the sequence, in the cell's layout (L, H, B, 4 Dh)
    w = torch.cat([getattr(p, f"w_{g}") for g in GATES], dim=1).float()
    b = torch.cat([getattr(p, f"b_{g}") for g in GATES]).float()
    pre_x = (x.float() @ w + b).view(B, L, 4, H, Dh).permute(
        1, 3, 0, 2, 4).reshape(L, H, B, 4 * Dh)
    r = torch.cat([getattr(p, f"r_{g}") for g in GATES], dim=-1).float()
    c = min(chunk, L)
    hs = []
    for s0 in range(0, L, c):
        *leaves, h = _SLSTMChunk.apply(*leaves, pre_x[s0:s0 + c], r)
        hs.append(h)
    # (L, H, B, Dh) -> (B, L, d)
    h = torch.cat(hs).permute(2, 0, 1, 3).reshape(B, L, d).to(x.dtype)
    y = F.silu(h @ p.up_gate) * (h @ p.up)
    return y @ p.down, {k: v.transpose(0, 1).reshape(B, d) for k, v in
                        zip(("c", "n", "h", "m"), leaves)}


def slstm_decode_step(p: SLSTM, cfg, x, state):
    """x (B,1,d) from ``state`` {"c", "n", "h", "m"} -> (out (B,1,d), the
    new state): one token through ``_slstm_step``'s cell, in float32."""
    B, _, d = x.shape
    H, Dh = slstm_dims(cfg)
    leaves = [state[k].float().view(B, H, Dh).transpose(0, 1)
              for k in ("c", "n", "h", "m")]
    w = torch.cat([getattr(p, f"w_{g}") for g in GATES], dim=1).float()
    b = torch.cat([getattr(p, f"b_{g}") for g in GATES]).float()
    pre_x = (x[:, 0].float() @ w + b).view(B, 4, H, Dh).permute(
        2, 0, 1, 3).reshape(H, B, 4 * Dh)
    r = torch.cat([getattr(p, f"r_{g}") for g in GATES], dim=-1).float()
    new, _ = _slstm_step(*leaves, pre_x, r)
    c, n, h, m = (t.transpose(0, 1).reshape(B, d) for t in new)
    y = h[:, None].to(x.dtype)
    y = F.silu(y @ p.up_gate) * (y @ p.up)
    return y @ p.down, {"c": c, "n": n, "h": h, "m": m}
