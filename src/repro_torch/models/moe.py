"""Feed-forward blocks: the dense FFN (GLU and plain forms) and the
Mixture-of-Experts FFN.  Counterpart of ``repro/models/moe.py``.

The MoE FFN computes the reference's grouped top-k dispatch exactly,
dropped tokens included: tokens are processed in groups of ``g``; per
group each expert has a capacity buffer of C rows; a (token, choice) pair
takes the next row of its expert's buffer in the group's token-major,
then choice, order, and is dropped when the buffer is full.  The
reference builds one-hot dispatch and combine tensors and contracts them
with einsums; here each pair's buffer row is computed as an index, the
buffers are filled by one gather, and the combine gathers each pair's
expert output back.  The expert products are the reference's
``"necd,edf->necf"``: one batched matrix product over the E capacity
buffers of N*C rows each.  Every shape follows from the input's shape
and the config, so no step waits on the device.

Expert partitioning (``moe_partition``) picks the reference's specs
(``param_specs``): "ep" shards the experts over the data axis, "tp"
replicates them there with d FSDP-sharded; both shard each expert's
hidden dim over "model".  Under a mesh (DTensor inputs) the layer runs on
each chip's tokens (``on_shards``): the experts are gathered over the
data axis, each chip computes its hidden slice for its own groups of
tokens, and the partial outputs are summed over "model".  The
reference's GShard all-to-all (tokens to their experts' chips) is not
ported: gathering the experts moves the weights, not the tokens.  The
groups are the ones the whole batch would have (``moe_plan`` of every
token), which each chip's share of the tokens holds whole.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch import sharding
from repro_torch.models.layers import ParamInit, act_fn, mm


class DenseFFN(nn.Module):
    """w_gate (d, f) when GLU, w_in (d, f), w_out (f, d)."""

    def __init__(self, init: ParamInit, cfg):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.ffn_glu:
            self.w_gate = init.normal(d, f)
        self.w_in = init.normal(d, f)
        self.w_out = init.normal(f, d)


def init_dense_ffn(init: ParamInit, cfg, tp: int = 1) -> DenseFFN:
    return DenseFFN(init, cfg)


def dense_specs(cfg) -> dict:
    specs = {"w_in": (None, "model"), "w_out": ("model", None)}
    if cfg.ffn_glu:
        specs["w_gate"] = (None, "model")
    return specs


def dense_ffn(p: DenseFFN, cfg, x, constrain=sharding.identity):
    act = act_fn(cfg.act)
    if cfg.ffn_glu:
        h = act(mm(x, p.w_gate)) * mm(x, p.w_in)
    else:
        h = act(mm(x, p.w_in))
    h = constrain(h, ("batch",) + (None,) * (x.dim() - 2) + ("model",))
    return mm(h, p.w_out)


class MoEFFN(nn.Module):
    """router (d, E), w_gate/w_in (E, d, f), w_out (E, f, d).

    Random expert weights are drawn at 1/sqrt(d) and 1/sqrt(f), their
    fan-in.  The reference draws every parameter at 1/sqrt(shape[0]),
    which for an expert tensor is 1/sqrt(E): at Mixtral's widths that
    makes each MoE output some 1e4 times an attention output, and the
    attention kernels would no longer move the logits of a random model.
    Weights converted from the reference (``convert.py``) are its own."""

    def __init__(self, init: ParamInit, cfg, tp: int = 1):
        super().__init__()
        self.tp = tp
        m = cfg.moe
        d, E, f = cfg.d_model, m.num_experts, m.d_ff_expert
        self.router = init.normal(d, E)
        self.w_gate = init.normal(E, d, f, scale=1.0 / math.sqrt(d))
        self.w_in = init.normal(E, d, f, scale=1.0 / math.sqrt(d))
        self.w_out = init.normal(E, f, d, scale=1.0 / math.sqrt(f))


def init_moe(init: ParamInit, cfg, tp: int = 1) -> MoEFFN:
    return MoEFFN(init, cfg, tp)


def moe_partition(cfg, tp: int) -> str:
    """'ep': experts sharded over the data axis, hidden over model.  'tp':
    experts replicated over data with d FSDP-sharded, hidden over model:
    where E does not divide the axis (Mixtral's 8 experts on 16)."""
    m = cfg.moe
    if m.partition != "auto":
        return m.partition
    return "ep" if m.num_experts % tp == 0 else "tp"


def moe_specs(cfg, tp: int = 1) -> dict:
    if moe_partition(cfg, tp) == "ep":
        w_in, w_out = ("expert", None, "model"), ("expert", "model", None)
    else:
        w_in, w_out = (None, "data", "model"), (None, "model", "data")
    return {"router": (None, None), "w_gate": w_in, "w_in": w_in,
            "w_out": w_out}


def moe_plan(T: int, moe, *, group_size: int = 256, dropless: bool = False,
             inference: bool = False):
    """The reference's groups and capacity for T tokens: (g, N, C).

    g = min(group_size, T), decremented until it divides T; N = T // g.
    Capacity policy:
      * dropless  — C = g, exact (decode);
      * inference — capacity factor max(cf, 2.0), and dropless when
        g <= 64 (serving prefill);
      * default   — cf (1.25; training).
    """
    g = min(group_size, T)
    while T % g:
        g -= 1
    if inference and g <= 64:
        dropless = True
    if dropless:
        C = g
    else:
        cf = max(moe.capacity_factor, 2.0) if inference else \
            moe.capacity_factor
        C = max(1, math.ceil(g * moe.top_k / moe.num_experts * cf))
    return g, T // g, C


def choose_experts(probs, k: int):
    """The top ``k`` of router probabilities (T, E): (gates, experts),
    each (T, k), highest first.  A stable sort keeps the lower expert
    first among equal gates, as jax.lax.top_k does."""
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    return gates[:, :k], experts[:, :k]


def route(p: MoEFFN, cfg, x, *, group_size: int = 256,
          dropless: bool = False, inference: bool = False):
    """The dispatch of x (..., d): gates (T, k) in float32 and each
    (token, choice) pair's row in the (E * N * C) capacity buffers, or
    E * N * C where the pair is dropped.  Returns (gates, rows, (g, N, C))."""
    m = cfg.moe
    E, k = m.num_experts, m.top_k
    T = x.numel() // x.shape[-1]
    g, N, C = moe_plan(T, m, group_size=group_size, dropless=dropless,
                       inference=inference)
    probs = torch.softmax((x.reshape(T, -1) @ p.router).float(), dim=-1)
    gates, experts = choose_experts(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # place of each pair in its expert's buffer: a running count over the
    # group's (token, choice) pairs, token-major, as the reference's cumsum
    chosen = experts.reshape(N, g * k, 1)
    onehot = (chosen == torch.arange(E, device=x.device)).int()
    place = (onehot.cumsum(1) - 1).gather(2, chosen).reshape(T, k)
    group = torch.arange(T, device=x.device) // g
    rows = experts * (N * C) + group[:, None] * C + place
    rows = torch.where(place < C, rows, E * N * C)
    return gates, rows, (g, N, C)


def moe_ffn(p: MoEFFN, cfg, x, *, group_size: int = 256,
            dropless: bool = False, inference: bool = False,
            constrain=sharding.identity):
    """x (..., d) -> (..., d): ``repro/models/moe.py`` ``moe_ffn``, drops
    included (``moe_plan`` gives the policy)."""
    if sharding.is_dtensor(x):
        return _moe_shards(p, cfg, x, group_size=group_size,
                           dropless=dropless, inference=inference,
                           constrain=constrain)
    m = cfg.moe
    act = act_fn(cfg.act)
    E, k, d = m.num_experts, m.top_k, x.shape[-1]
    xt = x.reshape(-1, d)
    T = xt.shape[0]
    gates, rows, (g, N, C) = route(p, cfg, x, group_size=group_size,
                                   dropless=dropless, inference=inference)
    # the token of each buffer row; T (a zero row) where the row is empty
    # or where dropped pairs land (row E*N*C, cut off)
    token = torch.full((E * N * C + 1,), T, dtype=torch.long,
                       device=x.device)
    token[rows.reshape(-1)] = torch.arange(T, device=x.device) \
        .repeat_interleave(k)
    expert_in = torch.cat([xt, xt.new_zeros(1, d)])[token[:-1]] \
        .view(E, N * C, d)
    h = act(torch.bmm(expert_in, p.w_gate))
    h.mul_(torch.bmm(expert_in, p.w_in))      # in place: one buffer fewer
    # each buffer is freed once read: at a prefill whose groups are small
    # (g = 2 at a 1762-token prompt) the capacity buffers hold E / k times
    # the kept pairs, up to 1.85 GB each at Qwen3-MoE's widths, beside
    # the engine's KV pool
    del expert_in
    out = torch.bmm(h, p.w_out).view(E * N * C, d)
    del h
    kept = rows < E * N * C
    picked = out[torch.where(kept, rows, 0)]
    picked.masked_fill_(~kept[..., None], 0)             # dropped pairs: 0
    y = (gates.to(x.dtype)[..., None] * picked).sum(1)
    return y.view(x.shape)


def _moe_shards(p: MoEFFN, cfg, x, *, group_size, dropless, inference,
                constrain):
    """``moe_ffn`` under a mesh (the module docstring): each chip routes
    its own tokens in the whole batch's groups, with the experts gathered
    over every axis but "model", which splits their hidden dim; the
    partial outputs are summed over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    # the hidden dim split over "model" where the rules put it there
    m = names.index("model") if "model" in names else None
    split = m is not None and p.w_gate.placements[m] == Shard(2)

    def layout(dim):
        return [Shard(dim) if split and dim is not None and a == "model"
                else Replicate() for a in names]

    spec = ("batch",) + (None,) * (x.dim() - 1)
    x = constrain(x, spec)
    if split and x.placements[m] != Replicate():
        x = x.redistribute(mesh, [Replicate() if i == m else pl
                                  for i, pl in enumerate(x.placements)])
    g = moe_plan(x.numel() // x.shape[-1], cfg.moe, group_size=group_size,
                 dropless=dropless, inference=inference)[0]
    if (x.to_local().numel() // x.shape[-1]) % g:
        # a group spans chips: every chip routes every token
        x = x.redistribute(mesh, [Replicate()] * mesh.ndim)
    # with the hidden dim split, what reaches the output from a whole
    # tensor is a partial sum on each chip, and so is its gradient
    partial = (m,) if split else ()
    local = sharding.Leaves(**{
        name: sharding.local_weight(
            getattr(p, name).redistribute(mesh, layout(dim)), x, partial)
        for name, dim in (("router", None), ("w_gate", 2), ("w_in", 2),
                          ("w_out", 1))})
    # the chip's own groups, whole: a capacity sized for the global groups
    y = moe_ffn(local, cfg, sharding.local_weight(x, x, partial),
                group_size=g, dropless=dropless, inference=inference)
    place = [Partial() if split and a == "model" else pl
             for a, pl in zip(names, x.placements)]
    y = DTensor.from_local(y, mesh, place, run_check=False)
    return constrain(y, spec)
