"""Roofline terms from a counted run of a cell (the dry-run).

Counterpart of ``repro/launch/roofline.py``, which reads XLA's compiled
artifact: ``cost_analysis()`` for FLOPs and bytes, and the optimized
HLO's collectives.  Here a cell runs once under ``FakeTensorMode`` (no
buffer is allocated) inside ``CostMode``, a dispatch mode that sees
every operation one chip runs: DTensor operations are let through
(``NotImplemented``) until DTensor has lowered them to the chip's local
operations and collectives, which the mode counts.

    compute term    = FLOPs      / hw.peak_flops   (per chip)
    memory term     = HBM bytes  / hw.hbm_bw
    collective term = coll bytes / hw.ici_bw
    network term    = net bytes  / hw.dcn_bw       (collectives over "pod")

FLOPs: ``torch.utils.flop_counter``'s formulas on each local operation
(matrix products, attention, convolutions; elementwise work is not
counted, as XLA's ``flops`` counts it little).  HBM bytes: the inputs
read and outputs written of every operation that is not a view, each
time it runs (XLA's "bytes accessed" convention, without fusion).
Collective bytes, under the reference's conventions (ring algorithms, per
chip): an all-reduce counts twice its operand (its reduce-scatter and
all-gather phases), an all-gather its result, a reduce-scatter and an
all-to-all their operand.  A collective whose group is the "pod" axis is
charged to the network (the reference's DCN), the others to the links
inside a pod (ICI / NVLink).  ``peak_temp_bytes``: the most bytes that
tensors the run created held at once (each counted from the operation
that made it until the last reference to it or to a view of it goes;
the cell's arguments not included).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.perfmodel.hw import H100, HardwareSpec

_COLLECTIVES = {"all_reduce": "all-reduce",
                "all_reduce_coalesced": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast"}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for t in x:
            yield from _tensors(t)


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


class CostMode(TorchDispatchMode):
    """Counts one chip's FLOPs, HBM bytes, collective bytes by op (and the
    network's share) and the peak of the bytes its tensors hold, over the
    operations run under it.  ``net_groups``: the names of the process
    groups whose collectives cross the network."""

    def __init__(self, net_groups=()):
        super().__init__()
        # DTensor infers an operation's output by running it on fake copies
        # of its global arguments, through this mode too: such an operation
        # is not one a chip runs, and is not counted
        self.inferring = 0
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.net_groups = set(net_groups)
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.coll_by_op: Dict[str, float] = {}
        self.net_bytes = 0.0
        self.live = 0
        self.peak = 0
        self.ops = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as prop
        infer, mode = prop._propagate_tensor_meta_non_cached, self

        def counted_apart(*a, **k):
            mode.inferring += 1
            try:
                return infer(*a, **k)
            finally:
                mode.inferring -= 1

        prop._propagate_tensor_meta_non_cached = counted_apart
        self._restore = lambda: setattr(
            prop, "_propagate_tensor_meta_non_cached", infer)
        return super().__enter__()

    def __exit__(self, *exc):
        self._restore()
        return super().__exit__(*exc)

    def _free(self, n):
        self.live -= n

    def _collective(self, name, args, out):
        op = _COLLECTIVES[name]
        if op == "all-gather":
            nbytes = _nbytes(out)
        else:
            nbytes = _nbytes(args[0])
            if op == "all-reduce":
                nbytes *= 2               # RS + AG phases of a ring AR
        self.coll_by_op[op] = self.coll_by_op.get(op, 0.0) + nbytes
        group = [a for a in args if isinstance(a, str)][-1:]   # its name
        group = group[0] if group else None
        if group in self.net_groups:
            self.net_bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented         # counted once lowered to a chip's
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inferring:
            return out
        packet = func._overloadpacket
        ns = packet._qualified_op_name.split("::")[0]
        name = packet.__name__
        if ns in ("_c10d_functional", "c10d_functional"):
            if name in _COLLECTIVES:
                self._collective(name, args, out)
            return out
        if packet in self.flop_registry:
            self.flops += self.flop_registry[packet](*args, **kwargs,
                                                     out_val=out)
        returns = func._schema.returns
        alias = [r.alias_info for r in returns]
        if returns and all(a is not None and not a.is_write for a in alias):
            return out                    # a view: no bytes move
        self.ops += 1
        self.hbm_bytes += _nbytes(args) + _nbytes(list(kwargs.values())) + \
            (0 if any(a is not None for a in alias) else _nbytes(out))
        if not any(a is not None for a in alias):
            for t in _tensors(out):
                n = t.numel() * t.element_size()
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class RooflineTerms:
    """Per-chip FLOPs, HBM bytes and collective bytes of one cell (as the
    reference's, from its counted run); ``terms()`` divides by one chip's
    peaks."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float                        # per device
    hbm_bytes: float                    # per device
    coll_bytes: float                   # per device
    coll_by_op: Dict[str, float]
    model_flops: float                  # whole-model (all chips)
    peak_mem_per_chip: float = 0.0
    net_bytes: float = 0.0              # per device, over "pod"

    def terms(self, hw: HardwareSpec = H100):
        t_compute = self.flops / hw.peak_flops
        t_mem = self.hbm_bytes / hw.hbm_bw
        t_coll = (self.coll_bytes - self.net_bytes) / hw.ici_bw + \
            self.net_bytes / hw.dcn_bw
        return t_compute, t_mem, t_coll

    @property
    def total_flops(self) -> float:
        return self.flops * self.chips

    @property
    def bottleneck(self) -> str:
        tc, tm, tl = self.terms()
        return ["compute", "memory", "collective"][
            [tc, tm, tl].index(max(tc, tm, tl))]

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs of all chips: remat, padding,
        replicated work."""
        return self.model_flops / self.total_flops if self.flops else 0.0

    def roofline_fraction(self, hw: HardwareSpec = H100) -> float:
        """The time the model's useful FLOPs would take at peak over the
        modelled step time."""
        tc, tm, tl = self.terms(hw)
        t_step = max(tc, tm) + tl
        t_bound = self.model_flops / (self.chips * hw.peak_flops)
        return min(1.0, t_bound / max(t_step, 1e-12))


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS baseline: 6*N_active*D trained tokens, or 2*N_active*D
    inferred tokens (+ attention context reads are not counted — this is
    the deliberately-conservative 'useful work' yardstick)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # one token per sequence


def analyze(cost: CostMode, cfg, shape, mesh_name: str, chips: int,
            arch: Optional[str] = None,
            arg_bytes: float = 0.0) -> RooflineTerms:
    """``cost``: a ``CostMode`` the cell ran under; ``arg_bytes``: the
    bytes of the cell's arguments on one chip (parameters, optimizer
    state, cache), added to the temporaries' peak."""
    return RooflineTerms(
        arch=arch or cfg.name, shape=shape.name, mesh=mesh_name,
        chips=chips, flops=float(cost.flops), hbm_bytes=cost.hbm_bytes,
        coll_bytes=sum(cost.coll_by_op.values()),
        coll_by_op=dict(cost.coll_by_op),
        model_flops=model_flops_for(cfg, shape),
        peak_mem_per_chip=arg_bytes + cost.peak, net_bytes=cost.net_bytes)
