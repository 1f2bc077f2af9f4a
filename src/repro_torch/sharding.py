"""Logical axis names -> mesh axes -> DTensor placements.

Counterpart of ``repro/sharding.py``.  Parameters and activations carry
*logical* axis names ("model", "batch", "data", "expert", "seq", None),
one per dim (``param_specs`` and ``cache_specs`` in
``models/transformer.py``).  A ``ShardingRules`` maps the logical names
to mesh axes for a mesh; ``spec_to_pspec`` turns a spec into a
partition spec (per tensor dim: None, a mesh axis, or a tuple of them,
as JAX's ``PartitionSpec``), dropping an axis that does not divide its
dim; ``to_placements`` turns that into the DTensor placements of the
mesh's dims (``Shard(i)`` or ``Replicate()``).  FSDP also shards one
replicated dim of each large weight over the data axis (ZeRO-3).

Single pod : mesh ("data", "model") = (16, 16)
Multi pod  : mesh ("pod", "data", "model") = (2, 16, 16); "pod" is the
             outermost data-parallel axis (the network), TP stays inside
             a pod, and FSDP stays inside a pod, so parameter all-gathers
             never cross the network.

The port's layer leaves are per layer where the reference stacks them
over periods (a leading dim of ``num_periods`` with logical name None).
``param_sharding`` decides FSDP on the stacked shape, as the reference
does, so that each leaf's local shape is the reference's shard without
its period dim.

``make_constrain(mesh)`` is the reference's ``with_sharding_constraint``
hook: it redistributes a DTensor to a spec's placements.  Without a mesh
it is the identity, and the models compute what they compute without
one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

Axes = Union[str, tuple, None]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    model: Axes = "model"
    batch: Axes = "data"        # activations / tokens
    data: Axes = "data"         # the parameters' FSDP dim
    seq: Axes = None            # sequence (context) parallelism
    # expert parallelism: the expert dim lives on the DATA axis (GShard
    # layout), as the reference's
    expert: Axes = "data"

    def resolve(self, name):
        if name is None:
            return None
        return getattr(self, name)


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def rules_for_mesh(mesh) -> ShardingRules:
    if "pod" in mesh.mesh_dim_names:
        return ShardingRules(batch=("pod", "data"))
    return ShardingRules()


def _axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_sizes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def spec_to_pspec(spec, mesh, rules: ShardingRules, shape=None) -> tuple:
    """A logical spec -> a partition spec (a tuple, one entry a dim: None,
    a mesh axis or a tuple of them).  With ``shape``, an axis that does
    not divide its dim is dropped rather than failing."""
    out = []
    for i, name in enumerate(spec):
        axes = rules.resolve(name)
        if axes is not None and shape is not None:
            if shape[i] % _axis_size(mesh, axes):
                axes = None
        out.append(axes)
    return tuple(out)


def to_placements(pspec, mesh) -> list:
    """A partition spec -> the placements of ``mesh``'s dims: ``Shard(i)``
    on each mesh axis that tensor dim i is split over (a dim over several
    axes is split over them in the mesh's order, as JAX's is), else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    dims = {}
    for i, axes in enumerate(pspec):
        for a in ((axes,) if isinstance(axes, str) else axes or ()):
            if a in dims:
                raise ValueError(f"mesh axis {a!r} shards dims {dims[a]} "
                                 f"and {i} of {pspec}")
            dims[a] = i
    return [Shard(dims[a]) if a in dims else Replicate()
            for a in mesh.mesh_dim_names]


def shard_shape(shape, pspec, mesh) -> tuple:
    """The local shape of a tensor of ``shape`` under ``pspec``."""
    return tuple(n // _axis_size(mesh, axes) for n, axes in zip(shape, pspec))


def _fsdp_spec(spec, shape, mesh, rules: ShardingRules,
               min_size: int = 1 << 20):
    """Shard the first replicated dim over the data axis when it divides.

    Only weights of >= min_size elements: biases and norm scales stay
    replicated.  Leaves that already take the data axis ("expert"/"data"
    logical names) are skipped."""
    if shape is None or int(np.prod(shape)) < min_size:
        return spec
    if any(s in ("data", "expert") for s in spec):
        return spec
    dp = _axis_size(mesh, rules.data)
    if dp == 1:
        return spec
    spec = list(spec)
    # the largest eligible dim (the cheapest all-gather layout)
    cand = [i for i, name in enumerate(spec)
            if name is None and shape[i] % dp == 0]
    if not cand:
        return spec
    best = max(cand, key=lambda i: shape[i])
    spec[best] = "data"
    return tuple(spec)


def param_sharding(specs: dict, shapes: dict, mesh, *,
                   rules: Optional[ShardingRules] = None, fsdp: bool = False,
                   periods: int = 1) -> dict:
    """{leaf name: partition spec} for {name: logical spec} and {name:
    shape}.  A leaf under "layers." is one layer of the reference's leaf
    stacked over ``periods``: FSDP is decided on the stacked shape and
    spec, and the stacked dim is never the one it picks (the reference's
    stacked dim is short beside the widths it competes with; a leaf where
    it would win raises)."""
    rules = rules or rules_for_mesh(mesh)
    out = {}
    for name, spec in specs.items():
        shape = tuple(shapes[name])
        s = tuple(spec)
        if fsdp:
            if name.startswith("layers."):
                full = _fsdp_spec((None,) + s, (periods,) + shape, mesh,
                                  rules)
                if full[0] is not None:
                    raise ValueError(f"{name}: FSDP would shard the stacked "
                                     f"period dim of the reference's leaf")
                s = tuple(full[1:])
            else:
                s = _fsdp_spec(s, shape, mesh, rules)
        out[name] = spec_to_pspec(s, mesh, rules, shape)
    return out


def input_sharding(mesh, *logical_axes,
                   rules: Optional[ShardingRules] = None, shape=None):
    rules = rules or rules_for_mesh(mesh)
    return spec_to_pspec(logical_axes, mesh, rules, shape)


def make_constrain(mesh, rules: Optional[ShardingRules] = None):
    """Returns constrain(a, logical spec): ``a`` redistributed to the
    spec's placements when it is a DTensor on ``mesh``, else ``a``.  With
    no mesh, the identity."""
    if mesh is None:
        return identity
    rules = rules or rules_for_mesh(mesh)
    from torch.distributed.tensor import DTensor

    def constrain(a, spec):
        if not isinstance(a, DTensor):
            return a
        pspec = spec_to_pspec(tuple(spec), mesh, rules, a.shape)
        return a.redistribute(mesh, to_placements(pspec, mesh))

    return constrain


def identity(a, spec):
    """The constrain hook without a mesh."""
    return a


def replicated(mesh) -> list:
    """The placements of a tensor every chip holds whole."""
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def on_shards(fn, *args, like):
    """``fn`` on each chip's shards: DTensor arguments as their local
    tensors (in-place writes land in their shards), the result as a
    DTensor with ``like``'s mesh and placements (a tuple of results with a
    tuple of ``like``s).  The shard_map of a computation that is
    independent across the dims its inputs are split on."""
    from torch.distributed.tensor import DTensor
    out = fn(*[a.to_local() if isinstance(a, DTensor) else a for a in args])

    def wrap(o, ref):
        return DTensor.from_local(o, ref.device_mesh, ref.placements,
                                  run_check=False)

    if isinstance(like, (tuple, list)):
        return tuple(wrap(o, r) for o, r in zip(out, like))
    return wrap(out, like)


def spmd():
    """The context a model runs in under a mesh: a plain tensor meeting a
    DTensor (an ``arange`` of positions, a mask) is taken as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


class Leaves:
    """Named tensors standing in for a module's parameters (a layer's
    local shards, read by name as the module's are)."""

    def __init__(self, **leaves):
        self.__dict__.update(leaves)


def place(t: torch.Tensor, mesh, placements):
    """``t`` (the whole tensor) as a DTensor: on a one-chip mesh over the
    same storage, else split by ``distribute_tensor``."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if mesh.size() == 1:
        return DTensor.from_local(t, mesh, placements, run_check=False)
    return distribute_tensor(t, mesh, placements)


def shard_module(module, mesh, pspecs: dict):
    """A copy of ``module``'s tree whose parameters are DTensors placed by
    ``pspecs`` ({parameter name: partition spec}); the copy's submodules
    are new objects, so ``module`` keeps its own parameters (on a one-chip
    mesh the two share storage)."""
    import copy
    from collections import OrderedDict

    def clone(m):
        c = copy.copy(m)
        c._parameters = OrderedDict(m._parameters)
        c._modules = OrderedDict((k, clone(v)) for k, v in m._modules.items())
        return c

    new = clone(module)
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        sub = new.get_submodule(".".join(path))
        sub._parameters[leaf] = torch.nn.Parameter(
            place(p.detach(), mesh, to_placements(pspecs[name], mesh)),
            requires_grad=p.requires_grad)
    return new


def local_weight(w, x, partial=()):
    """The local tensor of ``w`` (a DTensor) that each chip uses on its
    shard of the activation ``x``, for a computation done on local
    tensors: its gradient is split where ``w`` is split, summed over the
    chips that hold ``w`` whole but different data (``x`` split) or give
    partial sums of the output (mesh dims ``partial``), and the same on
    chips that compute the same thing."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    grad = [pw if isinstance(pw, Shard) else
            (Partial() if isinstance(px, Shard) or i in partial
             else Replicate())
            for i, (pw, px) in enumerate(zip(w.placements, x.placements))]
    return w.to_local(grad_placements=grad)
