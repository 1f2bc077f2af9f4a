"""Meshes.  Counterpart of ``repro/launch/mesh.py``.

Functions, not module constants: importing this module touches no
process group and no device.

* ``make_production_mesh``: the reference's 16x16 ("data", "model") or
  2x16x16 ("pod", "data", "model") mesh of placeholder chips, here a
  ``DeviceMesh`` over the ``fake`` process group (``FakeStore``) of 256 or
  512 ranks, this process being rank 0.  Collectives on it return at once
  and move nothing; with ``FakeTensorMode`` the dry-run runs a cell on it
  without a buffer (``launch/dryrun.py``).
* ``make_host_mesh``: a real mesh over the devices this process has: on
  a card a 1x1 mesh over one rank of NCCL, on the CPU one rank of gloo,
  each over an in-process store (no address, no network).

The process group is process-wide: a mesh of one kind replaces a group
of the other, and the 16x16 mesh is made over the first 256 ranks of a
512-rank fake group when that is the one standing.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}
FAKE_WORLD = 512


def _group(backend: str, world: int, **kw) -> None:
    """Make the default process group ``backend`` of ``world`` ranks (this
    process rank 0), replacing a group of another backend or size."""
    if dist.is_initialized():
        if dist.get_backend() == backend and dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group(backend, rank=0, world_size=world, **kw)


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """16x16 = 256 chips a pod; ``multi_pod``: 2 pods = 512 chips.

    Axes: "model" = TP inside a pod, "data" = DP/FSDP inside a pod, "pod"
    = the outermost DP across pods (the network) — parameter all-gathers
    never cross the pod boundary (``sharding.py`` rules)."""
    return make_fake_mesh(*PRODUCTION[multi_pod])


def make_fake_mesh(shape, axes) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the first ranks of the
    ``fake`` process group of ``FAKE_WORLD`` ranks."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    _group("fake", FAKE_WORLD, store=FakeStore())
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).view(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_host_mesh(tp: int = 1, device=None) -> DeviceMesh:
    """A ("data", "model") mesh over this process's one rank: on
    ``device`` (default: the card when there is one, else the CPU).  One
    rank holds no model axis of more than one."""
    if tp != 1:
        raise ValueError(f"a mesh over one rank has tp 1, not {tp}")
    device = torch.device(device if device is not None else
                          ("cuda" if torch.cuda.is_available() else "cpu"))
    backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device.index or 0)
    _group(backend, 1, store=dist.HashStore())
    return DeviceMesh(device.type, torch.arange(1).view(1, 1),
                      mesh_dim_names=("data", "model"))
