"""Dry-run: every (arch x shape x mesh) cell, run once with no buffer.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell on 512 placeholder devices and reads XLA's memory and cost analyses.
Here the cell is built on the fake 16x16 or 2x16x16 mesh
(``launch/mesh.py``) from a model made under ``FakeTensorMode`` (every
tensor a shape and a dtype, no storage), its parameters, optimizer state,
cache and inputs placed as the cell places them, and run once under
``roofline.CostMode``, which counts what one chip (rank 0) computes and
moves.  Nothing allocates a real buffer.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-70b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]

Per cell and chip it prints the argument bytes (parameters, optimizer
state and cache, from their local shards), the temporaries' peak (the
bytes tensors made by the run held at once, ``CostMode``), whether their
sum fits the ``H100``'s 80 GB, the roofline terms on the ``H100`` spec
and the collectives by op.  The train cell's step is the whole step:
forward, backward and the AdamW update.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from repro_torch.config import SHAPES, get_config, list_archs
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import CostMode, analyze
from repro_torch.models.layers import ParamInit
from repro_torch.models.transformer import Transformer
from repro_torch.perfmodel.hw import H100

SEED = 0


def _local_bytes(tensors) -> int:
    total = 0
    for t in tensors:
        loc = t.to_local() if hasattr(t, "to_local") else t
        total += loc.numel() * loc.element_size()
    return total


def argument_bytes(cell) -> dict:
    """One chip's bytes of the cell's parameters, optimizer state and
    cache, from their local shards."""
    out = {"params": _local_bytes(cell.placed.model.parameters()),
           "optimizer": 0, "cache": 0}
    if cell.state is not None:
        opt = cell.state.opt
        out["optimizer"] = _local_bytes(list(opt.mu.values()) +
                                        list(opt.nu.values()))
    if cell.cache is not None:
        out["cache"] = _local_bytes(t for layer in cell.cache.layers
                                    for t in layer.values())
    return out


def build(arch: str, shape_name: str, mesh):
    """(config, shape, the cell and its drawn inputs) on ``mesh``, all
    fake; call inside ``FakeTensorMode`` (the mesh is made outside it)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    tp = steps.tp_for(cfg, mesh, shape)
    with torch.no_grad():
        model = Transformer(ParamInit(None, "cpu", getattr(torch, cfg.dtype)),
                            cfg, tp)
    if shape.kind == "train":
        model.requires_grad_()
    # the plain path, as the reference's dry-run lowers its "ref" path
    kw = {} if shape.kind == "train" else {"impl": "ref"}
    cell = steps.build_cell(model, shape, mesh=mesh, **kw)
    return cfg, shape, cell, cell.materialize(SEED, "cpu")


class _RealStridedOffsets:
    """While a cell runs under ``FakeTensorMode``: DTensor computes a
    strided shard's local size and offsets (integers of the mesh) with a
    small ``arange``, which a fake tensor cannot give back as a list;
    that computation runs on real tensors."""

    def __enter__(self):
        from torch._subclasses.fake_tensor import unset_fake_temporarily
        from torch.distributed.tensor.placement_types import _StridedShard
        self.cls, self.orig = _StridedShard, \
            _StridedShard.__dict__["local_shard_size_and_offset"]
        fn = self.orig

        def real(*a, **k):
            with unset_fake_temporarily():
                return fn(*a, **k)

        _StridedShard.local_shard_size_and_offset = real
        return self

    def __exit__(self, *exc):
        self.cls.local_shard_size_and_offset = self.orig


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             verbose: bool = True):
    from torch._subclasses.fake_tensor import FakeTensorMode
    mesh_name = "2x16x16" if multi_pod else "16x16"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    with FakeTensorMode(allow_non_fake_inputs=True), _RealStridedOffsets():
        cfg, shape, cell, args = build(arch, shape_name, mesh)
        net = [mesh.get_group("pod").group_name] if multi_pod else []
        with CostMode(net_groups=net) as cost:
            cell(**args)
        args_b = argument_bytes(cell)
    dt = time.time() - t0
    terms = analyze(cost, cfg, shape, mesh_name, mesh.size(),
                    arg_bytes=sum(args_b.values()))
    if verbose:
        gb = 1e9
        total = terms.peak_mem_per_chip
        print(f"== {arch} x {shape_name} x {mesh_name} (run {dt:.1f}s)")
        print("   bytes/chip: " + ", ".join(
            f"{k}={v / gb:.2f}GB" for k, v in args_b.items()) +
            f", temporaries peak={cost.peak / gb:.2f}GB, total="
            f"{total / gb:.2f}GB -> "
            f"{'fits' if total <= H100.hbm_bytes else 'does NOT fit'} "
            f"the H100's {H100.hbm_bytes / gb:.0f}GB")
        print(f"   counted: flops={terms.flops:.3e} "
              f"hbm_bytes={terms.hbm_bytes:.3e} ops={cost.ops}")
        tc, tm, tl = terms.terms(H100)
        print(f"   roofline (H100): compute={tc * 1e3:.2f}ms "
              f"memory={tm * 1e3:.2f}ms collective={tl * 1e3:.2f}ms -> "
              f"{terms.bottleneck}-bound; useful-FLOPs="
              f"{terms.useful_flops_ratio:.2f}")
        print("   collectives: " + (", ".join(
            f"{k}={v / 2 ** 20:.0f}MiB" for k, v in
            sorted(terms.coll_by_op.items())) if terms.coll_by_op
            else "none") + (f" (network {terms.net_bytes / 2 ** 20:.0f}MiB)"
                            if terms.net_bytes else ""))
    return terms, args_b, cost.peak


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default=None, choices=list_archs() + [None])
    p.add_argument("--shape", default=None,
                   choices=list(SHAPES) + [None])
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)

    results = []
    failures = []
    if args.all:
        archs = list_archs()
    elif args.arch:
        archs = [args.arch]
    else:
        p.error("--arch or --all required")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    t0 = time.time()
    for arch in archs:
        cfg = get_config(arch)
        shapes = ([SHAPES[args.shape]] if args.shape
                  else steps.cells_for_arch(cfg))
        for shape in shapes:
            for mp in meshes:
                try:
                    terms, args_b, temp = run_cell(arch, shape.name, mp)
                    results.append(dict(dataclasses.asdict(terms),
                                        argument_bytes=args_b,
                                        temp_peak_bytes=temp))
                except Exception as e:  # noqa: BLE001 - report & continue
                    failures.append((arch, shape.name, mp, repr(e)))
                    print(f"!! FAILED {arch} x {shape.name} "
                          f"(multi_pod={mp}): {e}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)
    print(f"\n{len(results)} cells run, {len(failures)} failed "
          f"({time.time() - t0:.0f}s)")
    for f_ in failures:
        print("  FAIL:", *f_[:3])
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
