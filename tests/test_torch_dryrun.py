"""The port's dry-run (``launch/dryrun.py``, ``launch/roofline.py``) on the
fake production meshes, against the reference's shard shapes.

A few full-width cells run under ``FakeTensorMode`` (no buffer): each
chip's bytes of parameters and cache equal the sum of the reference's
``NamedSharding(AbstractMesh(...), pspec).shard_shape`` over its leaves
(``init_model_shapes`` and ``init_cache`` under its rules for the cell);
the counted FLOPs stand in a stated ratio to ``model_flops_for``; the
DP-only cells of xLSTM-125M move no byte between chips.  The CLI runs and
writes its JSON.
"""
import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import sharding as jax_sharding
from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_config as jax_config
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro_torch.config import SHAPES, get_config
from repro_torch.launch import dryrun, roofline

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _bytes(sds_tree, shardings):
    leaves = jax.tree.leaves(sds_tree)
    shs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(
        x, "shard_shape"))
    return sum(int(np.prod(sh.shard_shape(l.shape))) * l.dtype.itemsize
               for l, sh in zip(leaves, shs))


def reference_bytes(arch, shape_name, multi):
    """One chip's bytes of the reference's parameters and cache for a
    serving cell, from its shard shapes."""
    cfg, shape = jax_config(arch), JAX_SHAPES[shape_name]
    mesh = AbstractMesh(*MESHES[multi])
    rules = jax_steps._rules(mesh, shape, cfg)
    tp = jax_steps._tp_for(cfg, mesh, shape)
    fsdp = jax_steps._serve_fsdp(cfg, mesh)
    shapes, specs = jax_tf.init_model_shapes(jax.random.PRNGKey(0), cfg, tp)
    out = {"params": _bytes(shapes, jax_sharding.param_sharding(
        specs, shapes, mesh, rules=rules, fsdp=fsdp)), "cache": 0}
    if shape.kind in ("decode", "long_decode"):
        B, S = shape.global_batch, shape.seq_len
        cache = jax.eval_shape(lambda: jax_tf.init_cache(cfg, B, S, tp))
        out["cache"] = _bytes(cache, jax_sharding.param_sharding(
            jax_tf.cache_specs(cfg, tp), cache, mesh, rules=rules,
            fsdp=False))
    return out


@pytest.mark.parametrize("arch,shape,multi,useful", [
    # decode at 32K: attention over the cache adds about as many FLOPs as
    # the products (not counted in model_flops_for)
    ("granite-8b", "decode_32k", False, (0.3, 1.0)),
    # DP-only: batch 128 over the 16 data chips, every "model" chip of a
    # row computing the same sequences: 1/16 of the FLOPs are useful
    ("xlstm-125m", "decode_32k", False, (0.04, 0.08)),
    ("xlstm-125m", "decode_32k", True, (0.04, 0.08)),
])
def test_dryrun_cell(arch, shape, multi, useful):
    terms, args, temp = dryrun.run_cell(arch, shape, multi, verbose=False)
    want = reference_bytes(arch, shape, multi)
    assert args["params"] == want["params"]
    assert args["cache"] == want["cache"]
    assert args["optimizer"] == 0
    assert 0 < temp < 80e9
    assert terms.model_flops == roofline.model_flops_for(
        get_config(arch), SHAPES[shape])
    assert useful[0] < terms.useful_flops_ratio < useful[1]
    assert terms.hbm_bytes > args["params"]
    tc, tm, tl = terms.terms()
    assert tm > tc and terms.bottleneck == "memory"
    if arch == "xlstm-125m":
        assert terms.coll_by_op == {} and tl == 0.0
    else:
        assert set(terms.coll_by_op) == {"all-reduce"} and tl > 0
        assert terms.net_bytes == 0.0


def test_dryrun_main_writes_json(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "xlstm-125m", "--shape", "decode_32k",
                        "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "bytes/chip" in text and "roofline (H100)" in text
    assert "collectives: none" in text and "1 cells run, 0 failed" in text
    cells = json.loads(out.read_text())
    assert [c["arch"] for c in cells] == ["xlstm-125m"]
    assert cells[0]["argument_bytes"]["cache"] > 0


def test_cost_mode_counts_a_product():
    """CostMode on plain tensors: a product's FLOPs and bytes, no
    collective."""
    with roofline.CostMode() as cost:
        a, b = torch.ones(64, 32), torch.ones(32, 16)
        c = a @ b
    assert cost.flops == 2 * 64 * 32 * 16
    assert cost.hbm_bytes >= (a.numel() + b.numel() + c.numel()) * 4
    assert cost.coll_by_op == {} and cost.peak >= c.numel() * 4
