"""The port's sharding (``repro_torch/sharding.py``, ``launch/mesh.py``,
the models' ``param_specs``, ``launch/steps.py``'s mesh rules and
``training/checkpoint.py`` across meshes) against the reference.

* The cases of ``tests/test_sharding.py``, on the port's meshes.
* For every arch on the 16x16 and 2x2x16 production meshes and under each
  of its cells' rules: every parameter's logical axes equal the
  reference's ``init_model_shapes(..., tp)`` specs (each layer's, less
  the stacked period dim), and its local shape equals the reference's
  ``NamedSharding(AbstractMesh(...), pspec).shard_shape(shape)`` (less
  that dim, which FSDP never picks).  No device is needed on either side.
* Reduced models sharded over a simulated 2x2 mesh
  (``LocalTensorMode``: four ranks in one process), TP 2 under the
  reference's rules for a big model: the forward and the decode step
  against the reference's unconstrained ones (its constrained runs raise
  under jax 0.9, ROADMAP C7), the context-parallel decode (the pool's
  blocks split over the sequence) against the port's without a mesh, and
  one train step (2 microbatches) against the reference's: loss, grad
  norm, moments and parameters, float32, 3e-5 of each leaf's largest
  value.
* A checkpoint saved from a 2x2 mesh restores onto a 4x1 mesh with
  identical values.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from repro import sharding as jax_sharding
from repro.config import SHAPES as JAX_SHAPES
from repro.config import get_config as jax_config
from repro.config import get_reduced_config as jax_reduced_config
from repro.launch import steps as jax_steps
from repro.models import transformer as jax_tf
from repro.training.optimizer import OptConfig as JaxOptConfig
from repro.training.train_lib import init_train_state as jax_init_state
from repro.training.train_lib import make_train_step as jax_train_step
from repro_torch import sharding
from repro_torch.config import (SHAPES, ShapeConfig, get_config,
                                get_reduced_config, list_archs, replace)
from repro_torch.convert import model_from_reference, unstack
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_fake_mesh, make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.layers import ParamInit
from repro_torch.perfmodel.hw import TPU_V5E
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptConfig

TOL = 3e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def local_mode(n):
    from torch.distributed._local_tensor import LocalTensorMode
    return LocalTensorMode(n)


# ---------------------------------------------------------------------------
# the cases of tests/test_sharding.py
# ---------------------------------------------------------------------------


@pytest.fixture
def mesh11():
    """One chip over a real (gloo) process group of one rank."""
    return make_host_mesh(device="cpu")


def test_spec_translation(mesh11):
    rules = sharding.rules_for_mesh(mesh11)
    jmesh = AbstractMesh((1, 1), ("data", "model"))
    jrules = jax_sharding.rules_for_mesh(jmesh)
    for spec in ((None, "model"), ("batch", None), ("expert", None, "model")):
        assert sharding.spec_to_pspec(spec, mesh11, rules) == \
            tuple(jax_sharding.spec_to_pspec(spec, jmesh, jrules))
    assert sharding.spec_to_pspec(("batch", None), mesh11, rules) == \
        P("data", None)


@pytest.mark.parametrize("shape,axes", [((16, 16), ("data", "model")),
                                        ((2, 16, 16), ("pod", "data",
                                                       "model"))])
def test_indivisible_dims_dropped(shape, axes):
    mesh = make_fake_mesh(shape, axes)
    jmesh = AbstractMesh(shape, axes)
    rules, jrules = (sharding.rules_for_mesh(mesh),
                     jax_sharding.rules_for_mesh(jmesh))
    for spec, dims in ((("model",), (3,)), (("batch", "model"), (64, 48)),
                       (("batch", None), (8, 5)), (("model", None), (32, 3))):
        got = sharding.spec_to_pspec(spec, mesh, rules, dims)
        assert got == tuple(jax_sharding.spec_to_pspec(spec, jmesh, jrules,
                                                       dims))
    assert sharding.spec_to_pspec(("model",), mesh, rules, (3,)) == (None,)


def test_param_sharding_tree(mesh11):
    cfg = get_reduced_config("granite-8b")
    model = tf.init_model(cfg, device="cpu")
    shapes = {n: p.shape for n, p in model.named_parameters()}
    sh = sharding.param_sharding(tf.param_specs(cfg), shapes, mesh11,
                                 fsdp=True, periods=cfg.num_periods)
    assert sorted(sh) == sorted(shapes)


def test_fsdp_skips_small_and_expert():
    mesh = make_fake_mesh((16, 16), ("data", "model"))
    rules = sharding.ShardingRules()
    assert sharding._fsdp_spec((None,), (64,), mesh, rules) == (None,)
    s = ("expert", None, "model")
    assert sharding._fsdp_spec(s, (128, 4096, 4096), mesh, rules) == s
    assert sharding._fsdp_spec((None, "model"), (4096, 4096), mesh,
                               rules) == ("data", "model")


def test_constrained_forward_runs(mesh11):
    """forward under a (1,1) mesh with every constraint active: the plain
    forward's logits, bit for bit."""
    cfg = replace(get_reduced_config("mixtral-8x7b"), dtype="float32")
    model = tf.init_model(cfg, device="cpu")
    B, S = 2, 16
    toks = torch.zeros(B, S, dtype=torch.int32)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    cell = steps.build_prefill_cell(model, ShapeConfig("p", S, B, "prefill"),
                                    mesh=mesh11, impl="ref")
    out = steps.gather(cell(inputs=toks, positions=pos)[0])
    assert out.shape == (B, 1, cfg.vocab_padded)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tf.forward(model, toks, pos, impl="ref",
                                       return_aux=True, last_only=True)[0])


def test_train_step_under_mesh(mesh11):
    """A full train step with constraints and remat under a (1,1) mesh."""
    cfg = replace(get_reduced_config("qwen3-moe-235b-a22b"),
                  dtype="float32")
    model = tf.init_model(cfg, device="cpu").requires_grad_()
    cell = steps.build_train_cell(model, ShapeConfig("t", 16, 4, "train"),
                                  mesh=mesh11, opt=OptConfig(lr=1e-3),
                                  microbatches=2)
    m = cell(**cell.materialize(0, "cpu"))
    assert torch.isfinite(steps.gather(m["loss"]))


# ---------------------------------------------------------------------------
# every arch's parameters on the production meshes
# ---------------------------------------------------------------------------

MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _jax_params(arch, tp):
    return jax_tf.init_model_shapes(jax.random.PRNGKey(0), jax_config(arch),
                                    tp)


@functools.lru_cache(maxsize=None)
def _port_shapes(arch, tp):
    with torch.device("meta"):
        model = tf.Transformer(ParamInit(None, "meta", torch.bfloat16),
                               get_config(arch), tp)
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _ref_name(cfg, name):
    """The reference's leaf path of a port parameter name."""
    top = {"tok": "embed/tok", "lm_head": "lm_head/w",
           "final_norm": "final_norm/w"}
    if name in top:
        return top[name], False
    _, i, rest = name.split(".", 2)
    pos = int(i) % cfg.period
    if rest in ("norm1", "norm2"):
        rest += ".w"
    return f"layers/pos{pos}/" + rest.replace(".", "/"), True


def _leaf(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _cases():
    for arch in list_archs():
        for shape in steps.cells_for_arch(get_config(arch)):
            for multi in (False, True):
                yield arch, shape.name, multi


@pytest.mark.parametrize("arch,shape,multi", list(_cases()))
def test_shard_shapes_match_reference(arch, shape, multi):
    cfg, jcfg = get_config(arch), jax_config(arch)
    dims, axes = MESHES[multi]
    mesh, jmesh = make_fake_mesh(dims, axes), AbstractMesh(dims, axes)
    sc, jsc = SHAPES[shape], JAX_SHAPES[shape]
    tp = steps.tp_for(cfg, mesh, sc)
    assert tp == jax_steps._tp_for(jcfg, jmesh, jsc)
    rules, jrules = steps._rules(mesh, sc, cfg), \
        jax_steps._rules(jmesh, jsc, jcfg)
    assert dataclasses.asdict(rules) == dataclasses.asdict(jrules)
    if sc.kind == "train":
        fsdp = True
    else:
        fsdp = steps._serve_fsdp(cfg, mesh, TPU_V5E)
        assert fsdp == jax_steps._serve_fsdp(jcfg, jmesh)
    jshapes, jspecs = _jax_params(arch, tp)
    jsh = jax_sharding.param_sharding(jspecs, jshapes, jmesh, rules=jrules,
                                      fsdp=fsdp)
    shapes = _port_shapes(arch, tp)
    specs = tf.param_specs(cfg, tp)
    assert set(specs) == set(shapes)
    pspecs = sharding.param_sharding(specs, shapes, mesh, rules=rules,
                                     fsdp=fsdp, periods=cfg.num_periods)
    checked = 0
    for name, shp in shapes.items():
        ref, stacked = _ref_name(cfg, name)
        if stacked and int(name.split(".")[1]) >= cfg.period:
            continue               # the first period stands for the rest
        jshape = _leaf(jshapes, ref).shape
        jspec = tuple(_leaf(jspecs, ref))
        want = _leaf(jsh, ref).shard_shape(jshape)
        got = sharding.shard_shape(shp, pspecs[name], mesh)
        if stacked:
            assert jspec[0] is None and want[0] == jshape[0], name
            jspec, jshape, want = jspec[1:], jshape[1:], want[1:]
        assert tuple(specs[name]) == jspec, name
        assert tuple(shp) == tuple(jshape), name
        assert got == tuple(want), (name, pspecs[name])
        checked += 1
    assert checked > 3


# ---------------------------------------------------------------------------
# reduced models on a simulated 2x2 mesh, against the reference
# ---------------------------------------------------------------------------

TP = 2


@pytest.fixture
def mesh22():
    return make_fake_mesh((2, 2), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _reduced(arch):
    """(port model at TP 2 from the reference's parameters, the
    reference's parameters, both configs), float32."""
    jcfg = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    params, _ = jax_tf.init_model(jax.random.PRNGKey(3), jcfg, TP)
    params = jax.tree.map(np.asarray, params)
    cfg = replace(get_reduced_config(arch), dtype="float32")
    return model_from_reference(params, cfg, tp=TP), params, cfg, jcfg


def _tp_rules(mesh, **kw):
    """The reference's rules for a big model (TP over "model"): the
    reduced models are small enough for the DP-only rules."""
    return dataclasses.replace(sharding.rules_for_mesh(mesh), **kw)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _tokens(cfg, B, S, seed):
    rs = np.random.RandomState(seed)
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b", "xlstm-125m"])
def test_sharded_forward_matches_reference(arch, mesh22):
    model, params, cfg, jcfg = _reduced(arch)
    B, S = 4, 16
    toks = _tokens(cfg, B, S, 0)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    want = jax_tf.forward(params, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          TP)
    shape = ShapeConfig("p", S, B, "prefill")
    with local_mode(4):
        cell = steps.build_prefill_cell(model, shape, mesh=mesh22,
                                        rules=_tp_rules(mesh22), impl="ref")
        assert any(sharding.is_dtensor(p) and p.to_local().numel() <
                   p.numel() for p in cell.placed.model.parameters())
        with cell.placed.context():
            got = steps.gather(tf.forward(
                cell.placed.model, cell.placed.split(torch.from_numpy(toks)),
                cell.placed.split(torch.from_numpy(pos)), impl="ref",
                constrain=cell.placed.constrain))
        assert _rel(got.numpy(), want) < TOL


def _decode_case(arch, mesh, rules, B, S, seed, kind="decode"):
    """The decode cell of ``arch`` on ``mesh`` (or none) with the
    reference's cache drawn from ``seed``: (cell, its inputs, the
    reference's cache)."""
    model, params, cfg, jcfg = _reduced(arch)
    rs = np.random.RandomState(seed)
    jcache = jax.tree.map(
        lambda a: rs.standard_normal(a.shape).astype(np.float32),
        jax_tf.init_cache(jcfg, B, S, TP))
    cell = steps.build_decode_cell(model, ShapeConfig(kind, S, B, kind),
                                   mesh=mesh, rules=rules, impl="ref",
                                   page=8)
    for layer, c in zip(cell.cache.whole, _per_layer(cfg, jcache, B)):
        for k in layer:
            layer[k].copy_(c[k].reshape(layer[k].shape))
    cell.cache.place()
    lens = rs.randint(S // 2, S - 4, size=B).astype(np.int32)
    args = {"inputs": torch.from_numpy(_tokens(cfg, B, 1, seed + 1)),
            "positions": torch.from_numpy(lens[:, None].copy()),
            "seq_lens": torch.from_numpy(lens)}
    return cell, args, jcache


def _per_layer(cfg, jcache, B):
    """The reference's stacked cache -> the port's per layer, sequence
    after sequence (K/V (B*S, ...) rows, state rows (B, ...))."""
    out = []
    for i in range(cfg.num_layers):
        c = jcache[f"pos{i % cfg.period}"]
        out.append({k: torch.from_numpy(np.array(v[i // cfg.period]))
                    for k, v in c.items()})
    return out


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b",
                                  "jamba-1.5-large-398b"])
def test_sharded_decode_matches_reference(arch, mesh22):
    """Two decode steps of 4 sequences split over "data", heads over
    "model", against the reference's decode_forward on the same cache."""
    _, params, cfg, jcfg = _reduced(arch)
    B, S = 4, 32
    with local_mode(4):
        cell, args, jcache = _decode_case(arch, mesh22, _tp_rules(mesh22),
                                          B, S, 5)
        assert cell.cache.bsplit == 2 and not cell.cache.cp
        for step in range(2):
            want, jcache = jax_tf.decode_forward(
                params, jcfg, jnp.asarray(args["inputs"].numpy()),
                jnp.asarray(args["positions"].numpy()), jcache,
                jnp.asarray(args["seq_lens"].numpy()), TP)
            got = steps.gather(cell(**args))
            assert _rel(got.numpy(), want) < TOL, step
            args = dict(args, positions=args["positions"] + 1,
                        seq_lens=args["seq_lens"] + 1)


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b"])
def test_context_parallel_decode(arch, mesh22):
    """``long_500k``'s layout at batch 1: the pool's blocks split over the
    sequence ("seq" -> "data"), each chip's part of the attention and its
    log-sum-exp combined; two steps against the reference's decode_forward
    on the same cache."""
    _, params, cfg, jcfg = _reduced(arch)
    B, S = 1, 64
    with local_mode(4):
        cell, args, jcache = _decode_case(arch, mesh22, _tp_rules(
            mesh22, seq="data"), B, S, 7, "long_decode")
        assert cell.cache.cp and cell.cache.offsets is not None
        for step in range(2):
            want, jcache = jax_tf.decode_forward(
                params, jcfg, jnp.asarray(args["inputs"].numpy()),
                jnp.asarray(args["positions"].numpy()), jcache,
                jnp.asarray(args["seq_lens"].numpy()), TP)
            got = steps.gather(cell(**args))
            assert _rel(got.numpy(), want) < TOL, step
            args = dict(args, positions=args["positions"] + 1,
                        seq_lens=args["seq_lens"] + 1)


def test_sharded_train_step_matches_reference(mesh22):
    """One train step of reduced granite-8b, 2 microbatches, TP 2 with
    sequence parallelism and FSDP on the 2x2 mesh, against the
    reference's unconstrained step from the same parameters."""
    model, params, cfg, jcfg = _reduced("granite-8b")
    opt = OptConfig(lr=1e-3)
    jopt = JaxOptConfig(lr=1e-3)
    B, S = 4, 32
    toks, labels = _tokens(cfg, B, S, 11), _tokens(cfg, B, S, 12)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    jstate = jax_init_state(jax.random.PRNGKey(3), jcfg, jopt, TP)
    jstate = dataclasses.replace(jstate, params=jax.tree.map(jnp.asarray,
                                                             params))
    jstep = jax.jit(jax_train_step(jcfg, jopt, TP, microbatches=2))
    jstate, jm = jstep(jstate, {"inputs": jnp.asarray(toks),
                                "labels": jnp.asarray(labels),
                                "positions": jnp.asarray(pos)})
    trained = model_from_reference(params, cfg, tp=TP).requires_grad_()
    with local_mode(4):
        cell = steps.build_train_cell(
            trained, ShapeConfig("t", S, B, "train"), mesh=mesh22, opt=opt,
            microbatches=2, rules=_tp_rules(mesh22, seq="model"))
        m = cell(inputs=torch.from_numpy(toks),
                 labels=torch.from_numpy(labels),
                 positions=torch.from_numpy(pos))
        assert _rel(steps.gather(m["loss"]).numpy(), jm["loss"]) < TOL
        assert _rel(steps.gather(m["grad_norm"]).numpy(),
                    jm["grad_norm"]) < TOL
        state = cell.state
        for part, tree in (("params", jstate.params),
                           ("mu", jstate.opt.mu), ("nu", jstate.opt.nu)):
            want = unstack(jax.tree.map(np.asarray, tree), cfg)
            got = state.tree()[part]
            for name, w in want.items():
                g = steps.gather(got[name].detach()).numpy()
                assert _rel(g, w) < TOL, (part, name)


def test_checkpoint_restores_onto_another_mesh(tmp_path):
    """A train state saved from a 2x2 mesh (TP 2) restores onto a 4x1
    mesh: every leaf placed by the new mesh, its values identical."""
    cfg = replace(get_reduced_config("granite-8b"), dtype="float32")
    shape = ShapeConfig("t", 32, 4, "train")
    a = make_fake_mesh((2, 2), ("data", "model"))
    b = make_fake_mesh((4, 1), ("data", "model"))
    first = tf.init_model(cfg, device="cpu", seed=0, tp=TP).requires_grad_()
    want = {n: p.detach().clone() for n, p in first.named_parameters()}
    with local_mode(4):
        saved = steps.build_train_cell(first, shape, mesh=a,
                                       rules=sharding.rules_for_mesh(a))
        ckpt.save_checkpoint(str(tmp_path), 1, saved.state)
        other = tf.init_model(cfg, device="cpu", seed=1, tp=TP)
        like = steps.build_train_cell(other.requires_grad_(), shape, mesh=b,
                                      rules=sharding.rules_for_mesh(b))
        restored = ckpt.restore_checkpoint(str(tmp_path), like.state)
        for name, p in restored.params.items():
            assert p.device_mesh is b
            assert p.placements == like.state.params[name].placements
            assert torch.equal(p.full_tensor(), want[name]), name
        assert int(restored.step) == 0
