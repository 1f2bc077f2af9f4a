"""The port's training path against the reference's.

Data pipeline, WSD schedule, AdamW, gradient compression, ``lm_loss`` and
its gradients, the microbatched train step, checkpoints (the reference's
on-disk layout, read both ways) and the supervisor's restart.  Weights are
the reference's ``init_model`` / ``init_train_state`` converted by
``convert.py``; batches come from the reference's ``TokenPipeline`` (the
port's gives the same ones bit for bit); everything runs in float32 unless
a test says otherwise.

Tolerances, and why:
  * ``lm_loss`` within 1e-5 relative; each gradient leaf within 1e-4 x the
    largest |value| of the reference's gradient (over all leaves): XLA and
    PyTorch sum the float32 products in other orders.  The bound is the
    gradient's, not each leaf's own: a leaf whose exact gradient is 0 (the
    sLSTM input-gate bias shifts every token's log-gate alike, which the
    normalised cell cancels) holds only rounding noise on both sides, and
    xLSTM's mLSTM normaliser divides by sums that cancel.  Against the
    port run in float64, xLSTM's worst leaf is 3.2e-5 (port) and 5.0e-5
    (reference) of that bound's scale off, 8.2e-5 apart;
  * AdamW on identical inputs: float32 within 1e-6; bfloat16 parameters
    and moments at most one bf16 ulp apart (both round the same float32
    update once; a float32 difference at a rounding boundary moves it one
    ulp);
  * along a 3-step trajectory, loss and grad norm within 1e-4 relative,
    and the gradient entering the update as the gradients above.
    Parameters and moments are compared only where every step's reference
    gradient is above 1e-6 of its leaf's largest: where g is near 0 the
    first steps move a parameter by about +-lr whatever its sign, so a
    rounding-level difference in g flips the move.  With gradient
    compression, each int8 code within one of the reference's, and the
    parameters and moments compared where no code differed (the test's
    docstring).
"""
import io
import contextlib
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.data import TokenPipeline as JaxPipeline
from repro.models import transformer as jax_tf
from repro.training import checkpoint as jax_ckpt
from repro.training import compression as jax_comp
from repro.training import optimizer as jax_opt
from repro.training import resilience as jax_res
from repro.training import train_lib as jax_train

from repro_torch.config import get_reduced_config, replace
from repro_torch.convert import (model_from_reference,
                                 read_reference_checkpoint,
                                 train_state_from_reference, unstack)
from repro_torch.data import TokenPipeline
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels import unified_pd as up
from repro_torch.launch import train as train_mod
from repro_torch.launch import train_small
from repro_torch.models import transformer as tf
from repro_torch.training import checkpoint as ckpt_mod
from repro_torch.training import compression, optimizer, train_lib
from repro_torch.training import resilience as port_res
from repro_torch.training.checkpoint import (CheckpointManager,
                                             restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.resilience import (FailureEvent, HeartbeatMonitor,
                                             StragglerDetector,
                                             TrainingSupervisor)
from repro_torch.training.train_lib import (TrainState, init_train_state,
                                            make_train_step)

@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many small ops; beside other test workers torch's
    intra-op threads contend for the cores (a 25-step test took 111 s in
    a run of the whole suite on 6 workers, 1.7 s alone), and one thread
    runs small ops fastest.  Restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["granite-8b", "mixtral-8x7b", "jamba-1.5-large-398b", "minicpm-2b",
         "xlstm-125m"]
OPT = dict(lr=3e-3, warmup_steps=5, stable_steps=100, decay_steps=10)
B, S = 2, 32
FLIPS = 1e-3    # share of int8 codes one step off along the trajectory


def _cfgs(arch, dtype="float32"):
    cfg = replace(get_reduced_config(arch), dtype=dtype)
    jcfg = jax_replace(jax_reduced_config(arch), dtype=dtype)
    if cfg.moe is not None:
        # capacity factor 0.5: 64 slots for the 128 (token, choice) pairs
        # of a 64-token group, so the training policy must drop pairs
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=0.5))
        jcfg = jax_replace(jcfg, moe=jax_replace(jcfg.moe,
                                                 capacity_factor=0.5))
    return cfg, jcfg


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _jbatch(pipe, B, S):
    x, y = pipe.next_batch()
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    return {"inputs": x, "labels": y, "positions": pos}


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close_leaves(got: dict, want: dict, scale=1e-4, mask=None,
                  per_leaf=True):
    """Each leaf within ``scale`` x the largest |want| of that leaf, or of
    all leaves when not ``per_leaf`` (only where ``mask``)."""
    assert set(got) == set(want)
    top = max(np.abs(_np(w)).max() for w in want.values())
    for n in want:
        g, w = _np(got[n].detach().float() if torch.is_tensor(got[n])
                   else got[n]), _np(want[n])
        m = np.ones(w.shape, bool) if mask is None else mask[n]
        lim = scale * max(np.abs(w).max() if per_leaf else top, 1e-30)
        err = np.abs(g - w)[m].max(initial=0.0)
        assert err <= lim, (n, err, lim)


# ---------------------------------------------------------------------------
# data pipeline, schedule, optimizer, compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_pipeline_matches_reference(seed):
    mine, theirs = TokenPipeline(1000, 3, 24, seed=seed), \
        JaxPipeline(1000, 3, 24, seed=seed)
    for _ in range(4):
        for a, b in zip(mine.next_batch(), theirs.next_batch()):
            np.testing.assert_array_equal(a, b)
            assert a.dtype == b.dtype == np.int32


@given(st.integers(0, 100), st.integers(1, 20))
@settings(max_examples=20, deadline=None)
def test_pipeline_restore_exact(start, n):
    """After restore(state) the stream continues identically."""
    p1 = TokenPipeline(1000, 2, 16, seed=9)
    for _ in range(start):
        p1.next_batch()
    snap = p1.state
    want = [p1.next_batch() for _ in range(n)]
    p2 = TokenPipeline(1000, 2, 16, seed=9)
    p2.restore(snap)
    got = [p2.next_batch() for _ in range(n)]
    for (a1, b1), (a2, b2) in zip(want, got):
        np.testing.assert_array_equal(a1, a2)
        np.testing.assert_array_equal(b1, b2)


def test_wsd_schedule_matches_reference():
    """Warmup (0-9), stable (10-109), decay (110-160) and after it."""
    kw = dict(lr=1.0, warmup_steps=10, stable_steps=100, decay_steps=50,
              min_lr_frac=0.1)
    steps = np.arange(201)
    got = optimizer.wsd_schedule(torch.from_numpy(steps),
                                 optimizer.OptConfig(**kw)).numpy()
    want = _np(jax_opt.wsd_schedule(jnp.asarray(steps),
                                    jax_opt.OptConfig(**kw)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    assert got[5] == pytest.approx(0.5) and got[50] == pytest.approx(1.0)
    assert got[160] == pytest.approx(0.1, abs=1e-6)


def _opt_inputs(rs, dtype):
    shapes = {"a": (64, 48), "b": (300,), "c": (7, 5, 3), "d": (1,)}
    mk = lambda s, scale=1.0: (rs.standard_normal(s) * scale).astype(
        np.float32)
    params = {n: mk(s) for n, s in shapes.items()}
    grads = {n: mk(s, 0.3) for n, s in shapes.items()}
    mu = {n: mk(s, 0.1) for n, s in shapes.items()}
    nu = {n: np.abs(mk(s, 0.05)) for n, s in shapes.items()}
    cast = (lambda t: {n: jnp.asarray(v, dtype) for n, v in t.items()})
    return [cast(t) for t in (params, grads, mu, nu)]


def _bf16_ulp(x):
    """One bfloat16 ulp at each value of x (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(dtype):
    """One update on identical leaves, gradients, moments and count, with
    the gradient norm above the clip (so the clip scale applies)."""
    rs = np.random.RandomState(0)
    p, g, m, v = _opt_inputs(rs, jnp.dtype(dtype))
    kw = dict(lr=3e-3, warmup_steps=5, weight_decay=0.1, grad_clip=1.0,
              moment_dtype=dtype)
    count = 3
    jp, jstate, jm = jax_opt.adamw_update(
        p, g, jax_opt.AdamWState(m, v, jnp.asarray(count, jnp.int32)),
        jax_opt.OptConfig(**kw))
    tt = lambda t: {n: torch.from_numpy(_np(x)).to(getattr(torch, dtype))
                    for n, x in t.items()}
    tp, tg = tt(p), tt(g)
    state = optimizer.AdamWState(tt(m), tt(v), torch.tensor(count,
                                                            dtype=torch.int32))
    gn = optimizer.global_norm(tg)
    assert float(gn) == pytest.approx(float(jax_opt.global_norm(g)),
                                      rel=1e-6)
    assert float(gn) > 1.0
    clipped, cn = optimizer.clip_by_global_norm(tg, 1.0)
    jclipped, jcn = jax_opt.clip_by_global_norm(g, 1.0)
    assert float(cn) == float(gn)
    for n in g:
        np.testing.assert_allclose(clipped[n].float().numpy(),
                                   _np(jclipped[n]), rtol=1e-6, atol=1e-6)
    tp2, state2, tm = optimizer.adamw_update(tp, tg, state,
                                             optimizer.OptConfig(**kw))
    assert tp2 is tp and int(state2.count) == count + 1
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
    for got, want in ((tp2, jp), (state2.mu, jstate.mu),
                      (state2.nu, jstate.nu)):
        for n in want:
            a = got[n].float().numpy()
            b = _np(want[n])
            assert got[n].dtype == getattr(torch, dtype)
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            else:
                assert (np.abs(a - b) <= _bf16_ulp(b)).all(), n


@pytest.mark.parametrize("n", [17, 256, 1000, 4096])
def test_compression_matches_reference(n):
    g = np.random.RandomState(n).standard_normal((n,)).astype(np.float32)
    g[3] = 0.0
    q, scale, shape, pad = compression._quantize(torch.from_numpy(g))
    jq, jscale, jshape, jpad = jax_comp._quantize(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    assert (shape, pad) == (tuple(jshape), jpad)
    out = compression.decompress_gradients(
        compression.compress_gradients({"g": torch.from_numpy(g)}))["g"]
    want = jax_comp.decompress_gradients(
        jax_comp.compress_gradients({"g": jnp.asarray(g)}))["g"]
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([17, 256, 1000, 4096]))
@settings(max_examples=30, deadline=None)
def test_compression_bounded_error(seed, n):
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        n).astype(np.float32))
    out = compression.decompress_gradients(
        compression.compress_gradients({"g": g}))["g"]
    assert out.shape == g.shape
    err = float((out - g).abs().max())
    assert err <= float(g.abs().max()) / 127.0 + 1e-7


# ---------------------------------------------------------------------------
# lm_loss and its gradients
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def loss_case(request):
    """(arch, port model, reference params, cfgs, tokens, labels,
    positions, reference loss, reference grads by port name)."""
    arch = request.param
    cfg, jcfg = _cfgs(arch)
    params, _ = jax_tf.init_model(jax.random.PRNGKey(0), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params),
                                 cfg).requires_grad_()
    rs = np.random.RandomState(1)
    toks, labels = (rs.randint(0, cfg.vocab_size, size=(B, S))
                    .astype(np.int32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    loss, grads = jax.value_and_grad(jax_tf.lm_loss)(
        params, jcfg, jnp.asarray(toks), jnp.asarray(labels),
        jnp.asarray(pos), ce_chunk=8)
    grads = unstack(jax.tree.map(_np, grads), cfg)
    return arch, model, cfg, toks, labels, pos, float(loss), grads


def _port_loss(model, toks, labels, pos, **kw):
    loss = tf.lm_loss(model, *(torch.from_numpy(a) for a in
                               (toks, labels, pos)), **kw)
    names, params = zip(*model.named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def test_lm_loss_and_grads_match_reference(loss_case):
    """Loss and every gradient leaf, the tied embedding's included (it
    takes the embedding's and the LM head's gradient), with the CE in
    4 chunks of 8 on both sides; remat on and off give the same bits."""
    arch, model, cfg, toks, labels, pos, want, want_g = loss_case
    loss, grads = _port_loss(model, toks, labels, pos, ce_chunk=8)
    assert float(loss) == pytest.approx(want, rel=1e-5)
    _close_leaves(grads, want_g, per_leaf=False)
    loss2, grads2 = _port_loss(model, toks, labels, pos, ce_chunk=8,
                               remat=False)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[n], grads2[n]) for n in grads)


def test_chunked_ce_equals_full_logits():
    """Chunked CE (4 chunks) against one chunk and against
    cross_entropy over ``forward``'s full logits (padded columns cut), on
    reduced MiniCPM (vocab 511, padded to 512: the mask)."""
    cfg, _ = _cfgs("minicpm-2b")
    model = tf.init_model(cfg, device="cpu").requires_grad_()
    rs = np.random.RandomState(2)
    toks, labels = (rs.randint(0, cfg.vocab_size, size=(B, S))
                    .astype(np.int32) for _ in range(2))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    chunked, g_chunked = _port_loss(model, toks, labels, pos, ce_chunk=8)
    whole, g_whole = _port_loss(model, toks, labels, pos, ce_chunk=S)
    assert float(chunked) == pytest.approx(float(whole), rel=1e-6)
    _close_leaves(g_chunked, g_whole, scale=1e-5, per_leaf=False)
    logits = tf.forward(model, torch.from_numpy(toks), torch.from_numpy(pos),
                        impl="ref")
    ce = torch.nn.functional.cross_entropy(
        logits[..., :cfg.vocab_size].flatten(0, 1).float(),
        torch.from_numpy(labels).long().flatten())
    assert float(chunked) == pytest.approx(float(ce), rel=1e-5)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _ref_state_np(state):
    return {"params": jax.tree.map(np.asarray, state.params),
            "mu": jax.tree.map(np.asarray, state.opt.mu),
            "nu": jax.tree.map(np.asarray, state.opt.nu),
            "count": np.asarray(state.opt.count),
            "step": np.asarray(state.step)}


def _recording(update, copy):
    """``adamw_update`` that also returns the gradients it was given, as
    metric "g_in" (the jitted reference step returns its metrics)."""
    def wrapped(params, grads, state, opt):
        p, s, m = update(params, grads, state, opt)
        return p, s, {**m, "g_in": copy(grads)}
    return wrapped


def _per_layer_round_trip(grads):
    """The reference's int8 round trip on the port's leaves: the stacked
    layers' leaves are quantised one layer at a time (train_lib's doc)."""
    rt = lambda x: jax_comp._dequantize(*jax_comp._quantize(x))
    return {k: jax.tree.map(jax.vmap(rt) if k == "layers" else rt, v)
            for k, v in grads.items()}


def _codes(g):
    """An int8 round trip's output read back as (values over their block
    scale, which are its codes, and the block scales): each block's
    largest |value| is its code 127."""
    flat = _np(g).reshape(-1)
    blocks = np.pad(flat, (0, (-flat.size) % 256)).reshape(-1, 256)
    scale = np.maximum(np.abs(blocks).max(1, keepdims=True) / 127, 1e-12)
    return blocks / scale, scale


@pytest.mark.parametrize("compress", [False, True])
def test_train_step_matches_reference(compress, monkeypatch):
    """3 steps from the same converted state on the same batches,
    microbatches 2: loss and grad norm per step; the gradient entering
    ``adamw_update`` at each step; then parameters and moments where every
    step's gradient is not near 0 (module doc).

    With compression both steps quantise the port's per-layer leaves (the
    reference's round trip applied one layer at a time).  The gradients
    entering the update must be int8 codes times block scales on both
    sides; the scales, each block's largest |g|, within the gradient
    bound; each code within one of the reference's, and at most
    ``FLIPS`` of them off by one: an element whose accumulated gradient
    sits at a rounding boundary of its code takes the neighbouring code on
    one side.  Parameters and moments are then held as without
    compression, where every step's codes agree as well."""
    cfg, jcfg = _cfgs("granite-8b")
    jopt, opt = jax_opt.OptConfig(**OPT), optimizer.OptConfig(**OPT)
    jstate = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    state = train_state_from_reference(_ref_state_np(jstate), cfg)
    monkeypatch.setattr(jax_train, "adamw_update",
                        _recording(jax_train.adamw_update, lambda g: g))
    monkeypatch.setattr(train_lib, "adamw_update", _recording(
        train_lib.adamw_update, lambda g: {n: t.clone()
                                           for n, t in g.items()}))
    if compress:
        monkeypatch.setattr(jax_train, "compress_gradients", lambda g: g)
        monkeypatch.setattr(jax_train, "decompress_gradients",
                            _per_layer_round_trip)
    jstep = jax.jit(jax_train.make_train_step(
        jcfg, jopt, microbatches=2, compress_grads=compress))
    step = make_train_step(cfg, opt, microbatches=2, compress_grads=compress)
    pipe = JaxPipeline(cfg.vocab_size, 4, S, seed=5)
    jgrad = jax.jit(jax.grad(lambda p, b: jax_tf.lm_loss(
        p, jcfg, b["inputs"], b["labels"], b["positions"])))
    mask, flips, total = None, 0, 0
    for _ in range(3):
        b = _jbatch(pipe, 4, S)
        g = unstack(jax.tree.map(_np, jgrad(jstate.params, b)), cfg)
        big = {n: np.abs(x) > 1e-6 * np.abs(x).max() for n, x in g.items()}
        mask = big if mask is None else {n: mask[n] & big[n] for n in big}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _tbatch(b))
        for k in ("loss", "grad_norm", "lr"):
            assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
        assert int(m["step"]) == int(jm["step"])
        want = unstack(jax.tree.map(_np, jm["g_in"]), cfg)
        if not compress:
            _close_leaves(m["g_in"], want, per_leaf=False)
            continue
        top = max(np.abs(w).max() for w in want.values())
        for n, w in want.items():
            (xp, sp), (xr, sr) = _codes(m["g_in"][n]), _codes(w)
            for x in (xp, xr):
                assert np.abs(x - np.rint(x)).max() <= 1e-3, n
            assert 127 * np.abs(sp - sr).max() <= 1e-4 * top, n
            qp, qr = np.rint(xp), np.rint(xr)
            assert np.abs(qp - qr).max() <= 1, n
            flips += int((qp != qr).sum())
            total += w.size
            same = (qp == qr).reshape(-1)[:w.size].reshape(w.shape)
            mask[n] &= same
    if compress:
        assert flips <= FLIPS * total, (flips, total)
    want = _ref_state_np(jstate)
    assert int(state.opt.count) == int(want["count"]) == 3
    _close_leaves(state.params, unstack(want["params"], cfg), mask=mask)
    _close_leaves(state.opt.mu, unstack(want["mu"], cfg), mask=mask)
    _close_leaves(state.opt.nu, unstack(want["nu"], cfg), mask=mask)


def _bf16_granite():
    cfg = get_reduced_config("granite-8b")
    return cfg, optimizer.OptConfig(**OPT)


def _losses(state, step, pipe, n):
    out = []
    for _ in range(n):
        state, m = step(state, _tbatch(_jbatch(pipe, 4, S)))
        out.append(float(m["loss"]))
    return out


def test_loss_descends():
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    losses = _losses(state, make_train_step(cfg, opt, microbatches=2),
                     TokenPipeline(cfg.vocab_size, 4, S, seed=0), 25)
    assert losses[-1] < losses[0] - 0.5
    assert all(np.isfinite(losses))


def test_training_with_compression_descends():
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    losses = _losses(state, make_train_step(cfg, opt, compress_grads=True),
                     TokenPipeline(cfg.vocab_size, 4, S, seed=2), 15)
    assert losses[-1] < losses[0] - 0.3


def test_microbatching_equivalence():
    """mb=1 and mb=4 give (nearly) the same update in bf16."""
    cfg, opt = _bf16_granite()
    s1 = init_train_state(cfg, opt, device="cpu")
    s4 = init_train_state(cfg, opt, device="cpu")
    batch = _tbatch(_jbatch(TokenPipeline(cfg.vocab_size, 4, S, seed=3),
                            4, S))
    s1, m1 = make_train_step(cfg, opt, microbatches=1)(s1, batch)
    s4, m4 = make_train_step(cfg, opt, microbatches=4)(s4, batch)
    assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=2e-2)
    assert max(float((a.float() - b.float()).abs().max())
               for a, b in zip(s1.params.values(),
                               s4.params.values())) < 0.1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _leaves_equal(a: TrainState, b: TrainState):
    ta, tb = a.tree(), b.tree()
    for key in ("params", "mu", "nu"):
        assert list(ta[key]) == list(tb[key])
        for n in ta[key]:
            assert ta[key][n].dtype == tb[key][n].dtype
            assert torch.equal(ta[key][n], tb[key][n]), (key, n)
    assert torch.equal(a.opt.count, b.opt.count)
    assert torch.equal(a.step, b.step)


def test_checkpoint_roundtrip(tmp_path):
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    state, _ = make_train_step(cfg, opt)(state, _tbatch(_jbatch(
        TokenPipeline(cfg.vocab_size, 4, S, seed=0), 4, S)))
    save_checkpoint(str(tmp_path), 7, state)
    restored = restore_checkpoint(str(tmp_path), state)
    assert restored.model is not state.model
    assert restored.model.tok.requires_grad
    _leaves_equal(restored, state)
    assert int(restored.step) == 1


def test_checkpoint_atomic_and_retention(tmp_path):
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    mgr.wait()
    kept = sorted(x for x in os.listdir(tmp_path) if x.startswith("step_"))
    assert kept == ["step_00000003", "step_00000004"]
    assert not any(x.endswith(".tmp") for x in os.listdir(tmp_path))
    assert mgr.latest == 4


def test_reference_checkpoint_restores_bit_for_bit(tmp_path):
    """The reference's ``save_checkpoint`` of its reduced granite (bf16
    parameters, float32 moments) after one step, read by the port through
    ``convert.py``'s unstacking."""
    jcfg = jax_reduced_config("granite-8b")
    cfg = get_reduced_config("granite-8b")
    jopt = jax_opt.OptConfig(**OPT)
    jstate = jax_train.init_train_state(jax.random.PRNGKey(2), jcfg, jopt)
    b = _jbatch(JaxPipeline(cfg.vocab_size, 4, S, seed=1), 4, S)
    jstate, _ = jax.jit(jax_train.make_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in b.items()})
    jax_ckpt.save_checkpoint(str(tmp_path), 1, jstate)
    got = read_reference_checkpoint(str(tmp_path), cfg)
    want = _ref_state_np(jstate)
    assert got.model.tok.dtype == torch.bfloat16
    for key, tree in (("params", got.params), ("mu", got.opt.mu),
                      ("nu", got.opt.nu)):
        ref = unstack(want[key], cfg)
        assert set(tree) == set(ref)
        for n, t in tree.items():
            assert str(t.dtype).removeprefix("torch.") == str(ref[n].dtype)
            np.testing.assert_array_equal(t.detach().float().numpy(),
                                          _np(ref[n]))
    assert int(got.opt.count) == int(got.step) == 1


# ---------------------------------------------------------------------------
# supervisor and resilience
# ---------------------------------------------------------------------------


def _supervised(sup_cls, step, state, ckpt, batches, failures):
    sup = sup_cls(step, ckpt, ckpt_every=5)
    out = sup.run(state, batches, failures=failures)
    return sup, out


def test_supervisor_log_matches_reference(tmp_path):
    """The same failure schedule on the reference's step and the port's:
    the same restarts and steps, losses within 1e-4 relative; after the
    restart the failed step's batch is consumed, not replayed."""
    cfg, jcfg = _cfgs("granite-8b")
    jopt, opt = jax_opt.OptConfig(**OPT), optimizer.OptConfig(**OPT)
    jstate = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    state = train_state_from_reference(_ref_state_np(jstate), cfg)
    pipe = JaxPipeline(cfg.vocab_size, 4, S, seed=1)
    batches = [_jbatch(pipe, 4, S) for _ in range(16)]
    fails = lambda mod: [mod.FailureEvent(step=7), mod.FailureEvent(step=11)]
    jsup, _ = _supervised(
        jax_res.TrainingSupervisor,
        jax.jit(jax_train.make_train_step(jcfg, jopt)), jstate,
        jax_ckpt.CheckpointManager(str(tmp_path / "ref"), keep=2,
                                   async_save=False),
        [{k: jnp.asarray(v) for k, v in b.items()} for b in batches],
        fails(jax_res))
    sup, out = _supervised(
        TrainingSupervisor, make_train_step(cfg, opt), state,
        CheckpointManager(str(tmp_path / "port"), keep=2, async_save=False),
        [_tbatch(b) for b in batches], fails(port_res))
    assert sup.restarts == jsup.restarts == 2
    assert [(e["event"], e.get("step"), e.get("from_step"))
            for e in sup.log] == [(e["event"], e.get("step"),
                                   e.get("from_step")) for e in jsup.log]
    for a, b in zip(sup.log, jsup.log):
        if a["event"] == "step":
            assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
    assert int(out.step) == 11


def test_failure_restart_continuity(tmp_path):
    """Supervisor restarts from the checkpoint and final loss still
    descends below the pre-failure level."""
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    sup = TrainingSupervisor(make_train_step(cfg, opt), mgr, ckpt_every=5)
    pipe = TokenPipeline(cfg.vocab_size, 4, S, seed=1)
    batches = [_tbatch(_jbatch(pipe, 4, S)) for _ in range(20)]
    out = sup.run(state, batches, failures=[FailureEvent(step=12)])
    assert sup.restarts == 1
    steps = [e for e in sup.log if e["event"] == "step"]
    assert steps[-1]["loss"] < steps[0]["loss"]
    assert int(out.step) >= 15


def test_restart_during_async_save_logs_the_step_it_restores(
        tmp_path, monkeypatch):
    """A failure at step 4, while the async save of step 4 is still being
    written (each save slowed by 0.3 s): the supervisor must log the step
    it restores, so ``latest`` waits for the save in flight (the
    reference's reads the directory at once and logs step 2)."""
    cfg, opt = _bf16_granite()
    state = init_train_state(cfg, opt, device="cpu")
    write = ckpt_mod.save_checkpoint

    def slow_save(*args, **kwargs):
        time.sleep(0.3)
        write(*args, **kwargs)

    monkeypatch.setattr(ckpt_mod, "save_checkpoint", slow_save)
    at_step = []

    def step_fn(state, batch):
        at_step.append(int(state.step))
        return TrainState(state.model, state.opt, state.step + 1), \
            {"loss": 0.0}

    sup = TrainingSupervisor(step_fn, CheckpointManager(
        str(tmp_path), keep=3, async_save=True), ckpt_every=2)
    sup.run(state, range(8), failures=[FailureEvent(step=4)])
    restart, = [e for e in sup.log if e["event"] == "restart"]
    assert restart["from_step"] == 4
    assert at_step == [0, 1, 2, 3, 4, 5, 6]


def test_heartbeat_monitor():
    t = [0.0]
    mon = HeartbeatMonitor(["w0", "w1"], timeout_s=10, clock=lambda: t[0])
    t[0] = 5.0
    mon.beat("w0")
    t[0] = 12.0
    assert mon.dead_workers() == ["w1"]


def test_straggler_detector():
    det = StragglerDetector(threshold=1.5, patience=2)
    assert det.observe({"a": 1.0, "b": 1.0, "c": 2.0}) == []
    assert det.observe({"a": 1.0, "b": 1.0, "c": 2.0}) == ["c"]
    assert det.observe({"a": 1.0, "b": 1.0, "c": 1.0}) == []


# ---------------------------------------------------------------------------
# launchers, and the kernels' grad guard
# ---------------------------------------------------------------------------


def test_train_main_prints_what_the_reference_prints(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_mod.main(["--arch", "granite-8b", "--steps", "6",
                              "--device", "cpu", "--ckpt-every", "4",
                              "--ckpt-dir", str(tmp_path)])
    lines = buf.getvalue().splitlines()
    assert lines[0] == ("training granite-8b (reduced: 2L d=128) for 6 "
                        "steps")
    assert re.fullmatch(r"loss \d+\.\d{3} -> \d+\.\d{3} in \d+s "
                        r"\(6 steps, 0 restarts\)", lines[1])
    assert out["finite"] and len(out["grad_norms"]) == 6
    assert out["losses"][-1] < out["losses"][0]
    assert os.listdir(tmp_path) == ["step_00000004"]


def test_train_main_refuses_what_takes_no_tokens():
    with pytest.raises(NotImplementedError, match="mrope"):
        train_mod.check_trainable(replace(get_reduced_config("granite-8b"),
                                          rope_type="mrope"))


def test_train_small_restarts_and_learns():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = train_small.main(["--steps", "40", "--fail-at", "20",
                                "--ckpt-every", "10", "--device", "cpu"])
    lines = buf.getvalue().splitlines()
    assert re.fullmatch(r"model: 6L d=128 \(1\.8M params\)", lines[0])
    assert re.match(r"steps: 39  restarts: 1  wall: ", lines[1])
    assert lines[-1] == "OK"
    assert out["supervisor"].log[20] == {"event": "restart", "from_step": 20,
                                         "kind": "worker_loss", "mesh": None}


def _wrapper_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)
    q, k = r(1, 2, 16, 16), r(1, 2, 16, 16)
    pages = r(4, 4, 2, 16)
    tabs = torch.arange(4, dtype=torch.int32).view(1, 4)
    lens = torch.tensor([10], dtype=torch.int32)
    return {
        "flash_prefill": (fp.flash_prefill, (q, k, k)),
        "paged_attention": (pa.paged_attention, (r(1, 2, 16), pages, pages,
                                                 tabs, lens)),
        "unified_pd": (up.unified_pd, (q, k, k, r(1, 2, 16), pages, pages,
                                       tabs, lens)),
        "ssm_scan": (ss.ssm_scan, (r(1, 8, 4), r(1, 8, 4).abs(),
                                   -r(4, 4).abs(), r(1, 8, 4), r(1, 8, 4))),
    }


@pytest.mark.parametrize("name", ["flash_prefill", "paged_attention",
                                  "unified_pd", "ssm_scan"])
def test_kernel_wrappers_refuse_grad(name):
    """The kernels have no backward: an input that requires grad under grad
    mode raises, on the CPU (the plain version) as on the card; under
    no_grad the same call runs."""
    fn, args = _wrapper_cases()[name]
    fn(*args)
    args[0].requires_grad_()
    with pytest.raises(RuntimeError, match=f"{name} has no backward"):
        fn(*args)
    with torch.no_grad():
        fn(*args)


# ---------------------------------------------------------------------------
# the train cell and its state's specs (launch/steps.py build_train_cell)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x7b"])
def test_train_state_specs_mirror_reference(arch):
    """The moments take their parameters' logical axes, the counts none:
    the reference's ``train_state_specs``, leaf by leaf (each layer's
    specs less the stacked period dim)."""
    from repro.training.train_lib import train_state_specs as jax_specs
    from repro_torch.models import transformer as tf_mod
    from repro_torch.training.train_lib import train_state_specs
    cfg = get_reduced_config(arch)
    mine = train_state_specs(tf_mod.param_specs(cfg))
    _, jspecs = jax_tf.init_model_shapes(jax.random.PRNGKey(0),
                                         jax_reduced_config(arch))
    theirs = jax_specs(jspecs)
    assert mine["count"] == theirs.opt.count == () and \
        mine["step"] == theirs.step == ()
    top = {"tok": ("embed", "tok"), "lm_head": ("lm_head", "w"),
           "final_norm": ("final_norm", "w")}
    for part, tree in (("mu", theirs.opt.mu), ("nu", theirs.opt.nu)):
        assert mine[part] == mine["params"]
        for name, spec in mine[part].items():
            if name in top:
                a, b = top[name]
                assert tuple(spec) == tuple(tree[a][b]), name
                continue
            _, i, sub, *leaf = name.split(".")
            node = tree["layers"][f"pos{int(i) % cfg.period}"][sub]
            ref = node["w"] if not leaf else node[leaf[0]]
            assert tuple(spec) == tuple(ref)[1:], name


def test_train_cell_is_the_train_step():
    """``build_train_cell`` without a mesh is ``make_train_step`` on the
    cell's state: the same loss, grad norm and parameters, bit for bit."""
    from repro_torch.config import ShapeConfig
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf_mod
    cfg = replace(get_reduced_config("granite-8b"), dtype="float32")
    opt = optimizer.OptConfig(lr=1e-3)
    shape = ShapeConfig("train", 16, 4, "train")
    a = tf_mod.init_model(cfg, device="cpu", seed=2).requires_grad_()
    b = tf_mod.init_model(cfg, device="cpu", seed=2).requires_grad_()
    cell = steps.build_train_cell(a, shape, opt=opt, microbatches=2)
    batch = cell.materialize(6, "cpu")
    got = cell(**batch)
    state, want = make_train_step(cfg, opt, microbatches=2)(
        train_lib.train_state_from_model(b, opt), batch)
    assert torch.equal(got["loss"], want["loss"])
    assert torch.equal(got["grad_norm"], want["grad_norm"])
    for (n, p), q in zip(cell.state.model.named_parameters(),
                         state.model.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("arch", ["qwen2-vl-72b", "musicgen-large"])
def test_embed_stub_train_step_matches_reference(arch, monkeypatch):
    """An ``embed_stub`` model (embeddings in, its token table unread)
    trains as the reference's: on the same embeddings, positions (M-RoPE
    for Qwen2-VL) and labels, one step's loss and grad norm match, the
    gradients entering ``adamw_update`` match (the table's zero on both
    sides, as ``jax.grad`` gives it), and the table's update is the weight
    decay alone on both.  (``adamw_update`` itself is held to the
    reference above.)"""
    from repro_torch.launch import steps
    cfg, jcfg = _cfgs(arch)
    jopt, opt = jax_opt.OptConfig(**OPT), optimizer.OptConfig(**OPT)
    jstate = jax_train.init_train_state(jax.random.PRNGKey(0), jcfg, jopt)
    state = train_state_from_reference(_ref_state_np(jstate), cfg)
    monkeypatch.setattr(jax_train, "adamw_update",
                        _recording(jax_train.adamw_update, lambda g: g))
    monkeypatch.setattr(train_lib, "adamw_update", _recording(
        train_lib.adamw_update, lambda g: {n: t.clone()
                                           for n, t in g.items()}))
    rng = np.random.default_rng(3)
    batch = steps._prompt_args(cfg, rng, B, S, "cpu", torch.float32)
    batch["labels"] = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32))
    jstate, jm = jax.jit(jax_train.make_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v.numpy()) for k, v in batch.items()})
    state, m = make_train_step(cfg, opt)(state, batch)
    for k in ("loss", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-4), k
    want = unstack(jax.tree.map(_np, jm["g_in"]), cfg)
    assert not np.any(want["tok"]) and not torch.any(m["g_in"]["tok"])
    _close_leaves(m["g_in"], want, per_leaf=False)
    tok = unstack(_ref_state_np(jstate)["params"], cfg)["tok"]
    _close_leaves({"tok": state.params["tok"]}, {"tok": tok})
