"""The port's Mamba mixer, selective scan and hybrid model against the
reference.

Reduced Jamba with every FFN dense (``ffn_pattern=("dense",)``: the MoE
FFN is not ported), in float32.  The reference's weights are converted
(``repro_torch.convert``) so both sides compute with the same numbers.
The reference runs its plain paths only: the sequential scan
``kernels/ref.py`` and the chunked associative scan of
``models/mamba.py`` (``impl="ref"``); its Pallas scan does not run under
the installed JAX.  The port's kernel wrappers compute their plain
versions on CPU tensors.  The scan is held to atol = rtol = 2e-4, the
reference's own scan tolerance; the model to 1e-4, as in
``test_torch_models.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import _reference_greedy

from repro.config import get_config as jax_config
from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.kernels import ref as jax_ref
from repro.models import layers as jax_layers
from repro.models import mamba as jax_mamba
from repro.models import transformer as jax_tf
from repro_torch.config import get_config, get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as ssm_scan_mod
from repro_torch.kernels.ssm_scan import check_scan
from repro_torch.launch import serve_real
from repro_torch.models import layers, mamba
from repro_torch.models import transformer as tf

ARCH = "jamba-1.5-large-398b"
SCAN_TOL = dict(atol=2e-4, rtol=2e-4)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs():
    """(port cfg, reference cfg): reduced Jamba, dense FFNs, float32."""
    kw = dict(ffn_pattern=("dense",), dtype="float32")
    return (replace(get_reduced_config(ARCH), **kw),
            jax_replace(jax_reduced_config(ARCH), **kw))


@pytest.fixture(scope="module")
def models():
    """(port model, reference params, port cfg, reference cfg)."""
    cfg, jcfg = _cfgs()
    params, _ = jax_tf.init_model(jax.random.PRNGKey(0), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    return model, params, cfg, jcfg


def _normal(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _tokens(rs, cfg, B, S):
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# (a) the plain scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,L,din,ds", [(2, 64, 32, 8), (1, 128, 64, 16),
                                        (2, 96, 48, 4), (1, 60, 40, 8)])
def test_ssm_scan_plain_matches_reference(B, L, din, ds):
    """The port's plain scan (and ``ops.ssm_scan`` on CPU tensors) ==
    the reference's sequential and chunked associative scans."""
    rs = np.random.RandomState(L)
    xs = _normal(rs, B, L, din)
    dt = np.logaddexp(0, _normal(rs, B, L, din)).astype(np.float32)
    A = -np.exp(_normal(rs, din, ds) * 0.3)
    Bm, Cm = _normal(rs, B, L, ds), _normal(rs, B, L, ds)
    args = [jnp.asarray(a) for a in (xs, dt, A, Bm, Cm)]
    wants = [jax_ref.ssm_scan(*args), jax_mamba.ssm_scan_ref(*args)]
    targs = [torch.from_numpy(a) for a in (xs, dt, A, Bm, Cm)]
    before = ops.launches()["ssm_scan"]
    gots = [ref.ssm_scan(*targs), ops.ssm_scan(*targs)]
    assert ops.launches()["ssm_scan"] == before      # CPU: no kernel launch
    for y, h in gots:
        assert y.shape == (B, L, din) and h.shape == (B, din, ds)
        for y_want, h_want in wants:
            np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                       **SCAN_TOL)
            np.testing.assert_allclose(h.numpy(), np.asarray(h_want),
                                       **SCAN_TOL)


@pytest.mark.parametrize("B,L,din,ds", [(2, 64, 32, 8), (1, 128, 64, 16),
                                        (2, 96, 48, 4), (1, 60, 40, 8)])
def test_ssm_scan_from_h0_matches_reference(B, L, din, ds):
    """The port's plain scan and ``ops.ssm_scan`` from a given state h0
    == the reference's sequential and chunked scans from the same h0, in
    float32 to the kernels' 3e-5."""
    rs = np.random.RandomState(L + 1)
    xs = _normal(rs, B, L, din)
    dt = np.logaddexp(0, _normal(rs, B, L, din)).astype(np.float32)
    A = -np.exp(_normal(rs, din, ds) * 0.3)
    Bm, Cm = _normal(rs, B, L, ds), _normal(rs, B, L, ds)
    h0 = _normal(rs, B, din, ds)
    args = [jnp.asarray(a) for a in (xs, dt, A, Bm, Cm)]
    wants = [jax_ref.ssm_scan(*args, h0=jnp.asarray(h0)),
             jax_mamba.ssm_scan_ref(*args, h0=jnp.asarray(h0))]
    targs = [torch.from_numpy(a) for a in (xs, dt, A, Bm, Cm)]
    th0 = torch.from_numpy(h0)
    gots = [ref.ssm_scan(*targs, h0=th0), ops.ssm_scan(*targs, h0=th0)]
    for y, h in gots:
        for y_want, h_want in wants:
            np.testing.assert_allclose(y.numpy(), np.asarray(y_want),
                                       atol=3e-5, rtol=3e-5)
            np.testing.assert_allclose(h.numpy(), np.asarray(h_want),
                                       atol=3e-5, rtol=3e-5)
    # the state is read, not written: h0 is unchanged
    np.testing.assert_array_equal(th0.numpy(), h0)


def test_scan_input_checks_reject_a_bad_h0():
    """h0 must be float32 (B, din, ds); the check refuses anything else
    before a launch."""
    xs, A, Bm = torch.zeros(2, 5, 40), torch.zeros(40, 8), torch.zeros(2, 5, 8)
    check_scan(xs, xs, A, Bm, Bm, torch.zeros(2, 40, 8))
    with pytest.raises(ValueError, match="h0"):
        check_scan(xs, xs, A, Bm, Bm, torch.zeros(1, 40, 8))
    with pytest.raises(ValueError, match="h0"):
        check_scan(xs, xs, A, Bm, Bm, torch.zeros(2, 40, 16))
    with pytest.raises(TypeError, match="float32"):
        check_scan(xs, xs, A, Bm, Bm, torch.zeros(2, 40, 8,
                                                  dtype=torch.bfloat16))


def test_scan_input_checks_reject_what_the_kernel_cannot_take():
    """The checks run before a launch; they need no card to be tested."""
    xs, A, Bm = torch.zeros(1, 5, 40), torch.zeros(40, 8), torch.zeros(1, 5, 8)
    check_scan(xs, xs, A, Bm, Bm)
    with pytest.raises(ValueError, match="d_state"):
        check_scan(xs, xs, torch.zeros(40, 12), torch.zeros(1, 5, 12),
                   torch.zeros(1, 5, 12))
    with pytest.raises(ValueError, match="Cm"):
        check_scan(xs, xs, A, Bm, torch.zeros(1, 4, 8))
    with pytest.raises(TypeError, match="float32"):
        check_scan(xs, xs.bfloat16(), A, Bm, Bm)


def test_scan_operands_are_made_dense_and_aligned():
    """B and C are sliced out of one projection, so their rows may start
    off a 16-byte boundary; the kernel takes only dense, aligned operands,
    so the wrapper copies such a view and passes a dense one as it is."""
    proj = torch.arange(2 * 5 * 21, dtype=torch.float32).reshape(2, 5, 21)
    Bm = proj[..., 5:13]          # strided, starting 20 bytes in
    dense = ssm_scan_mod._dense(Bm)
    assert dense.is_contiguous() and dense.data_ptr() % 16 == 0
    assert torch.equal(dense, Bm)
    flat = torch.arange(41, dtype=torch.float32)[1:]   # dense, 4 bytes in
    moved = ssm_scan_mod._dense(flat)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, flat)
    whole = torch.zeros(2, 5, 8)
    assert ssm_scan_mod._dense(whole) is whole
    for ds in ssm_scan_mod.D_STATES:
        assert ds % ssm_scan_mod.LANES[ds] == 0


# ---------------------------------------------------------------------------
# (b) the mixer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mixer():
    """One reduced Mamba mixer on both sides, with every leaf random (the
    reference initialises conv_b and dt_bias to zero)."""
    cfg, jcfg = _cfgs()
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(1), jnp.float32)
    jax_mamba.init_mamba(b, jcfg)
    rs = np.random.RandomState(2)
    for name in ("conv_b", "dt_bias", "D"):
        b.params[name] = jnp.asarray(_normal(rs, *b.params[name].shape))
    b.params["A_log"] = b.params["A_log"] + jnp.asarray(
        _normal(rs, *b.params["A_log"].shape) * 0.1)
    p = mamba.Mamba(layers.ParamInit(None, "cpu", torch.float32), cfg)
    for name, leaf in b.params.items():
        getattr(p, name).data.copy_(_t(leaf))
    return p, b.params, cfg, jcfg


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("L", [13, 2])      # 2 < d_conv - 1
def test_mamba_forward_and_decode_match_reference(mixer, impl, L):
    """Prefill output and final state (conv window, SSM state), then two
    single-token steps from that state: output and new state."""
    p, jp, cfg, jcfg = mixer
    rs = np.random.RandomState(L)
    x = _normal(rs, 2, L, cfg.d_model)
    want, jstate = jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x),
                                           return_state=True, impl="ref")
    got, state = mamba.mamba_forward(p, cfg, torch.from_numpy(x), impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert state["conv"].shape == (2, cfg.mamba.d_conv - 1, cfg.d_inner)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   **LOGIT_TOL)
    for _ in range(2):
        x1 = _normal(rs, 2, 1, cfg.d_model)
        want, jstate = jax_mamba.mamba_decode_step(jp, jcfg, jnp.asarray(x1),
                                                   jstate)
        got, state = mamba.mamba_decode_step(p, cfg, torch.from_numpy(x1),
                                             state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(jstate[k]), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("L", [9, 2])       # 2 < d_conv - 1
def test_mamba_forward_from_state_matches_reference(mixer, impl, L):
    """A prompt's next L tokens from the state its first 7 left (conv
    window and SSM state) == the reference's ``mamba_forward(state=)``:
    output and final state; and == the port's prefill of all 7 + L tokens
    at once."""
    p, jp, cfg, jcfg = mixer
    rs = np.random.RandomState(20 + L)
    x0, x1 = _normal(rs, 2, 7, cfg.d_model), _normal(rs, 2, L, cfg.d_model)
    _, jstate = jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x0),
                                        return_state=True, impl="ref")
    want, jnew = jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x1),
                                         state=jstate, return_state=True,
                                         impl="ref")
    state = {k: _t(v) for k, v in jstate.items()}
    got, new = mamba.mamba_forward(p, cfg, torch.from_numpy(x1), impl=impl,
                                   state=state)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(jnew[k]),
                                   **LOGIT_TOL)
    whole, whole_state = mamba.mamba_forward(
        p, cfg, torch.from_numpy(np.concatenate([x0, x1], 1)), impl=impl)
    np.testing.assert_allclose(got.numpy(), whole[:, 7:].numpy(),
                               **LOGIT_TOL)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(new[k].numpy(), whole_state[k].numpy(),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# (c) conversion and configuration
# ---------------------------------------------------------------------------


def test_convert_keeps_float32_leaves_in_bf16_model():
    """A bf16 reference converts to a bf16 model whose A_log and D stay
    float32 and unchanged; every other leaf is bf16."""
    cfg = replace(get_reduced_config(ARCH), ffn_pattern=("dense",))
    jcfg = jax_replace(jax_reduced_config(ARCH), ffn_pattern=("dense",))
    params, _ = jax_tf.init_model(jax.random.PRNGKey(3), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    for i, blk in enumerate(model.layers):
        if blk.kind != "mamba":
            continue
        leaves = params["layers"][f"pos{i}"]["mixer"]
        for name, t in blk.mixer.named_parameters():
            want = np.asarray(leaves[name][0], np.float32)
            if name in ("A_log", "D"):
                assert t.dtype == torch.float32, name
            else:
                assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(t.float().numpy(), want)
    fresh = tf.init_model(cfg, seed=0)
    m = fresh.layers[0].mixer
    assert m.A_log.dtype == m.D.dtype == torch.float32
    assert m.in_proj.dtype == torch.bfloat16
    np.testing.assert_allclose(m.A_log[5].numpy(),
                               np.log(np.arange(1, cfg.mamba.d_state + 1)),
                               rtol=1e-6)


@pytest.mark.parametrize("reduced", [False, True])
def test_jamba_config_matches_reference(reduced):
    mine = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    theirs = jax_reduced_config(ARCH) if reduced else jax_config(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "d_ff",
              "vocab_size", "head_dim", "layer_pattern", "ffn_pattern",
              "rope_type", "tie_embeddings", "dtype", "d_inner", "dt_rank",
              "period", "vocab_padded"):
        assert getattr(mine, f) == getattr(theirs, f), f
    for f in ("d_state", "d_conv", "expand", "dt_rank"):
        assert getattr(mine.mamba, f) == getattr(theirs.mamba, f), f
    for f in ("num_experts", "top_k", "d_ff_expert", "capacity_factor"):
        assert getattr(mine.moe, f) == getattr(theirs.moe, f), f


@pytest.mark.parametrize("reduced", [False, True])
def test_unchanged_jamba_raises_naming_moe_layers(reduced):
    """Either config as it stands has MoE layers: building refuses, before
    any weight is allocated."""
    cfg = get_reduced_config(ARCH) if reduced else get_config(ARCH)
    with pytest.raises(NotImplementedError, match=r"MoE.*\[1, 3, 5"):
        tf.init_model(cfg)


def test_serve_main_on_jamba_raises_until_moe_is_ported():
    with pytest.raises(NotImplementedError, match="MoE"):
        serve_real.main(["--device", "cpu", "--arch", ARCH,
                         "--requests", "1"])


# ---------------------------------------------------------------------------
# (d) the hybrid model
# ---------------------------------------------------------------------------


def test_forward_matches_reference(models):
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(4)
    B, S = 2, 19
    toks = _tokens(rs, cfg, B, S)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, jaux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                jnp.asarray(pos), 1, impl="ref",
                                return_aux=True)
    ops.reset_launches()
    got, aux = tf.forward(model, torch.from_numpy(toks),
                          torch.from_numpy(pos), return_aux=True)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert [sorted(a) for a in aux] == \
        [["k", "v"] if cfg.mixer_at(i) == "attn" else ["conv", "ssm"]
         for i in range(cfg.num_layers)]
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(aux[7][k].numpy(),
                                   np.asarray(jaux["pos7"][k][0]),
                                   **LOGIT_TOL)
    np.testing.assert_allclose(aux[4]["k"].numpy(),
                               np.asarray(jaux["pos4"]["k"][0]), **LOGIT_TOL)


def _reference_step(params, jcfg, toks, Sc):
    """The reference's prefill of ``toks`` (B,S) into a slot-dense cache of
    Sc positions, then one decode step of each row's greedy token."""
    B, S = toks.shape
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    logits, aux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                 jnp.asarray(pos), 1, return_aux=True,
                                 last_only=True)
    cache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, B, Sc, 1), aux, S)
    nxt = np.asarray(jax_tf.greedy_sample(logits, jcfg.vocab_size))
    lens = np.full((B,), S, np.int32)
    want, new = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                      jnp.asarray(lens[:, None]), cache,
                                      jnp.asarray(lens), 1)
    return nxt, want, new


def _port_prefilled(model, cfg, toks, slots, n_slots, page=8,
                    n_blocks=16):
    """The port's prefill of ``toks`` (B,S) into scattered blocks and the
    state rows ``slots``.  Returns (cache, block tables, seq lens)."""
    B, S = toks.shape
    np_ = -(-(S + 1) // page)
    blocks = np.random.RandomState(9).permutation(n_blocks)[:B * np_]
    tables = torch.from_numpy(blocks.reshape(B, np_).astype(np.int32))
    cache = tf.init_cache(cfg, n_blocks, page, n_slots, dtype=torch.float32)
    pos = torch.arange(S).expand(B, S)
    _, aux = tf.forward(model, torch.from_numpy(toks), pos, return_aux=True,
                        last_only=True)
    tf.write_prefill_to_cache(cache, aux, tables, slots)
    return cache, tables, torch.full((B,), S, dtype=torch.int32)


def _check_states(cache, slots, jcache, cfg):
    for i in range(cfg.num_layers):
        if cfg.mixer_at(i) != "mamba":
            continue
        for k in ("conv", "ssm"):
            np.testing.assert_allclose(cache[i][k][slots].numpy(),
                                       np.asarray(jcache[f"pos{i}"][k][0]),
                                       **LOGIT_TOL)


def test_decode_after_prefill_with_permuted_slots(models):
    """Prefill written to state rows (2, 0, 3) of 4 and to scattered KV
    blocks, then one decode step == the reference's slot-dense cache."""
    model, params, cfg, jcfg = models
    toks = _tokens(np.random.RandomState(5), cfg, 3, 11)
    nxt, want, jnew = _reference_step(params, jcfg, toks, 16)
    slots = torch.tensor([2, 0, 3])
    cache, tables, lens = _port_prefilled(model, cfg, toks, slots, 4)
    got, cache = tf.decode_forward(model, _t(nxt), lens[:, None], cache,
                                   tables, lens, slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    _check_states(cache, slots, jnew, cfg)
    assert not cache[0]["ssm"][1].any()         # the unused row untouched


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_fused_pd_forward_matches_reference(models, impl):
    """One concurrent step (2 prompts of 17 tokens + 3 decode rows at state
    rows (1, 4, 2)) == the reference's forward (last position) + decode:
    logits, the prompts' final states, the decode rows' new states."""
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(6)
    dtoks = _tokens(rs, cfg, 3, 9)
    nxt, want_d, jnew = _reference_step(params, jcfg, dtoks, 16)
    ptoks = _tokens(rs, cfg, 2, 17)
    ppos = np.broadcast_to(np.arange(17)[None], (2, 17)).astype(np.int32)
    want_p, jaux = jax_tf.forward(params, jcfg, jnp.asarray(ptoks),
                                  jnp.asarray(ppos), 1, return_aux=True,
                                  last_only=True)
    slots = torch.tensor([1, 4, 2])
    cache, tables, lens = _port_prefilled(model, cfg, dtoks, slots, 5)
    got_p, aux, got_d, cache = tf.fused_pd_forward(
        model, torch.from_numpy(ptoks), torch.from_numpy(ppos),
        _t(nxt), lens[:, None], cache, tables, lens, slots,
        f_decode=0.25, impl=impl)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **LOGIT_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **LOGIT_TOL)
    _check_states(cache, slots, jnew, cfg)
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(aux[0][k].numpy(),
                                   np.asarray(jaux["pos0"][k][0]),
                                   **LOGIT_TOL)


# ---------------------------------------------------------------------------
# (e) serving
# ---------------------------------------------------------------------------


def test_serve_greedy_tokens_match_reference(models):
    """Every request's greedy tokens == the reference's own loop, whatever
    steps and decode slots the scheduler gave it."""
    model, params, cfg, jcfg = models
    reqs = serve_real.make_requests(cfg, 6, seed=3)
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=3, page=8, f_decode=0.5)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    assert result["pool_reclaimed"] and result["state_slots_reclaimed"]
    assert set(result["steps"]) == {"prefill", "decode", "fused"}
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    for r in result["requests"]:
        assert len(r.tokens) == r.max_new
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert r.tokens == want, r.rid
    s = serve_real.summarize(result)
    assert s["state_slots_reclaimed"] and s["pool_reclaimed"]
