"""xLSTM serving on the port against the reference: the decode steps, the
decode and fused paths over state rows, and greedy tokens through both
entry points.

Reduced xlstm-125m (3 layers: mLSTM, mLSTM, sLSTM; d 64, 4 heads) in
float32 with the reference's weights converted.  The decode steps
(``mlstm_decode_step``, ``slstm_decode_step``) are held to the
reference's over several consecutive steps from a random non-zero state
within atol = rtol = 3e-5.  The whole model's logits are held to 1e-4 of
the largest logit, as ``test_torch_xlstm.py`` holds its forward:
the mLSTM's normaliser divides by sums that cancel, which magnifies
float32 rounding on either side.  Greedy tokens through ``serve_real``
and through ``RapidEngine`` + ``KernelExecutor`` (with an eviction and
its re-prefill from a zero state over prompt and generated tokens) must
equal the reference's own greedy loop.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_serve import _reference_greedy

from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models import xlstm as jax_xlstm
from repro_torch.config import get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.core.engines import RapidEngine, drive
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import serve_real
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm
from repro_torch.models.layers import ParamInit
from repro_torch.perfmodel.hw import H100

ARCH = "xlstm-125m"
TOL = dict(atol=3e-5, rtol=3e-5)
LOGIT_REL = 1e-4
HW = dataclasses.replace(H100, hbm_bytes=serve_mod.CPU_HBM_BYTES)
# (prompt length, new tokens)
TRAFFIC = [(16, 12), (9, 6), (21, 9), (3, 1), (12, 7)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops run fastest on one intra-op thread beside other test
    workers; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _cfgs():
    return (replace(get_reduced_config(ARCH), dtype="float32"),
            jax_replace(jax_reduced_config(ARCH), dtype="float32"))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_decode_steps_match_reference(kind):
    """Six consecutive steps of one mixer from a random state: each
    step's output and state against the reference's."""
    cfg, jcfg = _cfgs()
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(2), jnp.float32)
    getattr(jax_xlstm, f"init_{kind}")(b, jcfg)
    mod = {"mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}[kind](
        ParamInit(None, "cpu", torch.float32), cfg)
    mod.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                         for k, v in b.params.items()}, strict=True)
    rs = np.random.RandomState(9)
    B = 3
    init = getattr(jax_xlstm, f"{kind}_init_state")(jcfg, B)
    jst = {k: jnp.asarray(rs.standard_normal(v.shape).astype(np.float32))
           for k, v in init.items()}
    st = {k: torch.from_numpy(np.array(v)) for k, v in jst.items()}
    step_ref = getattr(jax_xlstm, f"{kind}_decode_step")
    step = getattr(xlstm, f"{kind}_decode_step")
    for _ in range(6):
        x = rs.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        want, jst = step_ref(b.params, jcfg, jnp.asarray(x), jst)
        got, st = step(mod, cfg, torch.from_numpy(x), st)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        assert set(st) == set(jst)
        for k in st:
            np.testing.assert_allclose(st[k].numpy(), _np(jst[k]), **TOL)


@pytest.fixture(scope="module")
def models():
    return _models()


def _close(got, want):
    want = _np(want)
    assert np.abs(got.numpy() - want).max() <= LOGIT_REL * np.abs(want).max()


def _toks(rs, cfg, B, S):
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _prefilled(model, params, jcfg, toks, Sc):
    """The prompts prefilled on both sides: the reference's contiguous
    cache, and the port's state rows 0..B-1 (no attention layer, so no
    pool)."""
    B, S = toks.shape
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    _, aux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                            jnp.asarray(pos), 1, return_aux=True)
    jcache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, B, Sc, 1), aux, S)
    cache = tf.init_cache(model.cfg, 1, 8, B, device="cpu")
    _, paux = tf.forward(model, torch.from_numpy(toks),
                         torch.from_numpy(pos.copy()), return_aux=True)
    tf.write_prefill_to_cache(cache, paux,
                              torch.zeros(B, 1, dtype=torch.int32),
                              torch.arange(B))
    return jcache, cache


def test_cache_holds_state_rows(models):
    """Per-slot rows for every mixer, float32, the mLSTM's stabiliser at
    the reference's initial -1e30."""
    model, _, cfg, jcfg = models
    cache = tf.init_cache(cfg, 1, 8, 5, device="cpu")
    ref = jax_tf.init_cache(jcfg, 5, 8, 1)
    for i, c in enumerate(cache):
        want = ref[f"pos{i % cfg.period}"]
        assert set(c) == set(want)
        for k, t in c.items():
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), _np(want[k][i // 3]))


def test_decode_forward_matches_reference(models):
    """Eight decode steps after a prefill of two prompts, from their state
    rows (rows 2 and 0 of three, so the gather and the scatter matter)."""
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(4)
    B, S = 2, 20
    jcache, cache = _prefilled(model, params, jcfg, _toks(rs, cfg, B, S), 32)
    # move the rows: sequence 0 to row 2, sequence 1 to row 0
    rows = torch.tensor([2, 0])
    big = tf.init_cache(cfg, 1, 8, 3, device="cpu")
    for c, small in zip(big, cache):
        for k in c:
            c[k][rows] = small[k]
    lens = np.full(B, S, np.int32)
    tables = torch.zeros(B, 1, dtype=torch.int32)
    for _ in range(8):
        tok = _toks(rs, cfg, B, 1)
        want, jcache = jax_tf.decode_forward(
            params, jcfg, jnp.asarray(tok), jnp.asarray(lens[:, None]),
            jcache, jnp.asarray(lens), 1)
        got, big = tf.decode_forward(model, torch.from_numpy(tok),
                                     torch.from_numpy(lens[:, None]), big,
                                     tables, torch.from_numpy(lens), rows)
        _close(got, want)
        lens = lens + 1
    # the row no sequence holds is untouched
    for c in big:
        for k, t in c.items():
            assert torch.all(t[1] == (-1e30 if k == "m" else 0.0)), k


def test_fused_pd_forward_matches_reference(models):
    """One concurrent step: a prompt scanned from a zero state and three
    decodes stepped from their rows == the reference's forward at the
    last position + decode_forward; the prefill's final state is
    ``forward``'s."""
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(5)
    Bd, S = 3, 14
    jcache, cache = _prefilled(model, params, jcfg,
                               _toks(rs, cfg, Bd, S), 24)
    lens = np.full(Bd, S, np.int32)
    tok = _toks(rs, cfg, Bd, 1)
    want_d, _ = jax_tf.decode_forward(params, jcfg, jnp.asarray(tok),
                                      jnp.asarray(lens[:, None]), jcache,
                                      jnp.asarray(lens), 1)
    Sp = 17
    ptoks = _toks(rs, cfg, 1, Sp)
    ppos = np.arange(Sp, dtype=np.int32)[None]
    want_p, jaux = jax_tf.forward(params, jcfg, jnp.asarray(ptoks),
                                  jnp.asarray(ppos), 1, return_aux=True,
                                  last_only=True)
    got_p, aux, got_d, cache = tf.fused_pd_forward(
        model, torch.from_numpy(ptoks), torch.from_numpy(ppos),
        torch.from_numpy(tok), torch.from_numpy(lens[:, None]), cache,
        torch.zeros(Bd, 1, dtype=torch.int32), torch.from_numpy(lens),
        torch.arange(Bd), f_decode=0.5)
    _close(got_p, want_p)
    _close(got_d, want_d)
    for i, a in enumerate(aux):
        want = jaux[f"pos{i % cfg.period}"]
        for k in a:
            np.testing.assert_allclose(a[k].numpy(), _np(want[k][i // 3]),
                                       atol=1e-4, rtol=1e-4)


def _requests(cfg, traffic=TRAFFIC, seed=5):
    rng = np.random.default_rng(seed)
    return [serve_real.Request(
        rid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), new)
        for rid, (n, new) in enumerate(traffic)]


@functools.lru_cache(maxsize=None)
def _reference_tokens(traffic):
    model, params, cfg, jcfg = _models()
    reqs = _requests(cfg, traffic)
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    return {r.rid: _reference_greedy(params, jcfg, step, r.prompt,
                                     r.max_new, max_seq) for r in reqs}


@functools.lru_cache(maxsize=None)
def _models():
    cfg, jcfg = _cfgs()
    params, _ = jax_tf.init_model(jax.random.PRNGKey(0), jcfg)
    params = jax.tree.map(np.asarray, params)
    return model_from_reference(params, cfg), params, cfg, jcfg


def test_serve_real_tokens_match_reference():
    model, _, cfg, _ = _models()
    ops.reset_launches()
    result = serve_real.serve(model, _requests(cfg), slots=3, page=8)
    assert ops.launches() == {k: 0 for k in ops.launches()}
    assert result["pool_reclaimed"] and result["state_slots_reclaimed"]
    assert set(result["steps"]) == {"prefill", "decode", "fused"}
    assert {r.rid: r.tokens for r in result["requests"]} == \
        _reference_tokens(tuple(TRAFFIC))


def test_engine_tokens_match_reference_through_an_eviction():
    """``RapidEngine`` + ``KernelExecutor``: request 0 is evicted after
    its fourth token (as the gateway pauses a slow stream) and submitted
    again 50 ms later; it is prefilled again from a zero state over its
    prompt and the tokens it had, and every request's tokens equal the
    reference's.  Each request's state row comes back."""
    model, _, cfg, _ = _models()
    reqs = _requests(cfg)
    serve = serve_mod.serve_config()
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in reqs},
                        serve=serve, device="cpu", hw=HW,
                        state_rows=len(reqs))
    eng = RapidEngine(cfg, serve, HW, executor=ex)
    ex.bind(eng)
    core = [Request(r.rid, 0.0, len(r.prompt), r.max_new) for r in reqs]
    evicted = []

    def pause(r):
        assert eng.evict_request(r)
        evicted.append(r.tokens_generated)
        eng.loop.after(0.05, lambda: eng.submit(r))

    def on(ev):
        if type(ev).__name__ == "TokenEvent" and ev.rid == 0 and \
                ev.index == 3 and not evicted:
            eng.loop.after(0.0, lambda: pause(core[0]))

    eng.subscribe(on)
    ops.reset_launches()
    drive(eng, core)
    assert ops.launches() == {k: 0 for k in ops.launches()}
    assert evicted == [4] and core[0].preemptions == 1
    resumed = [e for e in ex.log if e["resumed"]]
    assert [(e["rids"], e["resumed"], e["prefill_tokens"]) for e in resumed] \
        == [([0], 4, 16 + 4)]
    assert {r.rid: len(ex.tokens[r.rid]) for r in reqs} == \
        {r.rid: r.max_new for r in reqs}
    assert {rid: ex.tokens[rid] for rid in ex.tokens} == \
        _reference_tokens(tuple(TRAFFIC))
    kinds = {e["kind"] for e in ex.log}
    assert {"prefill", "decode", "fused"} <= kinds
    assert ex.rows_free == ex.state_rows == len(reqs)
    assert eng.kv.allocator.free_count == eng.kv.allocator.num_blocks


def test_serve_main_takes_xlstm(capsys):
    """``--arch xlstm-125m`` in both entry points (reduced, on the CPU)."""
    for main in (serve_real.main, serve_mod.main):
        assert main(["--arch", ARCH, "--device", "cpu", "--dtype", "float32",
                     "--requests", "3"]) == 0
        assert '"pool_reclaimed": true' in capsys.readouterr().out


def test_online_server_refuses_xlstm():
    """The online server refuses it at start-up, before it loads the
    model, as it refuses Mamba: each request would hold a state row from
    its prefill on, which no admission bounds (ROADMAP A11)."""
    cfg = _cfgs()[0]
    with pytest.raises(NotImplementedError, match="mlstm, slstm"):
        serve_mod.check_online(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        serve_mod.make_gateway(_models()[0], serve_mod.serve_config(), {},
                               clock=None)
    with pytest.raises(SystemExit):
        serve_mod.main(["--device", "cpu", "--serve", "http", "--arch",
                        ARCH])
