"""The port's xLSTM mixers and the xlstm-125m model against the reference.

Reduced xlstm-125m (3 layers, mLSTM, mLSTM, sLSTM; d 64, 4 heads) in
float32.  The reference's parameters are built by its ``ParamBuilder`` and
copied into the port's modules (``convert.py`` for the whole model), and
every input is made from a seed with numpy.  The mixers are held to
atol = rtol = 1e-5: both sides compute the same float32 products, summed
in other orders (the port batches the four sLSTM recurrent products into
one einsum; the reference contracts three-operand einsums in its own
order).  The whole model's logits are held as the other models' are
(``test_torch_models.py``), to 1e-4 of the largest logit: the mLSTM's
normaliser divides by sums that cancel, which magnifies float32 rounding
in either implementation.  Against the same model run in float64, both
sides' logits are off by 3e-4 (reference) and 7e-4 (port) at a largest
logit of 60, which 1e-5 of it cannot hold.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_config
from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro.models import xlstm as jax_xlstm

from repro_torch.config import get_config, get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.core.executor import KernelExecutor
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm
from repro_torch.models.layers import ParamInit

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


ARCH = "xlstm-125m"
TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs():
    return (replace(get_reduced_config(ARCH), dtype="float32"),
            jax_replace(jax_reduced_config(ARCH), dtype="float32"))


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _mixer(kind, seed=1):
    """(port module, reference params) of one mixer with the same weights."""
    cfg, jcfg = _cfgs()
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(seed), jnp.float32)
    getattr(jax_xlstm, f"init_{kind}")(b, jcfg)
    mod = {"mlstm": xlstm.MLSTM, "slstm": xlstm.SLSTM}[kind](
        ParamInit(None, "cpu", torch.float32), cfg)
    mod.load_state_dict({k: _t(v) for k, v in b.params.items()}, strict=True)
    return mod, b.params, cfg, jcfg


def _scan_inputs(rs, B, L, H, Dh):
    q, k, v = (rs.standard_normal((B, L, H, Dh)).astype(np.float32)
               for _ in range(3))
    log_i = rs.standard_normal((B, L, H)).astype(np.float32)
    log_f = np.log(1 / (1 + np.exp(-rs.standard_normal((B, L, H))
                                   - 2))).astype(np.float32)
    return q, k, v, log_i, log_f


def test_config_matches_reference():
    for mine, theirs in ((get_config(ARCH), jax_config(ARCH)),
                         (get_reduced_config(ARCH), jax_reduced_config(ARCH))):
        for f in dataclasses.fields(mine):
            a, b = getattr(mine, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
        assert mine.param_count() == theirs.param_count()
        assert mine.state_bytes_per_seq() == theirs.state_bytes_per_seq()


@pytest.mark.parametrize("L,chunk,from_state", [
    (32, 8, False),        # L a multiple of the chunk
    (30, 8, False),        # not: chunks 8, 8, 8, 6 (the reference's: 6)
    (29, 8, True),         # prime L (the reference's chunk: 1), from a
                           # non-zero state
    (24, 16, True),        # chunk 12, from a non-zero state
])
def test_mlstm_chunk_scan(L, chunk, from_state):
    rs = np.random.RandomState(L)
    B, H, Dh = 2, 4, 8
    ins = _scan_inputs(rs, B, L, H, Dh)
    if from_state:
        state = {"C": rs.standard_normal((B, H, Dh, Dh)).astype(np.float32),
                 "n": rs.standard_normal((B, H, Dh)).astype(np.float32),
                 "m": rs.standard_normal((B, H)).astype(np.float32)}
    else:
        state = {"C": np.zeros((B, H, Dh, Dh), np.float32),
                 "n": np.zeros((B, H, Dh), np.float32),
                 "m": np.full((B, H), -1e30, np.float32)}
    h_ref, st_ref = jax_xlstm.mlstm_chunk_scan(
        *map(jnp.asarray, ins), {k: jnp.asarray(v) for k, v in state.items()},
        chunk=chunk)
    h, st = xlstm.mlstm_chunk_scan(*map(torch.from_numpy, ins),
                                   {k: torch.from_numpy(v)
                                    for k, v in state.items()}, chunk=chunk)
    np.testing.assert_allclose(h.numpy(), _np(h_ref), **TOL)
    for k in ("C", "n", "m"):
        np.testing.assert_allclose(st[k].numpy(), _np(st_ref[k]), **TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("L,from_state", [(40, False), (130, True)])
def test_mixer_forward(kind, L, from_state):
    """The whole mixer (projections, scan or token loop, output): at 130
    tokens the mLSTM runs chunks of 128 and 2 (the reference: two of 65)
    and the sLSTM loop chunks of 64, 64 and 2 (the reference: five of
    26)."""
    mod, params, cfg, jcfg = _mixer(kind)
    rs = np.random.RandomState(7)
    B = 2
    x = rs.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    jstate = state = None
    if from_state:
        init = getattr(jax_xlstm, f"{kind}_init_state")(jcfg, B)
        jstate = {k: jnp.asarray(rs.standard_normal(v.shape)
                                 .astype(np.float32)) for k, v in init.items()}
        state = {k: _t(v) for k, v in jstate.items()}
    out_ref, st_ref = getattr(jax_xlstm, f"{kind}_forward")(
        params, jcfg, jnp.asarray(x), state=jstate, return_state=True)
    with torch.no_grad():
        out, st = getattr(xlstm, f"{kind}_forward")(
            mod, cfg, torch.from_numpy(x), state=state)
    np.testing.assert_allclose(out.numpy(), _np(out_ref), **TOL)
    assert set(st) == set(st_ref)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), _np(st_ref[k]), **TOL)


@pytest.fixture(scope="module")
def models():
    cfg, jcfg = _cfgs()
    params, _ = jax_tf.init_model(jax.random.PRNGKey(0), jcfg)
    return model_from_reference(jax.tree.map(np.asarray, params), cfg), \
        params, cfg, jcfg


def test_forward_logits(models):
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(3)
    B, S = 2, 48
    toks = rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    want = jax_tf.forward(params, jcfg, jnp.asarray(toks), jnp.asarray(pos))
    got, aux = tf.forward(model, torch.from_numpy(toks),
                          torch.from_numpy(pos.copy()), return_aux=True)
    want = _np(want)
    assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    assert [set(a) for a in aux] == [{"C", "n", "m"}] * 2 + \
        [{"c", "n", "h", "m"}]


def test_serving_refuses_xlstm(models):
    """Since the decode steps and their state rows exist, only the online
    server refuses an xLSTM model (its requests' state rows, ROADMAP
    A11), before it allocates anything; the cache, the decode step and
    the executor take it (``test_torch_xlstm_serve.py`` holds them to the
    reference)."""
    model, _, cfg, _ = models
    with pytest.raises(NotImplementedError, match="mlstm, slstm"):
        serve_mod.check_online(cfg)
    cache = tf.init_cache(cfg, 8, 4, 2, device="cpu")
    assert [set(c) for c in cache] == [{"C", "n", "m"}] * 2 + \
        [{"c", "n", "h", "m"}]
    KernelExecutor(model, prompts={}, serve=None, device="cpu")


def test_slstm_chunk_backward_gradcheck():
    """The sLSTM chunk's hand-written backward against finite differences,
    in float64, over 5 tokens from a non-zero state (H 2, B 3, Dh 4);
    ``fast_mode`` checks the Jacobian along random directions."""
    g = torch.Generator().manual_seed(0)
    H, B, Dh, T = 2, 3, 4, 5
    r = lambda *s, scale=1.0: (torch.randn(*s, generator=g, dtype=torch.float64)
                               * scale).requires_grad_()
    c, h, m = r(H, B, Dh), r(H, B, Dh), r(H, B, Dh)
    n = (torch.rand(H, B, Dh, generator=g, dtype=torch.float64) * 3)
    n.requires_grad_()
    args = (c, n, h, m, r(T, H, B, 4 * Dh), r(H, Dh, 4 * Dh, scale=0.5))
    assert torch.autograd.gradcheck(xlstm._SLSTMChunk.apply, args,
                                    fast_mode=True)


@pytest.mark.parametrize("from_state", [False, True])
def test_slstm_grads_match_reference(from_state):
    """Gradients of the sLSTM mixer (input, weights, biases, recurrent
    weights, and the state it starts from) for one random cotangent, over
    130 tokens (five chunks of 26), against ``jax.vjp`` of the
    reference's: each within 1e-5 of the largest."""
    mod, params, cfg, jcfg = _mixer("slstm")
    mod.requires_grad_()
    rs = np.random.RandomState(11)
    B, L = 2, 130
    x = rs.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    ct = rs.standard_normal((B, L, cfg.d_model)).astype(np.float32)
    init = jax_xlstm.slstm_init_state(jcfg, B)
    st = {k: (rs.standard_normal(v.shape).astype(np.float32) if from_state
              else np.array(v)) for k, v in init.items()}

    def ref(p, x, st):
        return jax_xlstm.slstm_forward(p, jcfg, x, state=st)

    _, vjp = jax.vjp(ref, params, jnp.asarray(x),
                     {k: jnp.asarray(v) for k, v in st.items()})
    g_p, g_x, g_st = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    tst = {k: torch.from_numpy(v).requires_grad_() for k, v in st.items()}
    out, _ = xlstm.slstm_forward(mod, cfg, xt, state=tst)
    names, ps = zip(*mod.named_parameters())
    grads = torch.autograd.grad(out, (xt, *tst.values(), *ps),
                                torch.from_numpy(ct), allow_unused=True)
    want = {"x": g_x, **{f"state.{k}": g_st[k] for k in tst},
            **{n: g_p[n] for n in names}}
    got = dict(zip(["x", *(f"state.{k}" for k in tst), *names], grads))
    top = max(np.abs(_np(w)).max() for w in want.values())
    for k, w in want.items():
        gk = np.zeros_like(_np(w)) if got[k] is None else got[k].numpy()
        assert np.abs(gk - _np(w)).max() <= 1e-5 * top, k
