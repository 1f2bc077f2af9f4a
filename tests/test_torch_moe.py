"""The port's MoE FFN against the reference's, drops included.

Reduced Mixtral-8x7B (d 128, 4 experts top-2, expert d_ff 128) in
float32; the reference's weights are copied into the port's module, and
the inputs are made from a seed with numpy.  Outputs are held to
atol = rtol = 1e-5: both sides compute the same products in float32,
summed in other orders.  The reference draws expert weights at
1/sqrt(E) (its ``ParamBuilder`` takes shape[0] as the fan-in); the
fixture rescales them to their fan-in, 1/sqrt(d) and 1/sqrt(f), as the
port draws them, so that outputs are O(1): at the reference's scale they
are O(100), and the order of float32 sums alone moves outputs near zero
by 1e-4.  Besides the outputs, every case holds the
port's dispatch to the reference's own: the reference's combine tensor
(N, g, E, C), read as it is computed, is nonzero exactly at the capacity
slots where the port puts each kept (token, choice) pair, with the same
gate.  The token counts give the groups g = 2, 1, 256 and 196.
"""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from test_torch_serve import _reference_greedy

from repro_torch.config import get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.kernels import ops
from repro_torch.launch import serve_real
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf

ARCH = "mixtral-8x7b"
TOL = dict(atol=1e-5, rtol=1e-5)
POLICIES = {"dropless": dict(dropless=True), "inference": dict(inference=True),
            "training": {}}
GROUPS = {1762: 2, 997: 1, 512: 256, 1372: 196}     # T -> g


def _cfgs():
    return (replace(get_reduced_config(ARCH), dtype="float32"),
            jax_replace(jax_reduced_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def weights():
    """(port MoEFFN, reference params) with the same float32 weights."""
    cfg, jcfg = _cfgs()
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(3), jnp.float32)
    jax_moe.init_moe(b, jcfg, 1)
    E, f = jcfg.moe.num_experts, jcfg.moe.d_ff_expert
    for name, fan_in in (("w_gate", jcfg.d_model), ("w_in", jcfg.d_model),
                         ("w_out", f)):
        b.params[name] = b.params[name] * (E / fan_in) ** 0.5
    p = moe.init_moe(layers.ParamInit(None, "cpu", torch.float32), cfg)
    for name, leaf in b.params.items():
        getattr(p, name).data.copy_(torch.tensor(np.asarray(leaf)))
    return p, b.params


class _CombineRecorder(types.SimpleNamespace):
    """``jax.numpy`` for the reference's moe module, recording the combine
    tensor its dispatch einsum computes."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *args, **kw):
        out = jnp.einsum(spec, *args, **kw)
        if spec == "ngk,ngke,ngkec->ngec":
            self.combine = np.asarray(out)
        return out


def _both(weights, x, monkeypatch, **policy):
    """(port y, reference y, port (gates, rows, (g, N, C)), reference
    combine) for x (B, S, d)."""
    p, params = weights
    cfg, jcfg = _cfgs()
    rec = _CombineRecorder()
    monkeypatch.setattr(jax_moe, "jnp", rec)
    want = np.asarray(jax_moe.moe_ffn(params, jcfg, jnp.asarray(x), **policy))
    monkeypatch.undo()
    xt = torch.from_numpy(x)
    got = moe.moe_ffn(p, cfg, xt, **policy).numpy()
    return got, want, moe.route(p, cfg, xt, **policy), rec.combine


def _check_dispatch(route, combine, E, k):
    """The port's kept pairs, their capacity slots and gates == the
    nonzeros of the reference's combine (N, g, E, C).  Returns the number
    of dropped pairs."""
    gates, rows, (g, N, C) = route
    assert combine.shape == (N, g, E, C)
    T = N * g
    mine = np.zeros((N, g, E, C), np.float32)
    r = rows.numpy()
    kept = r < E * N * C
    t, j = np.nonzero(kept)
    e, rest = np.divmod(r[t, j], N * C)
    n, c = np.divmod(rest, C)
    assert (n == t // g).all()
    mine[n, t % g, e, c] = gates.numpy()[t, j]
    assert ((mine != 0) == (combine != 0)).all()
    np.testing.assert_allclose(mine, combine, **TOL)
    return T * k - int(kept.sum())


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("T", sorted(GROUPS))
def test_moe_ffn_matches_reference(weights, monkeypatch, T, policy):
    cfg, _ = _cfgs()
    m = cfg.moe
    kw = POLICIES[policy]
    assert moe.moe_plan(T, m, **kw)[0] == GROUPS[T]
    x = np.random.RandomState(T).standard_normal(
        (1, T, cfg.d_model)).astype(np.float32)
    got, want, route, combine = _both(weights, x, monkeypatch, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    _check_dispatch(route, combine, m.num_experts, m.top_k)


@pytest.mark.parametrize("policy", ["training", "inference"])
def test_skewed_router_drops_the_same_pairs(weights, monkeypatch, policy):
    """Inputs that share a direction which the router's expert 0 favours:
    nearly every token's first choice is expert 0, past its capacity
    under the training policy.  The reference's own dispatch drops pairs
    there (none under the inference policy, whose capacity is the group
    at 4 experts), and the port drops the same ones."""
    cfg, _ = _cfgs()
    p, params = weights
    skewed = dict(params, router=params["router"].at[:, 0].add(0.05))
    port = moe.init_moe(layers.ParamInit(None, "cpu", torch.float32), cfg)
    port.load_state_dict(p.state_dict())
    port.router.data[:, 0] += 0.05
    rs = np.random.RandomState(9)
    x = (rs.standard_normal((2, 256, cfg.d_model)) + 1.0).astype(np.float32)
    kw = POLICIES[policy]
    got, want, route, combine = _both((port, skewed), x, monkeypatch, **kw)
    np.testing.assert_allclose(got, want, **TOL)
    dropped = _check_dispatch(route, combine, cfg.moe.num_experts,
                              cfg.moe.top_k)
    ref_kept = int((combine != 0).sum())
    assert dropped == x.shape[0] * x.shape[1] * cfg.moe.top_k - ref_kept
    if policy == "training":
        assert dropped > 0
    else:
        assert dropped == 0


def test_moe_plan_policies():
    cfg, _ = _cfgs()
    m = cfg.moe                               # 4 experts, top-2, cf 1.25
    assert moe.moe_plan(512, m) == (256, 2, 160)
    assert moe.moe_plan(512, m, inference=True) == (256, 2, 256)
    assert moe.moe_plan(512, m, dropless=True) == (256, 2, 256)
    assert moe.moe_plan(96, m, inference=True) == (96, 1, 96)
    assert moe.moe_plan(1762, m, inference=True) == (2, 881, 2)  # g <= 64
    assert moe.moe_plan(1762, m) == (2, 881, 2)
    assert moe.moe_plan(6000, replace(cfg, moe=replace(
        m, num_experts=8)).moe, inference=True) == (250, 24, 125)


def test_convert_round_trips_the_moe_leaves():
    """Reference MoE leaves, stacked over periods, land unchanged in each
    layer's MoEFFN under the same names and shapes."""
    cfg, jcfg = _cfgs()
    params, _ = jax_tf.init_model(jax.random.PRNGKey(4), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    stacked = params["layers"]["pos0"]["ffn"]
    assert sorted(stacked) == ["router", "w_gate", "w_in", "w_out"]
    for i, blk in enumerate(model.layers):
        assert isinstance(blk.ffn, moe.MoEFFN)
        for name, leaf in stacked.items():
            np.testing.assert_array_equal(getattr(blk.ffn, name).numpy(),
                                          np.asarray(leaf[i]))
    assert model.layers[0].ffn.w_gate.shape == (
        cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    assert model.layers[0].ffn.w_out.shape == (
        cfg.moe.num_experts, cfg.moe.d_ff_expert, cfg.d_model)


# ---------------------------------------------------------------------------
# the published Jamba config, with its experts (reduced: 4 experts top-2
# on the odd layers of one 8-layer period), in float32
# ---------------------------------------------------------------------------

JAMBA = "jamba-1.5-large-398b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jamba():
    """(port model, reference params, reference cfg).  The reference runs
    its plain paths (``impl="ref"``): its Pallas scan does not run under
    the installed JAX."""
    jcfg = jax_replace(jax_reduced_config(JAMBA), dtype="float32")
    cfg = replace(get_reduced_config(JAMBA), dtype="float32")
    assert [cfg.ffn_at(i) for i in range(cfg.num_layers)] == \
        ["dense", "moe"] * 4
    params, _ = jax_tf.init_model(jax.random.PRNGKey(5), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    return model, params, jcfg


@pytest.mark.parametrize("return_aux", [True, False])
def test_jamba_with_experts_forward_matches_reference(jamba, return_aux):
    """The serving prefill (``return_aux``: the inference capacity policy)
    and the training forward (capacity factor 1.25) == the reference's."""
    model, params, jcfg = jamba
    rs = np.random.RandomState(6)
    B, S = 2, 37
    toks = rs.randint(0, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want = jax_tf.forward(params, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          1, impl="ref", return_aux=return_aux)
    got = tf.forward(model, torch.from_numpy(toks), torch.from_numpy(pos),
                     return_aux=return_aux)
    if return_aux:
        (want, jaux), (got, aux) = want, got
        np.testing.assert_allclose(aux[7]["ssm"].numpy(),
                                   np.asarray(jaux["pos7"]["ssm"][0]),
                                   **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_jamba_with_experts_serves_the_reference_tokens(jamba):
    """serve_real's prefill, fused and decode steps on reduced Jamba with
    its MoE layers: every request's greedy tokens == the reference's own
    loop (prefill, then dropless decodes)."""
    model, params, jcfg = jamba
    reqs = serve_real.make_requests(model.cfg, 5, seed=6)
    ops.reset_launches()
    result = serve_real.serve(model, reqs, slots=3, page=8, f_decode=0.5)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    assert result["pool_reclaimed"] and result["state_slots_reclaimed"]
    assert set(result["steps"]) == {"prefill", "decode", "fused"}
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    for r in result["requests"]:
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert r.tokens == want, r.rid
