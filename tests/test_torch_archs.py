"""Qwen2.5-14B, MiniCPM-2B, StarCoder2-3B and Qwen3-MoE-235B-A22B on the
port, against the reference.

The configs (full, reduced and Qwen3-MoE's one-card cut) must equal the
reference's field for field.  The whole-model cases run each reduced
config in float32 with the reference's weights converted
(``repro_torch.convert``, a strict load), plus two variants whose query
groups are past the 8 heads the decode tile held before: reduced
StarCoder2 with 12 heads over 1 kv head (G = 12) and reduced Qwen3-MoE
with 16 over 1 (G = 16); the reduced configs themselves have G = 1 or 2.
The reference initialises the qkv biases to zero, so the cases draw them
from a seed before converting, or a bias the port dropped would go
unseen.  ``forward``, ``decode_forward`` and ``fused_pd_forward`` are held
to atol = rtol = 1e-4 as in ``tests/test_torch_models.py``; greedy tokens
through ``serve_real`` and through ``RapidEngine`` + ``KernelExecutor``
must be identical to the reference's own greedy loop.  Last, the MoE
dispatch at Qwen3's 128 experts top-8, at narrow widths: each kept
(token, choice) pair's capacity slot and gate against the reference's
combine tensor, as ``tests/test_torch_moe.py`` holds Mixtral's.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_executor import HW
from test_torch_models import _identity_pools, _reference_prefilled
from test_torch_moe import _CombineRecorder, _check_dispatch
from test_torch_serve import _reference_greedy

from repro.config import get_config as jax_config
from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro_torch.config import (MoEConfig, get_config, get_one_card_config,
                                get_reduced_config, replace)
from repro_torch.convert import model_from_reference
from repro_torch.core.scheduler import kv_pool_blocks
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import serve_real
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf
from repro_torch.perfmodel.hw import H100

ARCHS = ["qwen2.5-14b", "minicpm-2b", "starcoder2-3b",
         "qwen3-moe-235b-a22b"]
# whole-model cases: (arch, changes to its reduced config)
VARIANTS = {
    **{arch: (arch, {}) for arch in ARCHS},
    "starcoder2-3b-g12": ("starcoder2-3b", dict(num_heads=12,
                                                num_kv_heads=1)),
    "qwen3-moe-g16": ("qwen3-moe-235b-a22b", dict(num_heads=16,
                                                  num_kv_heads=1)),
}
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
# (prompt length, new tokens): 8 and 16 end on page boundaries (page 8)
TRAFFIC = [(16, 9), (7, 6), (21, 8), (3, 1), (8, 7)]


def _fields_equal(mine, theirs):
    for f in dataclasses.fields(mine):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    for f in ("vocab_padded", "period", "num_periods"):
        assert getattr(mine, f) == getattr(theirs, f), f
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()
    assert mine.kv_bytes_per_token() == theirs.kv_bytes_per_token()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    """Every field (and every helper the perfmodel reads) of the full and
    the reduced config equals the reference's."""
    if reduced:
        _fields_equal(get_reduced_config(arch), jax_reduced_config(arch))
    else:
        _fields_equal(get_config(arch), jax_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_one_card_configs_keep_every_width(arch):
    """Three of the four fit one card whole.  Qwen3-MoE's cut changes the
    depth alone (94 -> 13 layers, 67.17 GB in bf16): every width of the
    reference's published config stays, and the ``H100`` spec's
    scheduler is left 20,726 blocks of 16 tokens."""
    full, cut = get_config(arch), get_one_card_config(arch)
    if arch != "qwen3-moe-235b-a22b":
        assert cut == full
        assert 2 * cut.param_count() < 0.95 * H100.hbm_bytes
        return
    assert cut == replace(full, num_layers=13)
    theirs = dataclasses.asdict(jax_config(arch))
    for name, value in dataclasses.asdict(cut).items():
        if name != "num_layers":
            assert value == theirs[name], name
    assert 2 * cut.param_count() / 1e9 == pytest.approx(67.17, abs=0.01)
    assert kv_pool_blocks(cut, H100, 1, 16) == 20726
    assert 2 * replace(full, num_layers=14).param_count() / 1e9 > 72


def _reference_params(jcfg, seed):
    """The reference's float32 parameters as numpy, the qkv biases drawn
    from ``seed`` (the reference initialises them to zero)."""
    params, _ = jax_tf.init_model(jax.random.PRNGKey(seed), jcfg)
    params = jax.tree.map(np.asarray, params)
    rs = np.random.RandomState(seed)
    mixer = params["layers"]["pos0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (0.5 * rs.standard_normal(mixer[name].shape)
                           ).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _models(variant):
    """(port model, reference params (numpy), port cfg, reference cfg)."""
    arch, kw = VARIANTS[variant]
    kw = dict(kw, dtype="float32")
    cfg = replace(get_reduced_config(arch), **kw)
    jcfg = jax_replace(jax_reduced_config(arch), **kw)
    params = _reference_params(jcfg, 21)
    return model_from_reference(params, cfg), params, cfg, jcfg


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_loads_every_leaf(arch):
    """The strict load takes every leaf of the reduced model: the qkv
    biases where the config has them, no LM head when the embeddings are
    tied, no gate in a non-GLU FFN, the stacked experts of an MoE FFN;
    each lands unchanged in its layer."""
    model, params, cfg, _ = _models(arch)
    names = set(model.state_dict())
    assert ("lm_head" in names) == (not cfg.tie_embeddings)
    assert ("layers.0.mixer.bq" in names) == cfg.qkv_bias
    assert ("layers.0.ffn.w_gate" in names) == cfg.ffn_glu
    assert ("layers.0.ffn.router" in names) == (cfg.moe is not None)
    stacked = params["layers"]["pos0"]
    for i, blk in enumerate(model.layers):
        for sub in ("mixer", "ffn"):
            for name, leaf in stacked[sub].items():
                np.testing.assert_array_equal(
                    getattr(getattr(blk, sub), name).numpy(), leaf[i])
    if cfg.qkv_bias:
        assert model.layers[1].mixer.bk.abs().sum() > 0
    np.testing.assert_array_equal(model.tok.numpy(), params["embed"]["tok"])
    if arch == "minicpm-2b":
        assert (cfg.vocab_size, cfg.vocab_padded) == (511, 512)


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def models(request):
    """(variant, port model, reference params, port cfg, reference cfg)."""
    return (request.param,) + _models(request.param)


def _tokens(rs, cfg, B, S):
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def test_forward_matches_reference(models):
    _, model, params, cfg, jcfg = models
    rs = np.random.RandomState(3)
    B, S = 2, 19
    toks = _tokens(rs, cfg, B, S)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, jaux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                jnp.asarray(pos), 1, impl="pallas",
                                return_aux=True)
    got, aux = tf.forward(model, torch.from_numpy(toks),
                          torch.from_numpy(pos), return_aux=True)
    assert got.shape == (B, S, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for i, a in enumerate(aux):
        np.testing.assert_allclose(a["k"].numpy(),
                                   np.asarray(jaux["pos0"]["k"][i]),
                                   **LOGIT_TOL)


def test_decode_forward_matches_reference(models):
    """Paged decode over identity block tables == the reference's
    slot-dense decode: logits and the written cache."""
    _, model, params, cfg, jcfg = models
    rs = np.random.RandomState(4)
    B, S, Sc, page = 2, 13, 32, 8
    logits, jcache = _reference_prefilled(params, jcfg,
                                          _tokens(rs, cfg, B, S), Sc)
    nxt = np.array(jax_tf.greedy_sample(logits[:, -1:], cfg.vocab_size))
    lens = np.array([S, S - 4], np.int32)
    want, jnew = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                       jnp.asarray(lens[:, None]), jcache,
                                       jnp.asarray(lens), 1, impl="pallas")
    pools, tables = _identity_pools(jcache, page)
    got, pools = tf.decode_forward(model, torch.tensor(nxt),
                                   torch.from_numpy(lens[:, None]), pools,
                                   tables, torch.from_numpy(lens),
                                   torch.arange(B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    new_pools, _ = _identity_pools(jnew, page)
    for mine, theirs in zip(pools, new_pools):
        np.testing.assert_allclose(mine["v"].numpy(), theirs["v"].numpy(),
                                   **LOGIT_TOL)


def test_fused_pd_forward_matches_reference(models):
    """One concurrent step (one unified_pd per layer) == the reference's
    forward at the last position + decode_forward on the same cache."""
    _, model, params, cfg, jcfg = models
    rs = np.random.RandomState(5)
    Bd, S, Sc, page = 3, 11, 24, 8
    logits, jcache = _reference_prefilled(params, jcfg,
                                          _tokens(rs, cfg, Bd, S), Sc)
    nxt = np.array(jax_tf.greedy_sample(logits[:, -1:], cfg.vocab_size))
    lens = np.array([S, S - 3, S - 10], np.int32)
    want_d, jnew = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                         jnp.asarray(lens[:, None]), jcache,
                                         jnp.asarray(lens), 1, impl="pallas")
    Bp, Sp = 1, 17
    ptoks = _tokens(rs, cfg, Bp, Sp)
    ppos = np.arange(Sp, dtype=np.int32)[None]
    want_p = jax_tf.forward(params, jcfg, jnp.asarray(ptoks),
                            jnp.asarray(ppos), 1, impl="pallas",
                            return_aux=True, last_only=True)[0]
    pools, tables = _identity_pools(jcache, page)
    got_p, _, got_d, pools = tf.fused_pd_forward(
        model, torch.from_numpy(ptoks), torch.from_numpy(ppos),
        torch.from_numpy(nxt), torch.from_numpy(lens[:, None]), pools,
        tables, torch.from_numpy(lens), torch.arange(Bd), f_decode=0.25)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               **LOGIT_TOL)
    new_pools, _ = _identity_pools(jnew, page)
    for mine, theirs in zip(pools, new_pools):
        np.testing.assert_allclose(mine["k"].numpy(), theirs["k"].numpy(),
                                   **LOGIT_TOL)


def _requests(cfg):
    rng = np.random.default_rng(8)
    return [serve_real.Request(
        rid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), new)
        for rid, (n, new) in enumerate(TRAFFIC)]


@functools.lru_cache(maxsize=None)
def _reference_tokens(variant):
    _, params, cfg, jcfg = _models(variant)
    reqs = _requests(cfg)
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    return {r.rid: _reference_greedy(params, jcfg, step, r.prompt,
                                     r.max_new, max_seq) for r in reqs}


@pytest.mark.parametrize("path", ["serve_real", "engine"])
def test_greedy_tokens_match_reference(models, path):
    """Every request's greedy tokens through ``serve_real`` (prefill,
    fused and replayed decode steps) and through ``RapidEngine`` +
    ``KernelExecutor`` == the reference's own greedy loop."""
    variant, model = models[:2]
    reqs = _requests(model.cfg)
    ops.reset_launches()
    if path == "serve_real":
        result = serve_real.serve(model, reqs, slots=3, page=8,
                                  f_decode=0.5)
        assert result["pool_reclaimed"] and result["state_slots_reclaimed"]
        assert set(result["steps"]) == {"prefill", "decode", "fused"}
        tokens = {r.rid: r.tokens for r in result["requests"]}
    else:
        result = serve_mod.serve_engine(model, reqs,
                                        serve_mod.serve_config(), hw=HW)
        s = serve_mod.summarize(result)
        assert s["tokens_met"] and s["pool_reclaimed"] and \
            s["state_rows_reclaimed"]
        assert s["preemptions"] == 0 and s["rejected"] == 0
        assert s["launches"].get("fused", 0) >= 1
        tokens = result["tokens"]
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    assert tokens == _reference_tokens(variant)


@pytest.mark.parametrize("entry", ["serve_real", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_entry_points_take_the_arch(arch, entry, capsys):
    """``--arch`` names each model in both entry points (reduced, on the
    CPU); each serves its requests and reclaims its pool."""
    main = serve_real.main if entry == "serve_real" else serve_mod.main
    assert main(["--arch", arch, "--device", "cpu", "--dtype", "float32",
                 "--requests", "3"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] == 3 and out["pool_reclaimed"]


# ---------------------------------------------------------------------------
# the MoE dispatch at Qwen3-MoE's 128 experts top-8
# ---------------------------------------------------------------------------

POLICIES = {"dropless": dict(dropless=True), "inference": dict(inference=True),
            "training": {}}


@pytest.fixture(scope="module")
def wide_moe():
    """(cfg, jcfg, port MoEFFN, reference params): reduced Qwen3-MoE at
    every expert count and top-k of the published config (128, 8), at
    d_model 32 and expert d_ff 16, expert weights at their fan-in as in
    ``tests/test_torch_moe.py``."""
    m = dict(num_experts=128, top_k=8, d_ff_expert=16)
    kw = dict(d_model=32, dtype="float32")
    cfg = replace(get_reduced_config("qwen3-moe-235b-a22b"),
                  moe=MoEConfig(**m), **kw)
    jcfg = jax_reduced_config("qwen3-moe-235b-a22b")
    jcfg = jax_replace(jcfg, moe=jax_replace(jcfg.moe, **m), **kw)
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(6), jnp.float32)
    jax_moe.init_moe(b, jcfg, 1)
    E = m["num_experts"]
    for name, fan_in in (("w_gate", 32), ("w_in", 32), ("w_out", 16)):
        b.params[name] = b.params[name] * (E / fan_in) ** 0.5
    p = moe.init_moe(layers.ParamInit(None, "cpu", torch.float32), cfg)
    for name, leaf in b.params.items():
        getattr(p, name).data.copy_(torch.tensor(np.asarray(leaf)))
    return cfg, jcfg, p, b.params


@pytest.mark.parametrize("policy", sorted(POLICIES))
@pytest.mark.parametrize("T", [512, 300, 48])
def test_top8_of_128_dispatch_matches_reference(wide_moe, monkeypatch, T,
                                                policy):
    """T = 512 (g 256, two groups), 300 (g 150) and 48 (one group of 48,
    dropless under the inference policy): the outputs, and each kept
    pair's capacity slot and gate, equal the reference's; the training
    policy's capacity (1.25 x 8/128 of a group) drops pairs."""
    cfg, jcfg, p, params = wide_moe
    kw = POLICIES[policy]
    x = np.random.RandomState(T).standard_normal(
        (1, T, cfg.d_model)).astype(np.float32)
    rec = _CombineRecorder()
    monkeypatch.setattr(jax_moe, "jnp", rec)
    want = np.asarray(jax_moe.moe_ffn(params, jcfg, jnp.asarray(x), **kw))
    monkeypatch.undo()
    xt = torch.from_numpy(x)
    got = moe.moe_ffn(p, cfg, xt, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    dropped = _check_dispatch(moe.route(p, cfg, xt, **kw), rec.combine,
                              128, 8)
    g, N, C = moe.moe_plan(T, cfg.moe, **kw)
    assert (g, N) == {512: (256, 2), 300: (150, 2), 48: (48, 1)}[T]
    if policy == "training" and T > 48:
        assert dropped > 0
    if policy == "dropless" or (policy == "inference" and g <= 64):
        assert dropped == 0
