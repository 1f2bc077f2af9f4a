"""The port's model layers and transformer against the reference.

Reduced granite-8b (and reduced LLaMA-3.1-70B for ``forward`` and
``decode_forward``) in float32; the reference's weights are converted
(``repro_torch.convert``) so both sides compute with the same numbers.
The reference runs with ``impl="pallas"`` (interpret mode on the CPU);
the port's kernel wrappers compute their plain versions on CPU tensors.
Logits are held to atol = rtol = 1e-4: XLA and PyTorch sum the matrix
products in different orders.
"""
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
from repro_torch.config import get_config, get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.kvcache import KVCacheManager, OutOfBlocks, kv_pages_for
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
F32_TOL = dict(atol=1e-5, rtol=1e-5)


def _cfgs(arch="granite-8b"):
    return (replace(get_reduced_config(arch), dtype="float32"),
            jax_replace(jax_reduced_config(arch), dtype="float32"))


def _converted(arch):
    """(port model, reference params, port cfg, reference cfg)."""
    cfg, jcfg = _cfgs(arch)
    params, _ = jax_tf.init_model(jax.random.PRNGKey(0), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    return model, params, cfg, jcfg


@pytest.fixture(scope="module")
def models():
    return _converted("granite-8b")


@pytest.fixture(scope="module")
def llama_models():
    return _converted("llama3-70b")


def _tokens(rs, cfg, B, S):
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _identity_pools(jcache, page):
    """Reference slot-dense cache (P,B,Sc,Hkv,D) -> port pools viewed
    through identity block tables (sequence b owns pages b*np..)."""
    k = np.asarray(jcache["pos0"]["k"])
    P, B, Sc, Hkv, D = k.shape
    pools = []
    for p in range(P):
        pools.append({name: torch.from_numpy(np.array(
            jcache["pos0"][name][p])).reshape(B * Sc // page, page, Hkv, D)
            for name in ("k", "v")})
    n_pages = Sc // page
    tables = (torch.arange(B)[:, None] * n_pages +
              torch.arange(n_pages)[None]).int()
    return pools, tables


def test_config_matches_reference():
    full, reduced = get_config("granite-8b"), get_reduced_config("granite-8b")
    from repro.config import get_config as jax_config
    for mine, theirs in ((full, jax_config("granite-8b")),
                         (reduced, jax_reduced_config("granite-8b"))):
        for f in ("num_layers", "d_model", "num_heads", "num_kv_heads",
                  "d_ff", "vocab_size", "head_dim", "tie_embeddings",
                  "dtype", "act", "ffn_glu", "rope_theta", "norm_eps"):
            assert getattr(mine, f) == getattr(theirs, f), f
        assert mine.vocab_padded == theirs.vocab_padded
        assert (mine.period, mine.num_periods) == \
            (theirs.period, theirs.num_periods)
        assert mine.kv_heads_padded(1) == theirs.kv_heads_padded(1)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
@pytest.mark.parametrize("reduced", [False, True])
def test_mixtral_configs_match_reference(arch, reduced):
    """Every field of the port's Mixtral configs (MoE sub-config and
    window included) equals the reference's, and so do the helpers the
    perfmodel reads."""
    import dataclasses
    from repro.config import get_config as jax_config
    mine = get_reduced_config(arch) if reduced else get_config(arch)
    theirs = jax_reduced_config(arch) if reduced else jax_config(arch)
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


def test_one_card_cuts_keep_every_width():
    """The one-card cuts change depth (and Jamba's FFN kind) only; the
    LLaMA cut leaves the ``H100`` spec's scheduler a pool of 2,717 blocks
    of 16 tokens."""
    from repro_torch.config import get_one_card_config
    from repro_torch.core.scheduler import kv_pool_blocks
    from repro_torch.perfmodel.hw import H100
    llama = get_one_card_config("llama3-70b")
    assert llama == replace(get_config("llama3-70b"), num_layers=38)
    assert 2 * llama.param_count() / 1e9 == pytest.approx(69.23, abs=0.01)
    assert kv_pool_blocks(llama, H100, 1, 16) == 2717
    mix = get_one_card_config("mixtral-8x7b")
    assert mix == replace(get_config("mixtral-8x7b"), num_layers=24)
    assert 2 * mix.param_count() / 1e9 == pytest.approx(70.19, abs=0.01)
    jamba = get_one_card_config("jamba-1.5-large-398b")
    assert jamba == replace(get_config("jamba-1.5-large-398b"),
                            num_layers=8, ffn_pattern=("dense",))
    assert get_one_card_config("granite-8b") == get_config("granite-8b")


def test_rmsnorm_rope_gelu_match_reference():
    rs = np.random.RandomState(0)
    x = rs.standard_normal((2, 5, 3, 32)).astype(np.float32) * 3
    w = rs.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        **F32_TOL)
    # bf16: normalised in f32, cast, then scaled — rounding at one place
    xb = torch.from_numpy(x).bfloat16()
    got = layers.rmsnorm(xb, torch.from_numpy(w).bfloat16())
    want = jax_layers.rmsnorm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(w, jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2,
                               rtol=3e-2)

    pos = rs.randint(0, 4000, size=(2, 5))
    cos, sin = layers.rope_cos_sin(torch.from_numpy(pos), 32, 10_000.0)
    jcos, jsin = jax_layers.rope_cos_sin(jnp.asarray(pos), 32, 10_000.0)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-4)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-4)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.tensor(np.asarray(jcos)),
                          torch.tensor(np.asarray(jsin))).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jcos, jsin)),
        **F32_TOL)

    for name in ("gelu", "silu", "relu"):
        np.testing.assert_allclose(
            layers.act_fn(name)(torch.from_numpy(x)).numpy(),
            np.asarray(jax_layers.act_fn(name)(jnp.asarray(x))), **F32_TOL)


@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "gelu")])
def test_dense_ffn_matches_reference(glu, act):
    cfg, jcfg = _cfgs()
    cfg, jcfg = (replace(cfg, ffn_glu=glu, act=act),
                 jax_replace(jcfg, ffn_glu=glu, act=act))
    b = jax_layers.ParamBuilder(jax.random.PRNGKey(1), jnp.float32)
    jax_moe.init_dense_ffn(b, jcfg)
    p = moe.init_dense_ffn(layers.ParamInit(None, "cpu", torch.float32),
                           cfg)
    for name, leaf in b.params.items():
        getattr(p, name).data.copy_(torch.tensor(np.asarray(leaf)))
    x = np.random.RandomState(2).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(
        moe.dense_ffn(p, cfg, torch.from_numpy(x)).numpy(),
        np.asarray(jax_moe.dense_ffn(b.params, jcfg, jnp.asarray(x))),
        **LOGIT_TOL)


def test_forward_matches_reference(models):
    _check_forward(models)


def _check_forward(models):
    model, params, cfg, jcfg = models
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
    for i, a in enumerate(aux):        # period 1: layer i = period slice i
        np.testing.assert_allclose(a["k"].numpy(),
                                   np.asarray(jaux["pos0"]["k"][i]),
                                   **LOGIT_TOL)
    last = tf.forward(model, torch.from_numpy(toks), torch.from_numpy(pos),
                      last_only=True)
    np.testing.assert_allclose(last.numpy(), got[:, -1:].numpy(), **F32_TOL)


def _reference_prefilled(params, jcfg, toks, Sc):
    B, S = toks.shape
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    logits, aux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                 jnp.asarray(pos), 1, impl="pallas",
                                 return_aux=True)
    cache = jax_tf.init_cache(jcfg, B, Sc, 1)
    return logits, jax_tf.write_prefill_to_cache(jcfg, cache, aux, S)


def test_decode_forward_matches_reference(models):
    """Paged decode over identity block tables == the reference's
    slot-dense decode: logits and the written cache."""
    _check_decode_forward(models)


@pytest.mark.parametrize("check", ["forward", "decode_forward"])
def test_llama_matches_reference(llama_models, check):
    """Reduced LLaMA-3.1-70B (G = 2, untied LM head): the granite cases'
    ``forward`` and ``decode_forward`` checks."""
    {"forward": _check_forward,
     "decode_forward": _check_decode_forward}[check](llama_models)


def _check_decode_forward(models):
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(4)
    B, S, Sc, page = 2, 13, 32, 8
    logits, jcache = _reference_prefilled(params, jcfg,
                                          _tokens(rs, cfg, B, S), Sc)
    nxt = np.asarray(jax_tf.greedy_sample(logits[:, -1:], cfg.vocab_size))
    lens = np.array([S, S - 4], np.int32)   # ragged: slot 1 is shorter
    dpos = lens[:, None]
    want, jnew = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                       jnp.asarray(dpos), jcache,
                                       jnp.asarray(lens), 1, impl="pallas")
    pools, tables = _identity_pools(jcache, page)
    got, pools = tf.decode_forward(model, torch.tensor(nxt),
                                   torch.from_numpy(dpos), pools, tables,
                                   torch.from_numpy(lens), torch.arange(B))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    new_pools, _ = _identity_pools(jnew, page)
    for mine, theirs in zip(pools, new_pools):
        np.testing.assert_allclose(mine["k"].numpy(), theirs["k"].numpy(),
                                   **LOGIT_TOL)


@pytest.fixture(scope="module")
def fused_case(models):
    """Inputs of one concurrent step and the reference's products for
    them: forward (last position) + decode_forward on a prefilled cache."""
    _, params, cfg, jcfg = models
    rs = np.random.RandomState(5)
    Bd, S, Sc = 3, 11, 24
    logits, jcache = _reference_prefilled(params, jcfg,
                                          _tokens(rs, cfg, Bd, S), Sc)
    nxt = np.asarray(jax_tf.greedy_sample(logits[:, -1:], cfg.vocab_size))
    lens = np.array([S, S - 3, S - 10], np.int32)
    want_d, jnew = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                         jnp.asarray(lens[:, None]), jcache,
                                         jnp.asarray(lens), 1, impl="pallas")
    Bp, Sp = 2, 17
    ptoks = _tokens(rs, cfg, Bp, Sp)
    ppos = np.broadcast_to(np.arange(Sp)[None], (Bp, Sp)).astype(np.int32)
    want_p, jaux = jax_tf.forward(params, jcfg, jnp.asarray(ptoks),
                                  jnp.asarray(ppos), 1, impl="pallas",
                                  return_aux=True, last_only=True)
    return dict(nxt=nxt, lens=lens, ptoks=ptoks, ppos=ppos, jcache=jcache,
                want_p=want_p, want_d=want_d, jaux=jaux, jnew=jnew)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_fused_pd_forward_matches_reference(models, fused_case, impl):
    """One concurrent step == the reference's forward (last position) +
    decode_forward on the same weights, prompts and cache."""
    model = models[0]
    c, page = fused_case, 8
    pools, tables = _identity_pools(c["jcache"], page)
    got_p, aux, got_d, pools = tf.fused_pd_forward(
        model, torch.from_numpy(c["ptoks"]), torch.from_numpy(c["ppos"]),
        torch.from_numpy(c["nxt"]), torch.from_numpy(c["lens"][:, None]),
        pools, tables, torch.from_numpy(c["lens"]), torch.arange(3),
        f_decode=0.25, impl=impl)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(c["want_p"]),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(c["want_d"]),
                               **LOGIT_TOL)
    np.testing.assert_allclose(aux[-1]["v"].numpy(),
                               np.asarray(c["jaux"]["pos0"]["v"][-1]),
                               **LOGIT_TOL)
    new_pools, _ = _identity_pools(c["jnew"], page)
    for mine, theirs in zip(pools, new_pools):
        np.testing.assert_allclose(mine["v"].numpy(), theirs["v"].numpy(),
                                   **LOGIT_TOL)


def test_paged_prefill_write_and_decode_match_dense(models):
    """Prompt K/V written through scattered block tables and decoded
    there == the same prompt through identity tables."""
    model, _, cfg, _ = models
    rs = np.random.RandomState(6)
    S, page = 21, 8
    toks = torch.from_numpy(_tokens(rs, cfg, 1, S))
    pos = torch.arange(S)[None]
    logits, aux = tf.forward(model, toks, pos, return_aux=True,
                             last_only=True)
    nxt = tf.greedy_sample(logits, cfg.vocab_size)
    lens = torch.tensor([S], dtype=torch.int32)
    outs = []
    for blocks in ([0, 1, 2, 3], [9, 2, 6, 4]):
        cache = tf.init_cache(cfg, 10, page, 1, device="cpu",
                              dtype=torch.float32)
        tab = torch.tensor([blocks], dtype=torch.int32)
        slot = torch.tensor([0])
        tf.write_prefill_to_cache(cache, aux, tab, slot)
        outs.append(tf.decode_forward(model, nxt, lens[:, None], cache, tab,
                                      lens, slot)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), **F32_TOL)


def test_convert_unstacks_bf16_leaves():
    """bf16 (ml_dtypes) leaves stacked over periods land unchanged in the
    right layer, in bf16."""
    cfg = get_reduced_config("granite-8b")
    params, _ = jax_tf.init_model(jax.random.PRNGKey(2),
                                  jax_reduced_config("granite-8b"))
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    stacked = params["layers"]["pos0"]
    for i, blk in enumerate(model.layers):
        assert blk.mixer.wq.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            blk.mixer.wq.float().numpy(),
            np.asarray(stacked["mixer"]["wq"][i], np.float32))
        np.testing.assert_array_equal(
            blk.ffn.w_out.float().numpy(),
            np.asarray(stacked["ffn"]["w_out"][i], np.float32))
    np.testing.assert_array_equal(
        model.tok.float().numpy(),
        np.asarray(params["embed"]["tok"], np.float32))


def test_init_model_is_seeded_and_scaled():
    cfg = get_reduced_config("granite-8b")
    a = tf.init_model(cfg, seed=3, device="cpu")
    b = tf.init_model(cfg, seed=3, device="cpu")
    c = tf.init_model(cfg, seed=4, device="cpu")
    assert a.tok.dtype == torch.bfloat16
    assert torch.equal(a.layers[1].ffn.w_out, b.layers[1].ffn.w_out)
    assert not torch.equal(a.layers[1].ffn.w_out, c.layers[1].ffn.w_out)
    assert abs(float(a.tok.float().std()) - 1.0) < 0.05          # scale 1.0
    w = a.layers[0].mixer.wq.float()                              # 1/sqrt(d)
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(a.layers[0].norm1, torch.ones(cfg.d_model,
                                                     dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="layer 0: conv/dense"):
        tf.init_model(replace(cfg, layer_pattern=("conv",)), device="cpu")


def test_kv_cache_manager_lifecycle():
    kv = KVCacheManager(num_blocks=6, page_size=4)
    assert kv_pages_for(9, 4) == 3
    assert kv.allocate_prompt(0, 9) == [0, 1, 2]
    for _ in range(3):
        assert kv.append_token(0) is None           # 10..12 fit in 3 pages
    assert kv.append_token(0) == 3                  # token 13 -> new page
    assert kv.blocks_of(0) == [0, 1, 2, 3]
    with pytest.raises(ValueError):
        kv.allocate_prompt(0, 1)
    with pytest.raises(OutOfBlocks):
        kv.allocate_prompt(1, 9)
    kv.free(0)
    assert kv.allocator.free_count == 6
