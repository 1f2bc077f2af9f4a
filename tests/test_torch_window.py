"""The sliding-window ring cache in the paged pool, against the reference.

Reduced Mixtral-8x7B (window 16, 4 experts top-2) in float32, weights
converted from the reference's ``init_model``.  The reference keeps each
sequence's K/V in a slot-dense ring of W slots (``cache_shape``,
``prefill_into_cache``, ``decode_attention``); the port keeps it in the
paged pool, position p at ring slot p % W through the first W / page
entries of the sequence's block table.  Here the ring's pages lie at
shuffled blocks of the pool.  Logits are held to atol = rtol = 1e-4, as
in ``test_torch_models.py``; greedy tokens must be identical.  On the
CPU the kernel wrappers compute their plain versions.
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
from repro.models import transformer as jax_tf
from repro_torch.config import ServeConfig, get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.core.executor import KernelExecutor
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import serve_real
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.perfmodel.hw import H100

ARCH = "mixtral-8x7b"
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
PAGE = 4                        # a ring of W / PAGE = 4 pages
HW = dataclasses.replace(H100, hbm_bytes=serve_mod.CPU_HBM_BYTES)


@pytest.fixture(scope="module")
def models():
    """(port model, reference params, reference cfg)."""
    kw = dict(dtype="float32")
    jcfg = jax_replace(jax_reduced_config(ARCH), **kw)
    cfg = replace(get_reduced_config(ARCH), **kw)
    params, _ = jax_tf.init_model(jax.random.PRNGKey(12), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    return model, params, jcfg


def _tokens(rs, cfg, B, S):
    return rs.randint(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


def _ring_tables(rs, B, W, n_blocks):
    """(B, W / PAGE) int32 tables over shuffled pool blocks."""
    return torch.from_numpy(rs.permutation(n_blocks)[:B * W // PAGE]
                            .reshape(B, W // PAGE).astype(np.int32))


def _pools_from_ring(jcache, tables, n_blocks):
    """The reference's ring cache (P, B, W, Hkv, D) laid into the port's
    pools through ``tables``: ring page j of row b in block tables[b, j]."""
    out = []
    for p in range(jcache["pos0"]["k"].shape[0]):
        layer = {}
        for name in ("k", "v"):
            ring = torch.from_numpy(np.array(jcache["pos0"][name][p]))
            B, W, Hkv, D = ring.shape
            pool = torch.zeros(n_blocks, PAGE, Hkv, D)
            pool[tables.long()] = ring.view(B, W // PAGE, PAGE, Hkv, D)
            layer[name] = pool
        out.append(layer)
    return out


def _ring_of(pools, tables):
    """The port's pools read back as rings (P, B, W, Hkv, D), per name."""
    B, n = tables.shape
    return {name: np.stack([c[name][tables.long()].reshape(B, n * PAGE,
                                                           *c[name].shape[2:])
                            .numpy() for c in pools])
            for name in ("k", "v")}


@pytest.mark.parametrize("impl", ["kernel", "ref"])
@pytest.mark.parametrize("S", [24, 13])
def test_prefill_and_decode_across_the_wrap(models, impl, S):
    """A prefill of S tokens (24 > W: only the last 16 are kept), then ten
    decode steps, which wrap the ring (at 32; at 16 for S = 13): every
    step's logits, and the ring's contents, equal the reference's on its
    slot ring cache."""
    model, params, jcfg = models
    cfg = model.cfg
    W = cfg.sliding_window
    rs = np.random.RandomState(S)
    B, n_blocks = 2, 20
    toks = _tokens(rs, cfg, B, S)
    pos = np.broadcast_to(np.arange(S)[None], (B, S)).astype(np.int32)
    want, jaux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                jnp.asarray(pos), 1, return_aux=True,
                                last_only=True)
    jcache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, B, 64, 1), jaux, S)
    assert jcache["pos0"]["k"].shape[2] == W

    tables = _ring_tables(rs, B, W, n_blocks)
    pools = tf.init_cache(cfg, n_blocks, PAGE, B, device="cpu")
    got, aux = tf.forward(model, torch.from_numpy(toks),
                          torch.from_numpy(pos), return_aux=True,
                          last_only=True, impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    tf.write_prefill_to_cache(pools, aux, tables, torch.arange(B),
                              window=W)
    ring = _ring_of(pools, tables)
    np.testing.assert_allclose(ring["k"], np.asarray(jcache["pos0"]["k"]),
                               **LOGIT_TOL)

    cur = np.array(jax_tf.greedy_sample(want, cfg.vocab_size))
    for n in range(S, S + 10):
        lens = np.full((B,), n, np.int32)
        want, jcache = jax_tf.decode_forward(
            params, jcfg, jnp.asarray(cur), jnp.asarray(lens[:, None]),
            jcache, jnp.asarray(lens), 1)
        got, _ = tf.decode_forward(model, torch.from_numpy(cur),
                                   torch.from_numpy(lens[:, None]), pools,
                                   tables, torch.from_numpy(lens),
                                   torch.arange(B), impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
        cur = np.array(jax_tf.greedy_sample(want, cfg.vocab_size))
    ring = _ring_of(pools, tables)
    for name in ("k", "v"):
        np.testing.assert_allclose(ring[name],
                                   np.asarray(jcache["pos0"][name]),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["kernel", "ref"])
def test_fused_pd_forward_with_a_wrapped_decode_row(models, impl):
    """One concurrent step: a 21-token prefill (past the window) and three
    decodes at positions 20, 17 (both wrapped) and 10, on rings over a
    shuffled pool == the reference's forward (last position, its serving
    MoE policy) + decode_forward (dropless) on its ring cache."""
    model, params, jcfg = models
    cfg = model.cfg
    W = cfg.sliding_window
    rs = np.random.RandomState(21)
    Bd, S, n_blocks = 3, 20, 16
    toks = _tokens(rs, cfg, Bd, S)
    pos = np.broadcast_to(np.arange(S)[None], (Bd, S)).astype(np.int32)
    logits, jaux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), 1, return_aux=True,
                                  last_only=True)
    jcache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, Bd, 64, 1), jaux, S)
    tables = _ring_tables(rs, Bd, W, n_blocks)
    pools = _pools_from_ring(jcache, tables, n_blocks)
    nxt = np.array(jax_tf.greedy_sample(logits, cfg.vocab_size))
    lens = np.array([S, S - 3, S - 10], np.int32)
    want_d, jnew = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                         jnp.asarray(lens[:, None]), jcache,
                                         jnp.asarray(lens), 1)
    ptoks = _tokens(rs, cfg, 1, 21)
    ppos = np.arange(21, dtype=np.int32)[None]
    want_p, _ = jax_tf.forward(params, jcfg, jnp.asarray(ptoks),
                               jnp.asarray(ppos), 1, return_aux=True,
                               last_only=True)
    got_p, aux, got_d, pools = tf.fused_pd_forward(
        model, torch.from_numpy(ptoks), torch.from_numpy(ppos),
        torch.from_numpy(nxt), torch.from_numpy(lens[:, None]), pools,
        tables, torch.from_numpy(lens), torch.arange(Bd), f_decode=0.5,
        impl=impl)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               **LOGIT_TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                               **LOGIT_TOL)
    ring = _ring_of(pools, tables)
    for name in ("k", "v"):
        np.testing.assert_allclose(ring[name], np.asarray(jnew["pos0"][name]),
                                   **LOGIT_TOL)


def test_decode_written_at_seq_lens_is_caught(models):
    """The planted fault the ring repairs: a decode whose new K/V goes to
    position seq_lens (not seq_lens % W) through a table wide enough to
    hold it leaves the ring's oldest slot stale, and its logits leave the
    reference's by far more than the limit."""
    model, params, jcfg = models
    cfg = model.cfg
    W = cfg.sliding_window
    rs = np.random.RandomState(5)
    S = 24
    toks = _tokens(rs, cfg, 1, S)
    pos = np.arange(S, dtype=np.int32)[None]
    logits, jaux = jax_tf.forward(params, jcfg, jnp.asarray(toks),
                                  jnp.asarray(pos), 1, return_aux=True,
                                  last_only=True)
    jcache = jax_tf.write_prefill_to_cache(
        jcfg, jax_tf.init_cache(jcfg, 1, 64, 1), jaux, S)
    nxt = np.array(jax_tf.greedy_sample(logits, cfg.vocab_size))
    lens = np.array([S], np.int32)
    want, _ = jax_tf.decode_forward(params, jcfg, jnp.asarray(nxt),
                                    jnp.asarray(lens[:, None]), jcache,
                                    jnp.asarray(lens), 1)
    # a table of 8 pages: the ring's 4, then 4 more for positions >= W
    tables = torch.arange(8, dtype=torch.int32)[None]
    pools = _pools_from_ring(jcache, tables[:, :W // PAGE], 8)
    faulty = replace(cfg, sliding_window=None)      # writes at seq_lens
    orig = ops.paged_attention

    def attend_ring(q, k_pages, v_pages, block_tables, seq_lens):
        return orig(q, k_pages, v_pages,
                    block_tables[:, :W // PAGE].contiguous(),
                    attn_mod.ring_lens(seq_lens, W))
    model.cfg = faulty
    ops.paged_attention = attend_ring
    try:
        got, _ = tf.decode_forward(model, torch.from_numpy(nxt),
                                   torch.from_numpy(lens[:, None]), pools,
                                   tables, torch.from_numpy(lens),
                                   torch.arange(1))
    finally:
        model.cfg, ops.paged_attention = cfg, orig
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err > 100 * LOGIT_TOL["atol"] * (1 + np.abs(want).max()), err


def test_ring_tables_and_pages_are_checked(models):
    model = models[0]
    cfg = model.cfg
    with pytest.raises(ValueError, match="does not divide"):
        tf.init_cache(cfg, 8, 6, 1, device="cpu")
    assert attn_mod.ring_table(list(range(9)), 16, PAGE) == [0, 1, 2, 3]
    assert attn_mod.ring_table(list(range(3)), 16, PAGE) == [0, 1, 2]
    assert attn_mod.ring_table(list(range(9)), None, PAGE) == list(range(9))
    pools = tf.init_cache(cfg, 8, PAGE, 1, device="cpu")
    wide = torch.zeros(1, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="ring tables"):
        tf.decode_forward(model, torch.zeros(1, 1, dtype=torch.int32),
                          torch.full((1, 1), 20), pools, wide,
                          torch.full((1,), 20, dtype=torch.int32),
                          torch.arange(1))


# (prompt, new tokens): prompts of 8 and 12 sit on page boundaries below
# W (their first decodes write into a spare page), 16 on the boundary at
# W (its ring slot 0 lies in a block it holds: no spare), 24 past W
TRAFFIC = [(8, 14), (16, 6), (5, 20), (24, 5), (12, 3), (3, 1)]


def _requests(cfg, traffic=TRAFFIC, seed=8):
    rng = np.random.default_rng(seed)
    return [serve_real.Request(
        rid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), new)
        for rid, (n, new) in enumerate(traffic)]


def test_engine_tokens_match_reference_through_the_wrap(models,
                                                        monkeypatch):
    """RapidEngine + KernelExecutor on rings of 4 pages: every request's
    greedy tokens equal the reference's own loop on its ring cache.  The
    spare page serves exactly the page-boundary decodes below W, and a
    page-boundary decode at or past W writes into the ring's block."""
    model, params, jcfg = models
    cfg = model.cfg
    W = cfg.sliding_window
    reqs = _requests(cfg)
    serve = ServeConfig(mode="rapid", chips=1, max_batch_slots=4,
                        page_size=PAGE)
    seen = []
    inputs = KernelExecutor._decode_inputs

    def record(self, decode, kv):
        out = inputs(self, decode, kv)
        spared = dict(self._spare)
        for r, n, table in zip(decode, out[1].tolist(), out[2].tolist()):
            if n % PAGE == 0:
                seen.append((n, r.rid in spared,
                             max(table) >= self.num_blocks))
        return out
    monkeypatch.setattr(KernelExecutor, "_decode_inputs", record)
    ops.reset_launches()
    result = serve_mod.serve_engine(model, reqs, serve, hw=HW)
    s = serve_mod.summarize(result)
    assert s["tokens_met"] and s["pool_reclaimed"] and \
        s["state_rows_reclaimed"]
    assert {"fused", "prefill", "decode"} <= set(s["launches"])
    assert {(n < W, spare) for n, spare, _ in seen} == {(True, True),
                                                         (False, False)}
    assert all(spare == in_table for _, spare, in_table in seen)
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    for r in reqs:
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert result["tokens"][r.rid] == want, r.rid


def test_serve_real_tokens_match_reference_through_the_wrap(models):
    """serve_real's loop on ring tables: greedy tokens == the reference's,
    prompts of 6-24 tokens and up to 12 new ones around W = 16."""
    model, params, jcfg = models
    reqs = serve_real.make_requests(model.cfg, 6, seed=4)
    result = serve_real.serve(model, reqs, slots=3, page=PAGE, f_decode=0.5)
    assert result["pool_reclaimed"] and result["state_slots_reclaimed"]
    assert set(result["steps"]) == {"prefill", "decode", "fused"}
    assert max(len(r.prompt) + r.max_new for r in reqs) > \
        2 * model.cfg.sliding_window
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    for r in result["requests"]:
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert r.tokens == want, r.rid
