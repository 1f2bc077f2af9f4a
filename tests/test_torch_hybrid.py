"""The hybrid-batching baseline on the port, against the reference.

Hybrid batching (Sarathi, vLLM's chunked prefill) runs one batch a step:
the running decodes plus prompt chunks, each chunk at its offset over its
request's paged KV.  Held here on the CPU, in float32, weights converted
from the reference's ``init_model``:

  (a) the plain math: ``ref.causal_attention(q_offset=)`` and the paged
      chunk form ``ref.paged_prefill`` against the reference's oracle
      ``repro.kernels.ref.causal_attention(q_offset=)`` (3e-5), and the
      paged form's input checks;
  (b) ``hybrid_forward``: reduced granite-8b and reduced Jamba (dense
      FFNs) prefilled in chunks, two prompts packed in each step: each
      chunk's last-position logits against the reference's ``forward`` at
      those positions, the pool's K/V against ``write_prefill_to_cache``
      of a whole prefill, and (Jamba) the conv and SSM state against the
      whole prefill's and the reference's ``mamba_forward(state=)``;
  (c) ``HybridEngine`` + ``KernelExecutor``: greedy tokens identical to
      the reference's greedy decode, chunks and decodes in one step,
      through a KV-pressure eviction and its re-prefill; the liveness
      property of the reference's ``test_liveness_properties.py`` with
      fully cached prompts drawn; ``launch/serve.py --mode`` and the
      gateway's hybrid workers; and what the hybrid path refuses.

On the CPU the kernel wrappers compute their plain versions, so no launch
is counted.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from test_torch_executor import _models, _requests
from test_torch_serve import _reference_greedy

from repro.kernels import ref as jax_ref
from repro.models import mamba as jax_mamba
from repro.models import transformer as jax_tf
from repro_torch.config import (SLOConfig, ServeConfig, get_config,
                                get_reduced_config, replace)
from repro_torch.convert import model_from_reference
from repro_torch.core import make_engine
from repro_torch.core.engines import HybridEngine
from repro_torch.core.events import FinishedEvent, TokenEvent
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request, State
from repro_torch.kernels import flash_prefill as fp
from repro_torch.kernels import ops, ref
from repro_torch.kvcache import KVCacheManager
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as tf
from repro_torch.models.layers import embed_tokens, rmsnorm
from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel.hw import H100
from repro_torch.serving.sim import EventLoop

TOL = dict(atol=3e-5, rtol=3e-5)
HW = dataclasses.replace(H100, hbm_bytes=serve_mod.CPU_HBM_BYTES)
JAMBA = "jamba-1.5-large-398b"


def _normal(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the plain math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("offset", [0, 5, 16, 37])
def test_causal_attention_q_offset_matches_reference(offset, G):
    rs = np.random.RandomState(offset * 10 + G)
    Hkv, Sq, D = 2, 13, 32
    q = _normal(rs, 2, Hkv * G, Sq, D)
    k, v = (_normal(rs, 2, Hkv, offset + Sq, D) for _ in range(2))
    want = jax_ref.causal_attention(*map(jnp.asarray, (q, k, v)),
                                    q_offset=offset)
    got = ref.causal_attention(*map(torch.from_numpy, (q, k, v)),
                               q_offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_case(rs, G, lens, offsets, page=8, n_blocks=40):
    """Random pages, and per chunk a table of distinct random blocks that
    covers its offset + len keys (padded to one width with block 0)."""
    Hkv, D = 2, 32
    kp, vp = (_normal(rs, n_blocks, page, Hkv, D) for _ in range(2))
    need = [-(-(o + n) // page) for n, o in zip(lens, offsets)]
    width = max(need)
    perm = rs.permutation(n_blocks)
    tables, at = [], 0
    for m in need:
        tables.append(list(perm[at:at + m]) + [0] * (width - m))
        at += m
    q = _normal(rs, sum(lens), Hkv * G, D)
    return q, kp, vp, np.asarray(tables, np.int32)


@pytest.mark.parametrize("G", [1, 4, 8])
def test_paged_prefill_matches_reference_oracle(G):
    """Each chunk's output equals the reference's oracle at its offset
    over its K/V gathered contiguous; the kernel wrapper on a CPU tensor
    computes the same plain version."""
    rs = np.random.RandomState(G)
    lens, offsets = (5, 16, 9, 1), (0, 7, 32, 40)
    q, kp, vp, tables = _paged_case(rs, G, lens, offsets)
    chunks = fp.Chunks(lens, offsets)
    got = ref.paged_prefill(*map(torch.from_numpy, (q, kp, vp, tables)),
                            chunks.starts, lens, offsets)
    wrapped = ops.flash_prefill_paged(
        *map(torch.from_numpy, (q, kp, vp, tables)), chunks)
    np.testing.assert_array_equal(wrapped.numpy(), got.numpy())
    page = kp.shape[1]
    for c, (s, n, off) in enumerate(zip(chunks.starts, lens, offsets)):
        keys = off + n
        kk = kp[tables[c]].reshape(-1, *kp.shape[2:])[:keys]
        vv = vp[tables[c]].reshape(-1, *vp.shape[2:])[:keys]
        assert kk.shape[0] == keys and keys <= tables.shape[1] * page
        want = jax_ref.causal_attention(
            jnp.asarray(q[None, s:s + n]).transpose(0, 2, 1, 3),
            jnp.asarray(kk[None]).transpose(0, 2, 1, 3),
            jnp.asarray(vv[None]).transpose(0, 2, 1, 3), q_offset=off)
        np.testing.assert_allclose(
            got[s:s + n].numpy(),
            np.asarray(want)[0].transpose(1, 0, 2), **TOL)


@pytest.mark.parametrize("fault", ["past_table", "past_own_table",
                                   "table_dtype", "rows", "negative"])
def test_paged_prefill_checks_refuse_bad_inputs(fault):
    rs = np.random.RandomState(0)
    lens, offsets = (5, 9), (0, 16)
    q, kp, vp, tables = map(torch.from_numpy,
                            _paged_case(rs, 2, lens, offsets))
    chunks = fp.Chunks(lens, offsets)
    with pytest.raises(ValueError):
        if fault == "past_table":
            fp.check_paged_prefill(q, kp, vp, tables,
                                   fp.Chunks(lens, (0, 24)))
        elif fault == "past_own_table":
            # chunk 0's table is 1 page, padded to 4: its keys 8..12 lie
            # in the padding, which is another request's block
            fp.check_paged_prefill(q, kp, vp, tables,
                                   fp.Chunks(lens, (8, 16), pages=(1, 4)))
        elif fault == "table_dtype":
            fp.check_paged_prefill(q, kp, vp, tables.long(), chunks)
        elif fault == "rows":
            fp.check_paged_prefill(q[1:], kp, vp, tables, chunks)
        else:
            fp.Chunks((5, -1), (0, 0))
    fp.check_paged_prefill(q, kp, vp, tables, chunks)      # the sound case
    fp.check_paged_prefill(q, kp, vp, tables, fp.Chunks(lens, offsets,
                                                        pages=(1, 4)))


# ---------------------------------------------------------------------------
# (b) hybrid_forward: a prompt prefilled in chunks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def granite():
    return _models("granite-8b")


@pytest.fixture(scope="module")
def jamba():
    return _models(JAMBA, ffn_pattern=("dense",))


def _arch_models(arch, granite, jamba):
    return granite if arch == "granite-8b" else jamba


PROMPTS = (41, 30)          # two prompts, chunked side by side


def _chunked(model, prompts, chunk, page=8):
    """Prefill ``prompts`` in chunks of ``chunk`` tokens, both prompts'
    chunks packed in each ``hybrid_forward`` step (a prompt that is done
    drops out).  Returns the cache, the block tables, each prompt's
    last-position logits of each chunk (position -> logits) and the state
    rows."""
    cfg = model.cfg
    rows = [3, 1]
    blocks = np.random.RandomState(9).permutation(32)
    need = [-(-n // page) for n in map(len, prompts)]
    tables = [list(blocks[:need[0]]), list(blocks[need[0]:sum(need)])]
    cache = tf.init_cache(cfg, 32, page, 4, device="cpu",
                          dtype=torch.float32)
    got = [{}, {}]
    done = [0, 0]
    none = torch.zeros((0, 1), dtype=torch.int32)
    while any(d < len(p) for d, p in zip(done, prompts)):
        live = [i for i, p in enumerate(prompts) if done[i] < len(p)]
        lens = [min(chunk, len(prompts[i]) - done[i]) for i in live]
        offs = [done[i] for i in live]
        toks = np.concatenate([prompts[i][o:o + n]
                               for i, o, n in zip(live, offs, lens)])
        pos = np.concatenate([np.arange(o, o + n)
                              for o, n in zip(offs, lens)])
        width = max(len(tables[i]) for i in live)
        tabs = torch.tensor([tables[i] + [0] * (width - len(tables[i]))
                             for i in live], dtype=torch.int32)
        c_logits, d_logits, _ = tf.hybrid_forward(
            model, torch.from_numpy(toks), torch.from_numpy(pos),
            fp.Chunks(lens, offs), tabs,
            torch.tensor([rows[i] for i in live]), none, none[:, 0], none,
            torch.zeros(0, dtype=torch.int64), cache)
        assert d_logits.shape[0] == 0
        for j, (i, o, n) in enumerate(zip(live, offs, lens)):
            got[i][o + n - 1] = c_logits[j, 0].numpy()
            done[i] += n
    return cache, tables, got, rows


@pytest.mark.parametrize("arch", ["granite-8b", JAMBA])
@pytest.mark.parametrize("chunk", [7, 16, 23])
def test_chunked_prefill_matches_reference_forward(arch, chunk, granite,
                                                   jamba):
    model, params, jcfg = _arch_models(arch, granite, jamba)
    cfg = model.cfg
    rs = np.random.RandomState(chunk)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPTS]
    ops.reset_launches()
    cache, tables, got, rows = _chunked(model, prompts, chunk)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    page = cache[0 if "k" in cache[0] else 4]["k"].shape[1]
    for i, p in enumerate(prompts):
        S = len(p)
        want, jaux = jax_tf.forward(params, jcfg, jnp.asarray(p[None]),
                                    jnp.arange(S)[None], 1, impl="ref",
                                    return_aux=True)
        want = np.asarray(want)[0]
        assert sorted(got[i]) == sorted({min(o + chunk, S) - 1
                                         for o in range(0, S, chunk)})
        for t, logits in got[i].items():
            np.testing.assert_allclose(logits, want[t], **TOL)
        jcache = jax_tf.write_prefill_to_cache(
            jcfg, jax_tf.init_cache(jcfg, 1, S, 1), jaux, S)
        pos = np.arange(S)
        flat = np.asarray(tables[i])[pos // page] * page + pos % page
        for layer, c in enumerate(cache):
            leaf = jcache[f"pos{layer % cfg.period}"]
            if "k" in c:
                for name in ("k", "v"):
                    np.testing.assert_allclose(
                        c[name].flatten(0, 1)[flat].numpy(),
                        np.asarray(leaf[name][layer // cfg.period][0, :S]),
                        **TOL)
            else:
                for name in ("conv", "ssm"):
                    np.testing.assert_allclose(
                        c[name][rows[i]].numpy(),
                        np.asarray(leaf[name][layer // cfg.period][0]),
                        **TOL)


@pytest.mark.parametrize("chunk", [7, 23])
def test_chunked_mamba_state_matches_reference_from_state(chunk, jamba):
    """The state a chunked prefill leaves in the first Mamba layer's row
    equals the reference's ``mamba_forward(state=)`` run chunk by chunk
    over the same layer inputs, and the whole prefill's state."""
    model, params, jcfg = jamba
    cfg = model.cfg
    assert cfg.mixer_at(0) == "mamba"
    rs = np.random.RandomState(50 + chunk)
    prompts = [rs.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in PROMPTS]
    cache, _, _, rows = _chunked(model, prompts, chunk)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["pos0"]["mixer"])
    for i, p in enumerate(prompts):
        x = rmsnorm(embed_tokens(model, torch.from_numpy(p[None])),
                    model.layers[0].norm1, cfg.norm_eps).numpy()
        state = None
        for o in range(0, len(p), chunk):
            _, state = jax_mamba.mamba_forward(
                jp, jcfg, jnp.asarray(x[:, o:o + chunk]), state=state,
                return_state=True, impl="ref")
        _, whole = jax_mamba.mamba_forward(jp, jcfg, jnp.asarray(x),
                                           return_state=True, impl="ref")
        for name in ("conv", "ssm"):
            np.testing.assert_allclose(cache[0][name][rows[i]].numpy(),
                                       np.asarray(state[name][0]), **TOL)
            np.testing.assert_allclose(cache[0][name][rows[i]].numpy(),
                                       np.asarray(whole[name][0]), **TOL)


# ---------------------------------------------------------------------------
# (c) HybridEngine + KernelExecutor
# ---------------------------------------------------------------------------

# prompts all longer than the chunk (4), two on page boundaries (16, 32)
TRAFFIC = [(16, 9), (32, 7), (7, 6), (21, 8), (5, 3), (40, 4)]
PRESSURE = [(200, 80), (190, 75), (210, 85), (180, 70)]
POOL_BLOCKS = 64


def _hybrid_serve(model, reqs, hw=HW, chunk=4):
    return serve_mod.serve_engine(
        model, reqs, serve_mod.serve_config(mode="hybrid", chunk=chunk),
        hw=hw)


@pytest.mark.parametrize("arch", ["granite-8b", JAMBA])
@pytest.mark.parametrize("traffic", ["chunks_and_decodes", "eviction"])
def test_hybrid_engine_tokens_match_reference(arch, traffic, granite, jamba):
    model, params, jcfg = _arch_models(arch, granite, jamba)
    if traffic == "eviction":
        # a pool of 64 blocks, 1,024 tokens: the four requests outgrow it
        # while they decode
        cfg = model.cfg
        block = cfg.kv_bytes_per_token() * serve_mod.serve_real.PAGE
        hbm = int((C.weight_bytes(cfg) + (POOL_BLOCKS + 0.5) * block) /
                  (1 - ServeConfig().kv_reserve_frac)) + 1
        reqs = _requests(cfg, PRESSURE)
        result = _hybrid_serve(model, reqs, dataclasses.replace(
            HW, hbm_bytes=hbm), chunk=64)
        assert result["pool_blocks"] == POOL_BLOCKS
    else:
        reqs = _requests(model.cfg, TRAFFIC)
        result = _hybrid_serve(model, reqs)
    s = serve_mod.summarize(result)
    assert s["tokens_met"] and s["pool_reclaimed"] and \
        s["state_rows_reclaimed"] and s["rejected"] == 0
    log = result["log"]
    assert any(e["kind"] == "hybrid" and e["decode_bs"] and e["chunks"]
               for e in log)
    if traffic == "eviction":
        assert s["preemptions"] >= 1
        resumed = [e for e in log if e["resumed"]]
        assert resumed
    else:
        assert s["preemptions"] == 0
        assert all(n <= 4 for e in log if e["kind"] == "hybrid"
                   for _, _, n in e["chunks"])
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    for r in reqs:
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert result["tokens"][r.rid] == want, r.rid


def test_hybrid_and_rapid_serve_the_same_tokens(granite):
    """``serve_engine`` in both modes on the same requests, and the
    ``--mode`` of ``launch/serve.py``'s CLI on the CPU."""
    model = granite[0]
    reqs = _requests(model.cfg, TRAFFIC[:4])
    rapid = serve_mod.serve_engine(model, reqs, serve_mod.serve_config(),
                                   hw=HW)
    hybrid = _hybrid_serve(model, reqs)
    assert hybrid["tokens"] == rapid["tokens"]
    kinds = {e["kind"] for e in hybrid["log"]}
    assert kinds == {"hybrid", "decode"}
    assert serve_mod.summarize(hybrid)["arm_modes"] == {}


@pytest.mark.parametrize("mode", ["disagg", "all"])
def test_serve_refuses_disagg_modes(mode):
    """The online server refuses split pools (ROADMAP A11); offline they
    run (tests/test_torch_disagg.py), on the one-card split."""
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        serve_mod.main(["--device", "cpu", "--dtype", "float32", "--mode",
                        mode, "--serve", "http"])
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        serve_mod.kernel_engines(None, {}, {})(
            mode, get_reduced_config("granite-8b"),
            serve_mod.serve_config(mode=mode), HW, EventLoop())
    serve = serve_mod.serve_config(mode=mode)
    assert (serve.mode, serve.chips, serve.disagg_split) == (mode, 1, (1, 1))


def test_serve_main_hybrid_on_cpu(capsys):
    assert serve_mod.main(["--device", "cpu", "--dtype", "float32",
                           "--mode", "hybrid", "--chunk", "16",
                           "--requests", "3"]) == 0
    out = capsys.readouterr().out
    assert '"hybrid"' in out and '"tokens_met": true' in out


def test_gateway_hybrid_workers_give_the_reference_tokens(granite):
    """Two hybrid workers behind the gateway serve the reference's greedy
    tokens, and end reclaimed."""
    model, params, jcfg = granite
    prompts = serve_mod.SeededPrompts(model.cfg.vocab_size, 3)
    gw = serve_mod.make_gateway(
        model, serve_mod.serve_config(mode="hybrid", chunk=8), prompts,
        clock=EventLoop(), hw=HW, workers=2, router="round_robin")
    seen = {}
    reqs = [Request(rid=i, arrival=0.001 * i, prompt_len=n,
                    max_new_tokens=m)
            for i, (n, m) in enumerate(TRAFFIC[:4])]
    gw._expected += len(reqs)
    for r in reqs:
        def go(r=r):
            prompts.add(r)
            seen[r.rid] = []
            gw.submit(r, consumer=seen[r.rid].append)
        gw.clock.at(r.arrival, go)
    gw.clock.run()
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(r.prompt_len + r.max_new_tokens for r in reqs)
    workers = list(gw.registry.workers.values())
    assert all(w.engine.scheduler.mode == "hybrid" for w in workers)
    for r in reqs:
        assert isinstance(seen[r.rid][-1], FinishedEvent)
        assert [e.index for e in seen[r.rid] if isinstance(e, TokenEvent)] \
            == list(range(r.max_new_tokens))
        ex = next(w.engine.executor for w in workers
                  if any(x.rid == r.rid for x in w.engine.finished))
        assert ex.tokens[r.rid] == _reference_greedy(
            params, jcfg, step, prompts[r.rid], r.max_new_tokens, max_seq)
    for w in workers:
        ex, kv = w.engine.executor, w.engine.kv
        assert kv.num_requests == 0 and ex.rows_free == ex.state_rows
        assert kv.allocator.free_count == kv.allocator.num_blocks


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "xlstm-125m"])
def test_hybrid_refuses_windowed_and_xlstm_models(arch):
    cfg = replace(get_reduced_config(arch), dtype="float32")
    model = tf.init_model(cfg, device="cpu", seed=0)
    serve = serve_mod.serve_config(mode="hybrid")
    ex = KernelExecutor(model, prompts={}, serve=serve, device="cpu", hw=HW)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ex.bind(HybridEngine(cfg, serve, HW))
    none = torch.zeros((0, 1), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tf.hybrid_forward(model, torch.zeros(4, dtype=torch.int32),
                          torch.arange(4), fp.Chunks([4], [0]),
                          torch.zeros((1, 1), dtype=torch.int32),
                          torch.zeros(1, dtype=torch.int64), none,
                          none[:, 0], none, torch.zeros(0, dtype=torch.long),
                          tf.init_cache(cfg, 4, 16, 1, device="cpu"))


def test_a_chunk_after_a_cached_prefix_raises(granite):
    model = granite[0]
    serve = serve_mod.serve_config(mode="hybrid")
    ex = KernelExecutor(model, prompts={0: np.zeros(8, np.int32)},
                        serve=serve, device="cpu", hw=HW)
    eng = HybridEngine(model.cfg, serve, HW, executor=ex)
    ex.bind(eng)
    from repro_torch.core.scheduler import HybridLaunch, StepPlan, Wake
    r = Request(0, 0.0, 8, 4, cached_prefix_len=3)
    eng.kv.allocate_prompt(0, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        ex.execute(StepPlan(hybrid=HybridLaunch([(r, 5)])),
                   eng._view(Wake("arrival")))


# -- liveness: every request terminates (after the reference's property) ----

CFG = get_config("llama3-70b")
TINY_BLOCKS, PAGE, MAX_OUT = 64, 16, 12
POOL_TOKENS = TINY_BLOCKS * PAGE


def _live_engine(mode):
    eng = make_engine(mode, CFG, ServeConfig(
        mode=mode, chips=32, slo=SLOConfig(itl_ms=100.0),
        max_batch_slots=4, max_seq_len=32768))
    eng.kv = KVCacheManager(num_blocks=TINY_BLOCKS, page_size=PAGE,
                            session_cache_blocks=16)
    return eng


def _check_terminated(mode, reqs):
    for r in reqs:
        assert r.state in (State.FINISHED, State.REJECTED), \
            (mode, r.rid, r.state)
        if r.state is State.REJECTED:
            assert r.reject_reason == "never_fits"
        else:
            assert r.tokens_generated == r.max_new_tokens
            assert r.prefill_tokens_done + r.cached_prefix_len == \
                r.prompt_len


@pytest.mark.parametrize("mode", ["rapid", "hybrid"])
@settings(max_examples=25, deadline=None)
@given(data=st.data())
def test_every_request_terminates_with_cached_prompts(mode, data):
    """The reference's property, with short prompts whose claimed cached
    prefix may cover them whole (the reference's hybrid engine stalls on
    one: prompt 16, claim 16)."""
    eng = _live_engine(mode)
    prompt = st.one_of(st.integers(1, 64),
                       st.integers(16, POOL_TOKENS - MAX_OUT),
                       st.integers(POOL_TOKENS - MAX_OUT + 1, 1200))
    reqs = []
    for i in range(data.draw(st.integers(1, 10))):
        n = data.draw(prompt)
        reqs.append(Request(
            rid=i, arrival=0.0, prompt_len=n,
            max_new_tokens=data.draw(st.integers(1, MAX_OUT)),
            slo_class=data.draw(st.sampled_from(
                ["interactive", "batch", "best_effort"])),
            session_id=data.draw(st.one_of(st.none(),
                                           st.sampled_from(["sa", "sb"]))),
            cached_prefix_len=data.draw(st.one_of(
                st.integers(0, 64), st.integers(n, n + 8)))))
    for r in reqs:
        eng.submit(r)
    eng.loop.run()
    _check_terminated(mode, reqs)


@pytest.mark.parametrize("mode", ["rapid", "hybrid"])
def test_a_prompt_claimed_cached_whole_finishes(mode):
    """The reference's falsifying example: one request, prompt 16, claim
    16.  Its last prompt position is computed and it finishes."""
    eng = _live_engine(mode)
    r = Request(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=3,
                cached_prefix_len=16)
    eng.submit(r)
    eng.loop.run()
    _check_terminated(mode, [r])
    assert r.state is State.FINISHED
