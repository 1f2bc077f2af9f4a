"""``RapidEngine`` + ``KernelExecutor`` on the CPU, against the reference.

Reduced granite-8b and reduced Jamba with dense FFNs, float32, weights
converted from the reference's ``init_model``.  RAPID-Serve's own
scheduler drives the port's model through the executor; every request's
greedy tokens must be identical to the reference's own greedy loop
(``_reference_greedy``), whatever launch (prefill alone, decode alone,
fused) the scheduler gave it.  The traffic holds prompts of exactly 16
and 32 tokens, a page boundary (page 16): their first decode step writes
into the spare page of the executor's pool.  On the CPU the kernel
wrappers compute their plain versions, so no launch is counted.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_serve import _reference_greedy

from repro.config import get_reduced_config as jax_reduced_config
from repro.config import replace as jax_replace
from repro.models import transformer as jax_tf
from repro_torch.config import get_reduced_config, replace
from repro_torch.convert import model_from_reference
from repro_torch.core import resource_manager as rm
from repro_torch.core.engines import DisaggEngine, RapidEngine, drive
from repro_torch.core.events import FinishedEvent
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request
from repro_torch.core.scheduler import (DecodeLaunch, HybridLaunch,
                                        PrefillLaunch, StepPlan, Wake)
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import serve_real
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.perfmodel.hw import H100

HW = dataclasses.replace(H100, hbm_bytes=serve_mod.CPU_HBM_BYTES)
# (prompt length, new tokens): 16 and 32 sit on page boundaries, and the
# 16-token prompt decodes across the next one (position 32) too
TRAFFIC = [(16, 19), (32, 18), (7, 6), (21, 11), (3, 1), (40, 5)]


def _models(arch, **kw):
    kw = dict(kw, dtype="float32")
    jcfg = jax_replace(jax_reduced_config(arch), **kw)
    cfg = replace(get_reduced_config(arch), **kw)
    params, _ = jax_tf.init_model(jax.random.PRNGKey(11), jcfg)
    model = model_from_reference(jax.tree.map(np.asarray, params), cfg)
    return model, params, jcfg


@pytest.fixture(scope="module")
def granite():
    return _models("granite-8b")


def _requests(cfg, traffic=TRAFFIC, seed=5):
    rng = np.random.default_rng(seed)
    return [serve_real.Request(
        rid, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), new)
        for rid, (n, new) in enumerate(traffic)]


def _recording(monkeypatch):
    """Wrap the model's entry points to record each call's f_decode and
    the largest block id in its block table."""
    seen = []

    def wrap(name):
        fn = getattr(tf, name)

        @functools.wraps(fn)
        def rec(*a, **kw):
            tables = a[6] if name == "fused_pd_forward" else a[4]
            seen.append((name, kw.get("f_decode"), int(tables.max())))
            return fn(*a, **kw)
        monkeypatch.setattr(tf, name, rec)

    wrap("fused_pd_forward")
    wrap("decode_forward")
    return seen


@pytest.mark.parametrize("arch", ["granite-8b", "jamba-1.5-large-398b"])
def test_engine_tokens_match_reference(arch, granite, monkeypatch):
    if arch == "granite-8b":
        model, params, jcfg = granite
    else:
        model, params, jcfg = _models(arch, ffn_pattern=("dense",))
    reqs = _requests(model.cfg)
    seen = _recording(monkeypatch)
    ops.reset_launches()
    result = serve_mod.serve_engine(model, reqs, serve_mod.serve_config(),
                                    hw=HW)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    s = serve_mod.summarize(result)
    assert s["tokens_met"] and s["pool_reclaimed"] and \
        s["state_rows_reclaimed"]
    assert s["preemptions"] == 0 and s["rejected"] == 0
    assert {"fused", "prefill", "decode"} <= set(s["launches"])
    # the page-boundary writes went through the spare pages
    assert max(b for _, _, b in seen) >= result["pool_blocks"]
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    for r in reqs:
        want = _reference_greedy(params, jcfg, step, r.prompt, r.max_new,
                                 max_seq)
        assert result["tokens"][r.rid] == want, r.rid
    assert [rec.output_len for rec in result["records"]] == \
        [r.max_new for r in reqs]


def test_pool_holds_every_position_read_at_finish(granite):
    """When a request finishes, the blocks the engine gave it hold the K/V
    of every position a decode step read (prompt and generated tokens but
    the last two), the spare-page positions 16 and 32 included: the same
    K/V as a prefill of the whole sequence.  (The last step's own K/V is
    read by no step; when it crosses a page boundary it stays in the
    spare, which the finish drops.)"""
    model = granite[0]
    reqs = _requests(model.cfg)
    serve = serve_mod.serve_config()
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in reqs},
                        serve=serve, device="cpu", hw=HW)
    eng = RapidEngine(model.cfg, serve, HW, executor=ex)
    ex.bind(eng)
    by_rid = {r.rid: Request(r.rid, 0.0, len(r.prompt), r.max_new)
              for r in reqs}
    checked = []

    def check(ev):
        if not isinstance(ev, FinishedEvent):
            return
        toks = np.concatenate([reqs[ev.rid].prompt,
                               ex.tokens[ev.rid][:-2]]).astype(np.int32)
        n = len(toks)
        _, aux = tf.forward(model, torch.from_numpy(toks[None]),
                            torch.arange(n)[None], return_aux=True)
        rows = attn_mod.pool_rows(torch.tensor([by_rid[ev.rid].blocks]),
                                  torch.arange(n)[None], serve.page_size)
        for c, a in zip(ex.cache, aux):
            for name in ("k", "v"):
                torch.testing.assert_close(c[name].flatten(0, 1)[rows],
                                           a[name][0], rtol=1e-5, atol=1e-5)
        checked.append(n)

    eng.subscribe(check)
    drive(eng, list(by_rid.values()))
    assert sorted(checked) == sorted(n + max(new - 2, 0)
                                     for n, new in TRAFFIC)


def test_launches_never_overlap_on_the_engine_clock(granite):
    """The card runs one launch at a time: on the engine's clock each
    launch starts after the one before it ends, and the fused plan's
    decode lane ends before its prefill lane, which runs on."""
    model = granite[0]
    result = serve_mod.serve_engine(model, _requests(model.cfg),
                                    serve_mod.serve_config(), hw=HW)
    log = result["log"]
    for a, b in zip(log, log[1:]):
        assert b["t_start"] >= a["t_start"] + a["wall_s"] - 1e-12
    assert result["span_s"] >= sum(e["wall_s"] for e in log)
    kinds = [e["kind"] for e in log]
    i = kinds.index("fused")
    assert kinds[:i] == ["prefill"] and kinds[i + 1] == "prefill"
    # request 0's second token came after the whole prefill batch
    r0 = result["requests"][0]
    prefills_end = max(e["t_start"] + e["wall_s"] for e in log
                       if e["kind"] != "decode" and e is not log[0])
    assert r0.token_times[2] >= prefills_end


@pytest.mark.parametrize("arm_f,passed", [(0.3, 0.3), (None, 1.0)])
def test_arm_f_decode_reaches_the_fused_step(arm_f, passed, granite,
                                             monkeypatch):
    seen = _recording(monkeypatch)
    monkeypatch.setattr(rm.AdaptiveResourceManager, "allocate",
                        lambda self, bs, active: rm.Allocation(
                            arm_f, "stub"))
    model = granite[0]
    result = serve_mod.serve_engine(
        model, _requests(model.cfg, [(9, 3), (12, 2)]),
        serve_mod.serve_config(), hw=HW)
    fused = [f for name, f, _ in seen if name == "fused_pd_forward"]
    assert fused == [passed]
    assert [e["arm_f_decode"] for e in result["log"]
            if e["kind"] == "fused"] == [arm_f]


def _bound(model, prompts):
    serve = serve_mod.serve_config()
    ex = KernelExecutor(model, prompts=prompts, serve=serve, device="cpu",
                        hw=HW)
    eng = RapidEngine(model.cfg, serve, HW, executor=ex)
    ex.bind(eng)
    return ex, eng


def _plan_for(case, eng):
    r = Request(0, 0.0, 8, 4)
    eng.kv.allocate_prompt(0, 8)
    if case == "session_prefix":
        r.cached_prefix_len = 3
        return StepPlan(prefill=PrefillLaunch([r], "waiting_prefill"))
    if case == "preempted_reprefill":
        r.preemptions = 1
        return StepPlan(prefill=PrefillLaunch([r], "waiting_prefill"))
    return StepPlan(hybrid=HybridLaunch([(r, 8)]))


@pytest.mark.parametrize("case", ["hybrid", "transfer", "price_batch",
                                  "session_prefix", "preempted_reprefill",
                                  "disagg_engine"])
def test_what_it_does_not_run_raises(case, granite):
    ex, eng = _bound(granite[0], {0: np.zeros(8, np.int32)})
    view = eng._view(Wake("arrival"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "disagg_engine":
            KernelExecutor(granite[0], prompts={}, serve=eng.serve,
                           device="cpu", hw=HW).bind(
                DisaggEngine(granite[0].cfg, eng.serve, HW))
        elif case == "transfer":
            ex.transfer_seconds(Request(0, 0.0, 8, 4), eng.serve)
        elif case == "price_batch":
            ex.price_batch([StepPlan()], [view])
        else:
            ex.execute(_plan_for(case, eng), view)


def test_a_live_state_row_is_never_overwritten(granite):
    """A request prefilled again while it still holds its state row (and
    its KV) is refused before anything runs."""
    model = granite[0]
    ex, eng = _bound(model, {0: np.arange(5, dtype=np.int32),
                             1: np.arange(5, dtype=np.int32)})
    r = Request(0, 0.0, 5, 3)
    eng.kv.allocate_prompt(0, 5)
    view = eng._view(Wake("arrival"))
    plan = StepPlan(prefill=PrefillLaunch([r], "waiting_prefill"))
    ex.execute(plan, view)
    assert ex.rows_free == 1
    with pytest.raises(RuntimeError, match="already holds state row"):
        ex.execute(plan, view)


def test_decode_without_the_engines_append_raises(granite):
    """A decode step whose request's cached count disagrees with the
    engine's allocation is refused, not run on a wrong position."""
    model = granite[0]
    ex, eng = _bound(model, {0: np.arange(5, dtype=np.int32)})
    r = Request(0, 0.0, 5, 4)
    eng.kv.allocate_prompt(0, 5)
    view = eng._view(Wake("arrival"))
    ex.execute(StepPlan(prefill=PrefillLaunch([r], "waiting_prefill")), view)
    r.tokens_generated = 1
    eng.kv.append_token(0)        # one token too many for the executor
    with pytest.raises(RuntimeError, match="tokens cached"):
        ex.execute(StepPlan(decode=DecodeLaunch([r])), view)


def test_serve_main_on_cpu(capsys):
    assert serve_mod.main(["--device", "cpu", "--dtype", "float32",
                           "--requests", "3", "--seed", "2"]) == 0
    out = capsys.readouterr().out
    assert '"pool_reclaimed": true' in out
    assert '"state_rows_reclaimed": true' in out
    assert '"tokens_met": true' in out


def test_serve_main_needs_gpu_unless_cpu_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--requests", "1"])
