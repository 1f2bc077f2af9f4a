"""The port's online gateway on the CPU.

Part 1: the copied gateway, workers, clock, fault injector and metrics
against the reference's, bit for bit, on the reference's own scenarios
(``tests/test_gateway.py``, ``tests/test_gateway_churn.py``,
``tests/test_faults.py``): a multi-class trace, a crash with failover, a
drain and a rolling upgrade, heartbeat flaps, a slow consumer, a cancel,
checkpointed recovery and a lossy wire.  Each runs once through
``repro`` and once through ``repro_torch`` with ``TPU_V5E`` and the
perfmodel-priced engines (the gateway's default engine factory), and the
fleet's event stream, records, summary and health must be equal.

Part 2: the card path, on the CPU: RAPID workers whose engines a
``KernelExecutor`` runs (reduced granite-8b, float32, weights converted
from the reference's), built by ``launch/serve.py``'s ``make_gateway``.
Every request's greedy tokens must equal the reference's own greedy
loop, through a crash failover and through a backpressure pause with its
re-prefill, and through a pause whose worker dies before it resumes on
the other; a cancel must leave the pool, the state rows and the spare
pages reclaimed; the HTTP server on a real-time clock must stream every
token, each lane completing within 50 ms of its launch's end; and the
smoke's check of the TokenEvent stamps must hold, and fail when a launch
is waited for twice.
"""
import asyncio
import bisect
import functools
import json
import time

import jax
import numpy as np
import pytest
from test_torch_cluster import SIDES, both
from test_torch_executor import HW, _models
from test_torch_serve import _reference_greedy

from repro.models import transformer as jax_tf
from repro_torch.core.events import (CancelledEvent, FinishedEvent,
                                     PhaseEvent, TokenEvent)
from repro_torch.core.request import Request
from repro_torch.launch import serve as serve_mod
from repro_torch.serving.clock import RealTimeClock
from repro_torch.serving.gateway import GatewayPolicy
from repro_torch.serving.http import GatewayHTTPServer
from repro_torch.serving.sim import EventLoop

ARCH = "llama3-70b"

# ---------------------------------------------------------------------------
# part 1: parity with the reference's gateway
# ---------------------------------------------------------------------------


def _serve(S, chips=16, slots=64):
    return S.config.ServeConfig(
        mode="rapid", chips=chips, slo=S.config.SLOConfig(itl_ms=100.0),
        chunk_size=512, disagg_split=(chips // 2, chips // 2),
        max_batch_slots=slots)


def _gw(S, modes=("rapid", "rapid"), **kw):
    return S.serving.Gateway(S.config.get_config(ARCH), _serve(S),
                             modes=list(modes), **kw)


def _reqs(S, n, max_new, prompt=256, gap=0.01):
    return [S.core_request.Request(rid=i, arrival=gap * i, prompt_len=prompt,
                                   max_new_tokens=max_new)
            for i in range(n)]


def _capture(gw, reqs, seen):
    gw._expected += len(reqs)
    for r in reqs:
        def go(r=r):
            seen[r.rid] = []
            gw.submit(r, consumer=seen[r.rid].append)
        gw.clock.at(r.arrival, go)


def _result(gw, **extra):
    return dict(events=list(gw.stream.events()), records=gw.metrics.records,
                summary=gw.metrics_summary(), health=gw.health(),
                now=gw.clock.now, **extra)


def _multiclass(S, modes):
    gw = _gw(S, modes, session_affinity=True)
    reqs = S.serving_workloads.generate_multiclass_trace(
        qps=3.0, duration_s=8.0, seed=2)
    records, span = gw.serve_trace(reqs)
    return _result(gw, span=span)


def _crash(S, survivors):
    gw = _gw(S, ["rapid"] * (1 + survivors), router="round_robin")
    seen = {}
    _capture(gw, _reqs(S, 8, 300), seen)
    gw.clock.at(0.2, lambda: gw.kill_worker(0))
    gw.clock.run()
    return _result(gw, seen=seen)


def _flap(S, beats):
    gw = _gw(S, router="round_robin")
    gw.clock.at(0.3, lambda: gw.registry.workers[1].suppress_beats(beats))
    records, span = gw.serve_trace(_reqs(S, 6, 200, gap=0.02))
    return _result(gw, span=span, fenced=gw.registry.fenced_beats)


def _drain(S, kind):
    gw = _gw(S, router="round_robin")
    done = []
    if kind == "drain":
        seen = {}
        _capture(gw, _reqs(S, 8, 200), seen)
        gw.clock.at(0.3, lambda: gw.drain_worker(
            0, on_retired=lambda: done.append(gw.clock.now)))
        gw.clock.run()
        return _result(gw, seen=seen, done=done)
    gw.clock.at(0.3, lambda: gw.rolling_upgrade(
        on_done=lambda: done.append(gw.clock.now)))
    records, span = gw.serve_trace(_reqs(S, 10, 150))
    return _result(gw, span=span, done=done,
                   workers=sorted(gw.registry.workers))


def _slow_consumer(S):
    gw = _gw(S, ["rapid"], router="round_robin")
    R = S.core_request.Request
    fast = []
    gw._expected = 2
    hold = {}
    gw.clock.at(0.0, lambda: hold.setdefault("ch", gw.submit(
        R(rid=0, arrival=0.0, prompt_len=128, max_new_tokens=300))))
    gw.clock.at(0.0, lambda: gw.submit(
        R(rid=1, arrival=0.0, prompt_len=128, max_new_tokens=300),
        consumer=fast.append))
    drained = []

    def drain_loop():
        drained.extend(hold["ch"].drain())
        if not hold["ch"].done:
            gw.clock.after(0.01, drain_loop)

    gw.clock.at(3.0, drain_loop)
    gw.clock.run()
    return _result(gw, fast=fast, drained=drained)


def _cancel(S):
    gw = _gw(S, ["rapid"], router="round_robin",
             policy=S.serving.GatewayPolicy(checkpoint_interval=50))
    R = S.core_request.Request
    evs, other = [], []
    gw._expected = 2
    gw.clock.at(0.0, lambda: gw.submit(
        R(rid=0, arrival=0.0, prompt_len=128, max_new_tokens=400),
        consumer=evs.append))
    gw.clock.at(0.0, lambda: gw.submit(
        R(rid=1, arrival=0.0, prompt_len=128, max_new_tokens=400),
        consumer=other.append))
    gw.clock.at(4.0, lambda: gw.cancel(0, reason="client_cancel"))
    gw.clock.run()
    return _result(gw, evs=evs, other=other, again=gw.cancel(0))


def _checkpointed(S, interval):
    gw = _gw(S, router="round_robin",
             policy=S.serving.GatewayPolicy(checkpoint_interval=interval))
    evs = []
    r = S.core_request.Request(rid=0, arrival=0.0, prompt_len=256,
                               max_new_tokens=300)
    gw._expected = 1
    gw.clock.at(0.0, lambda: gw.submit(r, consumer=evs.append))
    gw.clock.at(3.0, lambda: gw.kill_worker(0))
    gw.clock.run()
    return _result(gw, evs=evs, resumes=gw.resumes,
                   replayed=gw.replayed_tokens)


def _injected(S, kind):
    F = S.serving_faults
    R = S.core_request.Request
    if kind == "storm":
        gw = _gw(S, ["rapid"] * 3, router="least_loaded")
        inj = F.FaultInjector(gw, F.FaultPlan.crash_storm(
            seed=7, workers=3, t0=0.5, t1=3.0, crashes=2)).arm()
        records, span = gw.serve_trace(_reqs(S, 12, 200, gap=0.1))
        return _result(gw, injected=inj.injected, span=span)
    gw = _gw(S, ["rapid"], router="round_robin")
    plan = {"wire": (F.Fault(kind="drop", t=0.5, rid=0, count=3),
                     F.Fault(kind="corrupt", t=1.0, rid=0, count=2)),
            "stall": (F.Fault(kind="stall", t=0.5, rid=0, duration=4.0),)
            }[kind]
    inj = F.FaultInjector(gw, F.FaultPlan(plan)).arm()
    evs = {0: [], 1: []}
    gw._expected = 2
    for rid in (0, 1):
        gw.clock.at(0.0, lambda rid=rid: gw.submit(
            R(rid=rid, arrival=0.0, prompt_len=128, max_new_tokens=300),
            consumer=evs[rid].append))
    gw.clock.run()
    return _result(gw, evs=evs, injected=inj.injected,
                   dropped=inj.dropped_lines, corrupted=inj.corrupted_lines)


@pytest.mark.parametrize("scenario,args", [
    (_multiclass, (("rapid", "rapid"),)),
    (_multiclass, (("rapid", "hybrid"),)),
    (_crash, (1,)), (_crash, (0,)),
    (_flap, (2,)), (_flap, (6,)),
    (_drain, ("drain",)), (_drain, ("rolling_upgrade",)),
    (_slow_consumer, ()), (_cancel, ()),
    (_checkpointed, (0,)), (_checkpointed, (25,)),
    (_injected, ("wire",)), (_injected, ("stall",)), (_injected, ("storm",)),
], ids=lambda a: a.__name__.strip("_") if callable(a) else
    "-".join(map(str, a)) or "-")
def test_gateway_matches_reference(scenario, args):
    out = both(scenario, *args)
    assert out["events"] and out["records"]


def test_channel_and_realtime_clock_alike():
    """The channel's dedupe and watermarks, and the real-time clock's
    bind/flush contract, on each package."""
    for S in SIDES.values():
        ch = S.serving.RequestChannel(0, capacity=4, resume_at=1)
        E = S.core_events.TokenEvent
        assert [ch.offer(E(0, 0.0, i)) for i in (0, 1, 1, 3, 2)] == \
            [True, True, False, False, True]
        assert ch.dup_tokens == 1 and ch.gap_tokens == 1
        clock = S.serving.RealTimeClock()
        fired = []
        clock.after(0.0, lambda: fired.append(clock.now))
        assert clock.now == 0.0 and not fired

        async def run(clock=clock):
            clock.bind(asyncio.get_running_loop())
            await asyncio.sleep(0.01)
        asyncio.run(run())
        assert len(fired) == 1 and fired[0] >= 0.0


# ---------------------------------------------------------------------------
# part 2: the card path, on the CPU
# ---------------------------------------------------------------------------

SEED = 3


@pytest.fixture(scope="module")
def granite():
    return _models("granite-8b")


def _greedy(granite, prompts, max_new):
    """The reference's greedy tokens for each rid's prompt."""
    model, params, jcfg = granite
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(p) + max_new[rid] for rid, p in prompts.items())
    return {rid: _reference_greedy(params, jcfg, step, p, max_new[rid],
                                   max_seq) for rid, p in prompts.items()}


def _gateway(model, workers=2, clock=None, **kw):
    prompts = serve_mod.SeededPrompts(model.cfg.vocab_size, SEED)
    gw = serve_mod.make_gateway(model, serve_mod.serve_config(), prompts,
                                clock=clock or EventLoop(), hw=HW,
                                workers=workers, router="round_robin", **kw)
    return gw, prompts


def _submit(gw, prompts, reqs, seen):
    gw._expected += len(reqs)
    for r in reqs:
        def go(r=r):
            prompts.add(r)
            seen[r.rid] = []
            gw.submit(r, consumer=seen[r.rid].append)
        gw.clock.at(r.arrival, go)


def _executors(gw):
    return {w.wid: w.engine.executor for w in gw.registry.workers.values()}


def _tokens_of(gw, rid):
    """A request's greedy tokens from the worker that finished it."""
    for w in gw.registry.workers.values():
        if any(r.rid == rid for r in w.engine.finished):
            return w.engine.executor.tokens[rid]
    raise KeyError(rid)


def _indices(evs):
    return [e.index for e in evs if isinstance(e, TokenEvent)]


def _reclaimed(w):
    ex, kv = w.engine.executor, w.engine.kv
    return (kv.num_requests == 0 and
            kv.allocator.free_count == kv.allocator.num_blocks and
            ex.rows_free == ex.state_rows and not ex._spare)


TRAFFIC = [(16, 12), (32, 9), (21, 14), (7, 5), (40, 10), (13, 8)]


def test_two_kernel_workers_give_the_reference_tokens(granite):
    model = granite[0]
    gw, prompts = _gateway(model)
    seen = {}
    reqs = [Request(rid=i, arrival=0.001 * i, prompt_len=n,
                    max_new_tokens=m) for i, (n, m) in enumerate(TRAFFIC)]
    _submit(gw, prompts, reqs, seen)
    gw.clock.run()
    want = _greedy(granite, {r.rid: prompts[r.rid] for r in reqs},
                   {r.rid: r.max_new_tokens for r in reqs})
    for r in reqs:
        assert isinstance(seen[r.rid][-1], FinishedEvent)
        assert _indices(seen[r.rid]) == list(range(r.max_new_tokens))
        assert _tokens_of(gw, r.rid) == want[r.rid], r.rid
    # both workers served, each through its own executor and pool
    assert all(len(w.replica.assigned) for w in gw.registry.workers.values())
    kinds = {e["kind"] for ex in _executors(gw).values() for e in ex.log}
    assert {"prefill", "decode", "fused"} <= kinds
    assert all(_reclaimed(w) for w in gw.registry.workers.values())


def _on(engine, pred, fn):
    """Call ``fn()`` once, on the clock after the engine event for which
    ``pred(ev)`` first holds (not inside the engine's own emit)."""
    state = {}

    def sub(ev):
        if not state and pred(ev):
            state["ev"] = ev
            engine.loop.after(0.0, fn)
    engine.subscribe(sub)
    return state


def _token(index, rid=None):
    return lambda ev: isinstance(ev, TokenEvent) and ev.index == index \
        and (rid is None or ev.rid == rid)


def _phase(name, rid):
    return lambda ev: isinstance(ev, PhaseEvent) and ev.phase == name \
        and ev.rid == rid


def test_crash_failover_gives_the_reference_tokens(granite):
    """Worker 0 dies mid-decode: its requests re-prefill from scratch on
    worker 1 (clones with their rids) and finish with the same tokens."""
    model = granite[0]
    gw, prompts = _gateway(model)
    seen = {}
    reqs = [Request(rid=i, arrival=0.0, prompt_len=n, max_new_tokens=40)
            for i, (n, _) in enumerate(TRAFFIC[:4])]
    _submit(gw, prompts, reqs, seen)
    w0 = gw.registry.workers[0]
    killed = _on(w0.engine, _token(3), lambda: gw.kill_worker(0))
    gw.clock.run()
    assert killed and w0.crashed
    want = _greedy(granite, {r.rid: prompts[r.rid] for r in reqs},
                   {r.rid: 40 for r in reqs})
    retried = 0
    for r in reqs:
        fin = seen[r.rid][-1]
        assert isinstance(fin, FinishedEvent), r.rid
        assert _indices(seen[r.rid]) == list(range(40))
        retried += fin.retries
        assert _tokens_of(gw, r.rid) == want[r.rid], r.rid
    assert retried == 2              # round robin put two on worker 0
    assert _reclaimed(gw.registry.workers[1])


def test_pause_and_reprefill_give_the_uninterrupted_tokens(granite):
    """A consumer that stops reading fills its channel (``stream_buffer``
    8): the gateway evicts its request mid-decode, and when the consumer
    drains, the request is prefilled again over its prompt and the tokens
    it had generated, and goes on to the tokens of an uninterrupted run."""
    model = granite[0]
    gw, prompts = _gateway(model, workers=1,
                           policy=GatewayPolicy(stream_buffer=8))
    slow = Request(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=30)
    fast = Request(rid=1, arrival=0.0, prompt_len=21, max_new_tokens=30)
    for r in (slow, fast):
        prompts.add(r)
    fast_evs, hold, drained = [], {}, []
    gw._expected = 2
    gw.clock.at(0.0, lambda: hold.setdefault("ch", gw.submit(slow)))
    gw.clock.at(0.0, lambda: gw.submit(fast, consumer=fast_evs.append))

    # the consumer wakes up once the fast request has finished, and from
    # then on reads each event of its request as it comes (on the virtual
    # clock a step lasts its measured time: a consumer polling at a fixed
    # period could fall behind again)
    w = gw.registry.workers[0]
    awake = []

    def read(ev):
        if ev.rid == 1 and isinstance(ev, FinishedEvent):
            awake.append(True)
        if awake and ev.rid in (0, 1):
            gw.clock.after(0.0, lambda: drained.extend(hold["ch"].drain()))

    w.engine.subscribe(read)
    gw.clock.run()
    fin = drained[-1]
    assert isinstance(fin, FinishedEvent) and fin.preemptions == 1
    assert _indices(drained) == list(range(30))
    assert isinstance(fast_evs[-1], FinishedEvent)
    assert fast_evs[-1].preemptions == 0
    ex = w.engine.executor
    resumed = [e for e in ex.log if e["resumed"]]
    assert len(resumed) == 1 and resumed[0]["rids"][0] == 0
    g = resumed[0]["resumed"]
    assert 1 < g < 30 and resumed[0]["prefill_tokens"] == 16 + g
    want = _greedy(granite, {0: prompts[0], 1: prompts[1]}, {0: 30, 1: 30})
    assert ex.tokens[0] == want[0]
    assert ex.tokens[1] == want[1]
    assert _reclaimed(w)


@pytest.mark.parametrize("pause_first", [False, True])
def test_cancel_reclaims_pool_rows_and_spares(granite, pause_first):
    """A request cancelled while its first decode step is in flight (or
    paused by the gateway's backpressure then, and cancelled after its
    eviction) leaves no KV block, state row or spare page held.  Its
    16-token prompt puts that step on a page boundary, so it holds a
    spare page until the next step; the eviction must give it back."""
    model = granite[0]
    gw, prompts = _gateway(model, workers=1)
    w = gw.registry.workers[0]
    ex = w.engine.executor
    r = Request(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=50)
    other = Request(rid=1, arrival=0.0, prompt_len=9, max_new_tokens=6)
    seen = {}
    _submit(gw, prompts, [r, other], seen)
    state = {}

    def held():
        return 0 in ex._spare, ex.rows_free

    def cancel():
        state["at_cancel"] = held()
        assert gw.cancel(0)

    def at_decode():
        state["at_decode"] = held()
        if pause_first:
            gw._channel_pause(0)          # the channel's backpressure
            _on(w.engine, _phase("preempted", 0), cancel)
        else:
            cancel()

    _on(w.engine, _phase("decode", 0), at_decode)
    gw.clock.run()
    spare, rows = state["at_decode"]
    assert spare and rows == ex.state_rows - 2
    if pause_first:
        assert gw._live.get(0) is None and seen[0][-2].phase == "preempted"
        assert state["at_cancel"] == (False, ex.state_rows - 1)
    assert isinstance(seen[0][-1], CancelledEvent)
    assert isinstance(seen[1][-1], FinishedEvent)
    assert ex.rows_free == ex.state_rows and not ex._spare
    assert _reclaimed(w)


def test_reprefill_extends_the_allocation_to_the_context(granite):
    """An evicted request resumed with 5 tokens generated is admitted and
    allocated for its 16 + 5 context tokens (the prompt's 16 alone the
    first time), is prefilled over them, and its next token is its
    token 5."""
    model = granite[0]
    gw, prompts = _gateway(model, workers=1)
    w = gw.registry.workers[0]
    ex = w.engine.executor
    r = Request(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=9)
    seen = {}
    _submit(gw, prompts, [r], seen)
    state, allocated = {}, []

    def on_alloc(ev):
        if _phase("kv_allocated", 0)(ev):
            allocated.append(w.engine.kv.tokens_of(0))

    def evict_and_resume():
        state["tokens"] = len(ex.tokens[0])
        state["evicted"] = w.evict(r)
        w.submit(r)

    w.engine.subscribe(on_alloc)
    _on(w.engine, _token(4), evict_and_resume)
    gw.clock.run()
    # the decode step in flight at the eviction made token 5, unsent
    assert state == {"tokens": 6, "evicted": True}
    assert allocated == [16, 21]
    pre = [e for e in ex.log if e["rids"][0] == 0 and e["kind"] != "decode"]
    assert [e["resumed"] for e in pre] == [0, 5]
    assert [e["prefill_tokens"] for e in pre] == [16, 21]
    want = _greedy(granite, {0: prompts[0]}, {0: 9})
    assert ex.tokens[0] == want[0]
    assert _indices(seen[0]) == list(range(9))
    assert _reclaimed(w)


def test_paused_request_resumes_on_another_worker(granite):
    """A request paused by its consumer (evicted from worker 0) whose
    worker then dies resumes on worker 1 when the consumer drains, after
    the gateway has seen the death: worker 1 prefills it again over the
    tokens worker 0 generated (the workers share one store of them) and
    it goes on to the reference's tokens.  (A request arriving later
    keeps the virtual clock's health ticks running until then.)"""
    model = granite[0]
    policy = GatewayPolicy(stream_buffer=8)
    gw, prompts = _gateway(model, policy=policy)
    slow = Request(rid=0, arrival=0.0, prompt_len=16, max_new_tokens=30)
    fast = Request(rid=1, arrival=0.0, prompt_len=21, max_new_tokens=30)
    late = Request(rid=2, arrival=5.0, prompt_len=9, max_new_tokens=4)
    for r in (slow, fast, late):
        prompts.add(r)
    fast_evs, hold, drained = [], {}, []
    gw._expected = 3
    gw.clock.at(0.0, lambda: hold.setdefault("ch", gw.submit(slow)))
    gw.clock.at(0.0, lambda: gw.submit(fast, consumer=fast_evs.append))
    gw.clock.at(5.0, lambda: gw.submit(late, consumer=lambda ev: None))
    w0, w1 = gw.registry.workers[0], gw.registry.workers[1]

    def drain():
        drained.extend(hold["ch"].drain())

    def kill():
        assert gw._live[0].worker is w0 and gw._live[1].worker is w1
        gw.kill_worker(0)
        # the consumer drains once the gateway has seen the worker die
        gw.clock.after(policy.heartbeat_timeout_s * 2, drain)

    _on(w0.engine, _phase("preempted", 0), kill)
    w1.engine.subscribe(
        lambda ev: drained and ev.rid == 0 and gw.clock.after(0.0, drain))
    gw.clock.run()
    assert w0.crashed
    fin = drained[-1]
    assert isinstance(fin, FinishedEvent) and fin.preemptions == 1
    assert fin.retries == 0                  # resumed, not a fresh clone
    assert _indices(drained) == list(range(30))
    assert isinstance(fast_evs[-1], FinishedEvent)
    resumed = [e for e in w1.engine.executor.log if e["resumed"]]
    assert len(resumed) == 1 and resumed[0]["rids"][0] == 0
    assert not [e for e in w0.engine.executor.log if e["resumed"]]
    want = _greedy(granite, {0: prompts[0], 1: prompts[1]}, {0: 30, 1: 30})
    assert _tokens_of(gw, 0) == want[0]
    assert _tokens_of(gw, 1) == want[1]
    assert _reclaimed(w1)


def test_prefix_and_checkpoints_are_refused(granite):
    model = granite[0]
    prompts = serve_mod.SeededPrompts(model.cfg.vocab_size, SEED)
    with pytest.raises(ValueError, match="ROADMAP A5"):
        prompts.add(Request(rid=0, arrival=0.0, prompt_len=20,
                            max_new_tokens=4, cached_prefix_len=8))
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        _gateway(model, policy=GatewayPolicy(checkpoint_interval=10))
    with pytest.raises(SystemExit):
        serve_mod.main(["--device", "cpu", "--serve", "http",
                        "--checkpoint-interval", "5"])
    np.testing.assert_array_equal(
        prompts[0] if 0 in prompts else serve_mod.prompt_tokens(
            model.cfg.vocab_size, SEED, 0, 20),
        np.random.default_rng((SEED, 0)).integers(
            0, model.cfg.vocab_size, size=20).astype(np.int32))


def test_models_with_mamba_layers_are_refused_online():
    """The online server refuses a model with Mamba layers at start-up,
    before it loads the model (each request would hold a state row that
    no admission bounds)."""
    cfg = serve_mod.get_reduced_config("jamba-1.5-large-398b")
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        serve_mod.check_online(cfg)
    serve_mod.check_online(serve_mod.get_reduced_config("granite-8b"))
    with pytest.raises(SystemExit):
        serve_mod.main(["--device", "cpu", "--serve", "http", "--arch",
                        "jamba-1.5-large-398b"])


def _post(port, path, body):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("POST" if body is not None else "GET", path,
                 body=json.dumps(body) if body is not None else None)
    return conn, conn.getresponse()


def test_http_server_streams_the_card_path(granite):
    """``GatewayHTTPServer`` on a real-time clock over one kernel worker:
    two streamed requests end ``finished`` with every token index once,
    their tokens are the reference's, a body with a cached prefix gets a
    400, and no lane completion fires later than its launch's end plus
    50 ms.  Each lane is due no later than its launch's end: a lane
    scheduled a launch's duration after the launch returned (on a real-
    time clock the launch has already taken it) would be due that much
    later, too little to pass 50 ms on these short launches."""
    model = granite[0]
    clock = RealTimeClock()
    gw, prompts = _gateway(model, workers=1, clock=clock)
    ex = _executors(gw)[0]
    lanes = []                       # (due, fired) of each lane completion
    at = clock.at

    def at_lane(t, fn):
        if "_apply" not in fn.__qualname__:
            return at(t, fn)

        def fire():
            lanes.append((t, clock.now))
            fn()
        return at(t, fire)

    clock.at = at_lane
    server = GatewayHTTPServer(gw, "127.0.0.1", 0, prompts=prompts)
    bodies = [{"prompt_len": 16, "max_new_tokens": 7},
              {"prompt_len": 23, "max_new_tokens": 5}]
    lines = {}

    offset = []

    async def main():
        await server.start()
        offset.append(clock.now - time.perf_counter())
        loop = asyncio.get_running_loop()

        def client(i):
            conn, resp = _post(server.port, "/v1/generate", bodies[i])
            lines[i] = [json.loads(x) for x in resp.read().splitlines()]
            conn.close()

        def refused():
            conn, resp = _post(server.port, "/v1/generate",
                               {"prompt_len": 20, "max_new_tokens": 3,
                                "cached_prefix_len": 4})
            out = (resp.status, json.loads(resp.read()))
            conn.close()
            return out

        jobs = [loop.run_in_executor(None, client, i) for i in (0, 1)]
        jobs.append(loop.run_in_executor(None, refused))
        out = await asyncio.gather(*jobs)
        await server.close()
        return out[-1]

    status, err = asyncio.run(asyncio.wait_for(main(), timeout=120))
    assert status == 400 and "ROADMAP A5" in err["error"]
    rids = {}
    for i, body in enumerate(bodies):
        toks = [x["index"] for x in lines[i] if x["type"] == "token"]
        assert lines[i][-1]["type"] == "finished"
        assert toks == list(range(body["max_new_tokens"]))
        rids[lines[i][-1]["rid"]] = body["max_new_tokens"]
    want = _greedy(granite, {rid: prompts[rid] for rid in rids}, rids)
    for rid in rids:
        assert ex.tokens[rid] == want[rid]
    # each lane completion is due by the end of the launch before it, and
    # fires within 50 ms of it (on the gateway's clock)
    ends = sorted(e["host_end"] + offset[0] for e in ex.log)
    assert len(lanes) >= len(ex.log)
    for due, fired in lanes:
        last = max(x for x in ends if x <= fired + 1e-6)
        assert due <= last + 1e-4, (due, last)
        assert fired - last < 0.05, (fired, last)
    assert _reclaimed(gw.registry.workers[0])


def test_http_writes_each_event_when_offered(granite):
    """A token's NDJSON line is written in the engine callback that
    offers it (a lane completion, in no task), not in a later step of the
    stream's own task, and the stream carries every token index once."""
    model = granite[0]
    clock = RealTimeClock()
    gw, prompts = _gateway(model, workers=1, clock=clock)
    server = GatewayHTTPServer(gw, "127.0.0.1", 0, prompts=prompts)
    writers = []

    def hook(line):
        if b'"token"' in line:
            writers.append(asyncio.current_task())
        return line
    server.line_hook = hook
    lines = []

    async def main():
        await server.start()

        def client():
            conn, resp = _post(server.port, "/v1/generate",
                               {"prompt_len": 16, "max_new_tokens": 9})
            lines.extend(json.loads(x) for x in resp.read().splitlines())
            conn.close()

        await asyncio.get_running_loop().run_in_executor(None, client)
        await server.close()

    asyncio.run(asyncio.wait_for(main(), timeout=120))
    assert [x["index"] for x in lines if x["type"] == "token"] == \
        list(range(9))
    assert lines[-1]["type"] == "finished" and len(writers) == 9
    assert sum(t is None for t in writers) >= 8
    assert _reclaimed(gw.registry.workers[0])


LAUNCH_S = 0.02         # each launch's least length in the stamp test


@pytest.mark.parametrize("lane_end", ["at_launch_end", "launch_waited_twice"])
def test_token_stamps_catch_a_launch_waited_twice(granite, lane_end):
    """``chip_smoke.py`` phase 9's checks of the TokenEvent stamps
    (``stamps_late``) and of the lanes' due times, on a real-time clock
    over one kernel worker whose launches each last at least 20 ms (about
    a card's replayed decode step): they hold for the engine as it is,
    and fail when each lane ends a launch's duration after the launch
    returned (``loop.after(duration)`` in place of ``loop.at(now +
    duration)``: the launch waited twice)."""
    model = granite[0]
    clock = RealTimeClock()
    gw, prompts = _gateway(model, workers=1, clock=clock)
    w = gw.registry.workers[0]
    ex = w.engine.executor
    launch = ex._launch

    def long_launch(kind, run, **info):
        def run_long():
            time.sleep(LAUNCH_S)
            return run()
        return launch(kind, run_long, **info)

    ex._launch = long_launch
    at, lanes = clock.at, []                  # (due, fired) of each lane

    def record(t, fn):
        if "_apply" not in fn.__qualname__:
            return at(t, fn)

        def fire():
            lanes.append((t, clock.now))
            fn()
        return at(t, fire)

    clock.at = record
    if lane_end == "launch_waited_twice":
        execute, began = ex.execute, []

        def timed(plan, view):
            began.append(view.now)
            return execute(plan, view)

        def after_launch(t, fn):
            if "_apply" in fn.__qualname__:        # a lane's end
                return record(clock.now + (t - began[-1]), fn)
            return record(t, fn)

        ex.execute, clock.at = timed, after_launch
    reqs = [Request(rid=i, arrival=0.05 * i, prompt_len=n, max_new_tokens=m)
            for i, (n, m) in enumerate([(16, 12), (21, 10), (9, 8)])]
    seen = {}

    def finished():
        return all(seen.get(r.rid) and isinstance(seen[r.rid][-1],
                                                  FinishedEvent)
                   for r in reqs)

    async def main():
        clock.bind(asyncio.get_running_loop())
        offset = clock.now - time.perf_counter()
        _submit(gw, prompts, reqs, seen)
        while not finished():
            await asyncio.sleep(0.01)
        return offset

    offset = asyncio.run(asyncio.wait_for(main(), timeout=120))
    for r in reqs:
        assert _indices(seen[r.rid]) == list(range(r.max_new_tokens))
    raw, net = serve_mod.token_stamp_lags(ex.log, w.engine.stream.events(),
                                          offset)
    assert len(raw) == sum(r.max_new_tokens for r in reqs)
    late = serve_mod.stamps_late(net)
    # how far each lane was due after the last launch's end before it
    # fired (phase 9 requires at most 0.1 ms)
    ends = sorted(e["host_end"] + offset for e in ex.log)
    due_after = [due - ends[bisect.bisect_right(ends, fired + 1e-6) - 1]
                 for due, fired in lanes]
    if lane_end == "at_launch_end":
        assert late is None, late
        assert max(due_after) <= 1e-4
    else:
        assert late is not None and \
            np.percentile(net, 99) > serve_mod.STAMP_P99_S
        assert np.median(net) >= LAUNCH_S
        assert max(due_after) >= LAUNCH_S


def test_http_server_needs_gpu_unless_cpu_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.main(["--serve", "http"])
