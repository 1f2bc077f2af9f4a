"""Disaggregated serving on the port, against the reference.

``DisaggEngine`` run by ``KernelExecutor`` over two KV pools on one card
(``OneCardServeConfig``): a request is prefilled into the prefill pool,
its pages are copied into staging (other pages of the prefill pool) when
its prefill is done, landed in the decode pool's blocks at its first
decode step, and its first token is recomputed there.  The checks wrap
the executor's methods from outside (``Watch``).  Held here on the CPU, in
float32, weights converted from the reference's ``init_model``:

  (a) greedy tokens identical to the reference's greedy decode, with
      prompts of whole pages and of whole pages plus one, a one-token
      request, and a decode pool small enough that transfers wait
      (``AdmitRetry``) while new prefills reuse the pages they left;
  (b) the same tokens as RAPID's;
  (c) each transfer: the staging equal to the prefill pool's pages bit
      for bit, the decode pool's pages after the join equal to it (the
      recomputed position within 3e-5), a wrong source page caught, and
      the join step's logits against the prefill's last position;
  (d) both pools, the staging and the state rows reclaimed, after a
      rejected transfer in flight too; the staging within the prefill
      pool while transfers wait, holding later prefills back;
  (e) the one-card split, and the reference's split of more chips;
  (f) what split pools refuse (ROADMAP A11);
  (g) ``launch/serve.py --mode disagg`` and ``--mode all``.

On the CPU the kernel wrappers compute their plain versions, so no launch
is counted.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from test_torch_executor import _models, _requests
from test_torch_serve import _reference_greedy

from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_config
from repro.core.scheduler import DisaggScheduler as JaxDisaggScheduler
from repro.models import transformer as jax_tf
from repro.perfmodel.hw import TPU_V5E as JAX_TPU_V5E
from repro_torch.config import (ServeConfig, get_config, get_reduced_config,
                                replace)
from repro_torch.core.engines import DisaggEngine, drive
from repro_torch.core.events import PhaseEvent
from repro_torch.core.executor import KernelExecutor
from repro_torch.core.request import Request, State
from repro_torch.core.scheduler import DisaggScheduler, kv_pool_blocks
from repro_torch.kernels import ops
from repro_torch.kvcache import kv_pages_for
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tf
from repro_torch.perfmodel.hw import H100, TPU_V5E

TOL = dict(atol=3e-5, rtol=3e-5)
HW = dataclasses.replace(H100, hbm_bytes=serve_mod.CPU_HBM_BYTES)
# the smallest pools the scheduler sizes: 64 blocks, 32 a side (512 tokens)
SMALL_HW = dataclasses.replace(HW, hbm_bytes=1 << 20)
# (prompt length, new tokens): 16 and 32 whole pages (page 16), 17 and 33
# one past them, and a request of one token
TRAFFIC = [(16, 9), (17, 12), (32, 7), (33, 5), (5, 1), (40, 6)]
# on SMALL_HW: the first four fill the 512-token decode pool as they
# grow, so later transfers wait for a finish while prefills go on
PRESSURE = [(120, 60), (130, 50), (110, 70), (100, 40), (90, 30), (16, 1),
            (70, 20)]


@pytest.fixture(scope="module")
def granite():
    return _models("granite-8b")


def _want(granite, reqs):
    """The reference's greedy tokens of ``reqs``, by rid."""
    _, params, jcfg = granite
    step = jax.jit(functools.partial(jax_tf.decode_forward, cfg=jcfg, tp=1))
    max_seq = max(len(r.prompt) + r.max_new for r in reqs)
    return {r.rid: _reference_greedy(params, jcfg, step, r.prompt,
                                     r.max_new, max_seq) for r in reqs}


def _reclaimed(eng, ex):
    return (not ex.staged and ex.rows_free == ex.state_rows and
            all(kv.num_requests == 0 and
                kv.allocator.free_count == kv.allocator.num_blocks
                for kv in (eng.kv, eng.kv_p)))


def _pages(cache, blocks):
    idx = torch.tensor(blocks, dtype=torch.int64)
    return [c[n].index_select(0, idx) for c in cache if "k" in c
            for n in "kv"]


def _landed_kv_is_the_contexts(model, eng, ex, prompt, rid):
    """After a join's step: the decode pool holds, at every position of
    the request's context, the K/V of a whole prefill of that context
    (the recomputed last position too), within TOL."""
    ctx = np.concatenate([prompt, ex.tokens[rid][:-1]]).astype(np.int32)
    n = len(ctx)
    _, aux = tf.forward(model, torch.from_numpy(ctx[None]),
                        torch.arange(n)[None], return_aux=True)
    rows = attn_mod.pool_rows(torch.tensor([eng.kv.blocks_of(rid)]),
                              torch.arange(n)[None], eng.serve.page_size)
    return all(torch.allclose(c[name].flatten(0, 1)[rows], a[name][0],
                              **TOL)
               for c, a in zip(ex.cache, aux) for name in ("k", "v"))


class Watch:
    """Checks of a split-pool ``KernelExecutor``'s transfers, made by
    wrapping its methods from outside.  ``found`` gets, in order,
    ("staged", rid, equal) after each transfer: its staging held bit for
    bit to the prefill-pool pages it was copied from (the manager's own
    block list, read past ``blocks_of``); and ("landed", rid, equal)
    after each join's decode launch: the decode pool's pages held to the
    staging, whose blocks nothing writes before a later plan's prefill,
    bit for bit but at the position the join's step wrote again
    (``context_len - 1``), within TOL.  ``logits`` gets per request the
    last-position logits of its prefill and of its join's step; ``after``
    is called as ``after(stage, rid)`` after each record."""

    def __init__(self, eng, ex, after=None):
        self.eng, self.ex, self.after = eng, ex, after
        self.found, self.logits = [], {}
        self.staged_from = {}
        real_t, real_d, real_p = ex.transfer_seconds, ex._decode, ex._prefill

        def transfer_seconds(r, serve):
            seconds = real_t(r, serve)
            src = eng.kv_p._seqs[r.rid].blocks
            self.staged_from[r.rid] = list(src)
            self._record("staged", r.rid, all(map(torch.equal, _pages(
                ex.cache_p, src), _pages(ex.cache_p, ex.staged[r.rid]))))
            return seconds

        def decode(batch, arm_f, kv):
            joins = [(i, r.rid, r.context_len - 1, list(ex.staged[r.rid]))
                     for i, r in enumerate(batch) if r.rid in ex.staged]
            wall = real_d(batch, arm_f, kv)
            for i, rid, n, staged in joins:
                self.logits.setdefault(rid, {})["join"] = \
                    ex.graphs.logits[i, -1].float().clone()
                self._record("landed", rid, self._landed(rid, n, staged))
            return wall

        def prefill(r, kv):
            forward = tf.forward

            def last(*args, **kw):
                logits, aux = forward(*args, **kw)
                self.logits.setdefault(r.rid, {})["prefill"] = \
                    logits[0, -1].float().clone()
                return logits, aux
            tf.forward = last
            try:
                return real_p(r, kv)
            finally:
                tf.forward = forward

        ex.transfer_seconds, ex._decode, ex._prefill = \
            transfer_seconds, decode, prefill

    def _record(self, stage, rid, ok):
        self.found.append((stage, rid, ok))
        if self.after is not None:
            self.after(stage, rid)

    def _landed(self, rid, n, staged):
        page = self.eng.serve.page_size
        blocks = self.eng.kv._seqs[rid].blocks[:len(staged)]
        ok = True
        for got, want in zip(_pages(self.ex.cache, blocks),
                             _pages(self.ex.cache_p, staged)):
            torch.testing.assert_close(got[n // page, n % page],
                                       want[n // page, n % page], **TOL)
            got[n // page, n % page] = want[n // page, n % page]
            ok &= torch.equal(got, want)
        return ok


def _run(model, reqs, hw=HW, plant=None, after=None, engine_hook=None):
    """Serve ``reqs`` through ``DisaggEngine`` + ``KernelExecutor`` on
    the one-card split, its transfers watched (``Watch``)."""
    serve = serve_mod.serve_config(mode="disagg")
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in reqs},
                        serve=serve, device="cpu", hw=hw,
                        state_rows=len(reqs))
    eng = DisaggEngine(model.cfg, serve, hw, executor=ex)
    ex.bind(eng)
    watch = Watch(eng, ex, after)
    if plant is not None:
        plant(eng)
    if engine_hook is not None:
        engine_hook(eng, ex)
    drive(eng, [Request(r.rid, 0.0, len(r.prompt), r.max_new)
                for r in reqs])
    return eng, ex, watch


# ---------------------------------------------------------------------------
# (a), (b) tokens
# ---------------------------------------------------------------------------


def test_disagg_tokens_match_reference_and_rapid(granite):
    """``serve_engine --mode disagg`` gives the reference's greedy tokens
    and RAPID's, with no fused step and a transfer for every request."""
    model = granite[0]
    reqs = _requests(model.cfg, TRAFFIC)
    ops.reset_launches()
    result = serve_mod.serve_engine(
        model, reqs, serve_mod.serve_config(mode="disagg"), hw=HW)
    assert ops.launches() == {k: 0 for k in ops.launches()}   # CPU: plain
    s = serve_mod.summarize(result)
    assert s["tokens_met"] and s["pool_reclaimed"] and \
        s["state_rows_reclaimed"]
    assert s["preemptions"] == 0 and s["rejected"] == 0
    assert set(s["launches"]) == {"prefill", "transfer", "decode"}
    assert s["transfers"]["count"] == len(reqs)
    assert s["transfers"]["tokens"] == sum(n for n, _ in TRAFFIC)
    want = _want(granite, reqs)
    for r in reqs:
        assert result["tokens"][r.rid] == want[r.rid], r.rid
    rapid = serve_mod.serve_engine(model, reqs, serve_mod.serve_config(),
                                   hw=HW)
    assert rapid["tokens"] == result["tokens"]
    assert [rec.output_len for rec in result["records"]] == \
        [n for _, n in TRAFFIC]


def _pressure(model, reqs):
    """The PRESSURE run on SMALL_HW, watched: the order of prefill-pool
    allocations, stagings and landings; each landing's check of the
    decode pool against the context's K/V; the transfers that waited
    (``AdmitRetry``); and at each plan the prefill pool's blocks staged,
    held by requests and free, and whether a waiting prefill was held
    back that would have fitted without the staging."""
    order, alloc, landed, retries, plans = [], [], [], [], []
    box = []

    def after(stage, rid):
        order.append((stage, rid))
        if stage == "landed":
            eng, ex = box
            landed.append((rid, _landed_kv_is_the_contexts(
                model, eng, ex, reqs[rid].prompt, rid)))

    def hook(eng, ex):
        box[:] = [eng, ex]
        real_alloc = eng.kv_p.allocate_prompt
        real_schedule = eng.scheduler.schedule

        def allocate(rid, n, **kw):
            got = real_alloc(rid, n, **kw)
            alloc.append((rid, list(eng.kv_p.blocks_of(rid))))
            order.append(("prefill_alloc", rid))
            return got

        def schedule(view):
            plan = real_schedule(view)
            retries.extend(a.request.rid for a in plan.retries)
            staged = sum(map(len, ex.staged.values()))
            alloc_p = eng.kv_p.allocator
            head = next(iter(view.queues["waiting_prefill"]), None)
            need = None if head is None else 2 * kv_pages_for(
                eng.scheduler.kv_tokens(head), eng.serve.page_size)
            plans.append(dict(
                staged=staged, free=alloc_p.free_count,
                total=alloc_p.num_blocks,
                held=sum(eng.kv_p.blocks_of(rid).__len__()
                         for rid in eng.kv_p._seqs),
                held_back=(head is not None and plan.prefill is None and
                           not view.lanes["prefill"].busy and
                           alloc_p.free_count < need <=
                           alloc_p.free_count + staged)))
            return plan

        eng.kv_p.allocate_prompt = allocate
        eng.scheduler.schedule = schedule

    eng, ex, watch = _run(model, reqs, SMALL_HW, after=after,
                          engine_hook=hook)
    return eng, ex, watch, order, alloc, landed, retries, plans


def test_transfers_wait_while_prefills_reuse_their_pages(granite):
    """On the smallest pools a transfer waits for the decode pool
    (``AdmitRetry``) while later prefills are given the prefill-pool
    pages it left; it lands from its staging all the same.  The decode
    pool also runs out as requests grow, and its victims are prefilled
    again over their context.  Every request's tokens are the
    reference's."""
    model = granite[0]
    reqs = _requests(model.cfg, PRESSURE)
    eng, ex, watch, order, alloc, landed, retries, _ = _pressure(model,
                                                                 reqs)
    assert eng.kv.allocator.num_blocks == eng.kv_p.allocator.num_blocks == 32
    assert retries, "no transfer waited for the decode pool"
    # a transfer that waited saw its source pages given to a later prefill
    # before it landed
    reused = []
    for rid in set(retries):
        start = order.index(("staged", rid))
        end = order.index(("landed", rid))
        between = {r for kind, r in order[start:end] if kind ==
                   "prefill_alloc"}
        for other, blocks in alloc:
            if other in between and \
                    set(blocks) & set(watch.staged_from[rid]):
                reused.append((rid, other))
    assert reused, "no prefill reused a waiting transfer's pages"
    # every landed request's decode-pool K/V is its context's
    assert len(landed) == sum(k == "staged" for k, _ in order)
    assert all(ok for _, ok in landed), landed
    assert all(ok for _, _, ok in watch.found), watch.found
    # the decode pool also evicted requests as they grew: each came back
    # through the prefill pool over its prompt and generated tokens
    assert any(e["resumed"] for e in ex.log if e["kind"] == "prefill")
    assert _reclaimed(eng, ex)
    want = _want(granite, reqs)
    for r in reqs:
        assert ex.tokens[r.rid] == want[r.rid], r.rid


def test_staging_stays_in_the_prefill_pool_while_transfers_wait(granite):
    """Staging takes no memory beyond the two pools: its pages are the
    prefill pool's, counted by its allocator, so at every plan the staged
    pages and the requests' pages together fit the pool.  While transfers
    wait for the decode pool their staging holds later prefills back
    (a prefill that would fit without it waits), instead of growing."""
    model = granite[0]
    reqs = _requests(model.cfg, PRESSURE)
    eng, ex, _, _, _, _, retries, plans = _pressure(model, reqs)
    before = ex.pool_bytes
    assert retries
    for p in plans:
        assert p["staged"] + p["held"] + p["free"] == p["total"], p
    assert max(p["staged"] for p in plans) > 0
    assert any(p["held_back"] for p in plans), \
        "no prefill waited for a staging to be released"
    assert ex.pool_bytes == before == sum(
        t.numel() * t.element_size() for c in ex.cache + ex.cache_p
        for t in c.values())
    assert _reclaimed(eng, ex)


def test_lanes_and_transfers_take_turns_on_the_engine_clock(granite):
    """The card runs one launch or transfer at a time: on the engine's
    clock each starts after the one before it ends (a transfer charged its
    measured ``ms``), and every request's first token comes after its
    transfer, from the step it joined."""
    model = granite[0]
    result = serve_mod.serve_engine(model, _requests(model.cfg, TRAFFIC),
                                    serve_mod.serve_config(mode="disagg"),
                                    hw=HW)
    log = result["log"]

    def end(e):
        return e["t_start"] + (e["ms"] / 1e3 if e["kind"] == "transfer"
                               else e["wall_s"])

    for a, b in zip(log, log[1:]):
        assert b["t_start"] >= end(a) - 1e-12
    for r in result["requests"]:
        xfer = next(e for e in log if e["kind"] == "transfer" and
                    e["rids"] == [r.rid])
        join = next(e for e in log if r.rid in e.get("joins", ()))
        assert join["t_start"] >= end(xfer) - 1e-12
        assert r.token_times[0] == pytest.approx(end(join))


# ---------------------------------------------------------------------------
# (c) the transfer
# ---------------------------------------------------------------------------


def test_staged_and_landed_pages_equal_the_source(granite):
    model = granite[0]
    reqs = _requests(model.cfg, TRAFFIC)
    eng, ex, watch = _run(model, reqs)
    found, logits = watch.found, watch.logits
    assert sorted((s, r) for s, r, _ in found) == sorted(
        (s, r.rid) for r in reqs for s in ("staged", "landed"))
    assert all(ok for _, _, ok in found), found
    # the join's step recomputes the prefill's last-position logits
    assert set(logits) == {r.rid for r in reqs}
    for rid, got in logits.items():
        torch.testing.assert_close(got["join"], got["prefill"], atol=1e-4,
                                   rtol=1e-4)
    for e in ex.log:
        if e["kind"] == "transfer":
            n = e["tokens"]
            assert e["pages"] == -(-n // eng.serve.page_size)
            assert e["bytes"] == sum(t.numel() * t.element_size() for t in
                                     _pages(ex.cache_p,
                                            list(range(e["pages"]))))
    assert _reclaimed(eng, ex)


def test_a_wrong_source_page_is_caught(granite):
    """Plant one wrong page in the block list the transfer copies from:
    the staging check fails for that request."""
    model = granite[0]
    reqs = _requests(model.cfg, [(40, 3), (24, 2)])

    def plant(eng):
        real = eng.kv_p.blocks_of

        def wrong(rid):
            blocks = real(rid)
            if rid == 0:
                blocks[1] = max(blocks) + 1
            return blocks
        eng.kv_p.blocks_of = wrong

    _, _, watch = _run(model, reqs, plant=plant)
    assert ("staged", 0, False) in watch.found
    assert ("staged", 1, True) in watch.found


# ---------------------------------------------------------------------------
# (d) reclaimed
# ---------------------------------------------------------------------------


def test_a_rejected_transfer_in_flight_is_reclaimed(granite):
    """A transfer the decode side rejects (its lifetime grown past the
    decode pool while in flight) releases its staging and its state row;
    the others are served and everything ends reclaimed."""
    model = granite[0]
    reqs = _requests(model.cfg, [(20, 4), (30, 3), (25, 5)])
    box = []

    def grow(ev):
        if isinstance(ev, PhaseEvent) and ev.phase == "transfer" and \
                ev.rid == 1:
            r = next(x for x in box[0]._all if x.rid == 1)
            r.max_new_tokens = 10 ** 7
            assert 1 in box[1].staged and 1 in box[1]._row_of

    serve = serve_mod.serve_config(mode="disagg")
    ex = KernelExecutor(model, prompts={r.rid: r.prompt for r in reqs},
                        serve=serve, device="cpu", hw=HW,
                        state_rows=len(reqs))
    eng = DisaggEngine(model.cfg, serve, HW, executor=ex)
    ex.bind(eng)
    box[:] = [eng, ex]
    eng.subscribe(grow)
    drive(eng, [Request(r.rid, 0.0, len(r.prompt), r.max_new)
                for r in reqs])
    assert [r.rid for r in eng.rejected] == [1]
    assert eng.rejected[0].state == State.REJECTED
    assert sorted(r.rid for r in eng.finished) == [0, 2]
    assert _reclaimed(eng, ex)


# ---------------------------------------------------------------------------
# (e) the split
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["granite-8b", "llama3-70b"])
def test_one_card_split_halves_the_colocated_pool(arch):
    cfg = get_config(arch) if arch == "granite-8b" else \
        replace(get_config(arch), num_layers=38)
    serve = serve_mod.serve_config(mode="disagg")
    pools = DisaggScheduler(cfg, serve, H100).pool_blocks(cfg, serve, H100)
    whole = kv_pool_blocks(cfg, H100, 1, serve.page_size,
                           serve.kv_reserve_frac)
    assert pools["decode"] == pools["prefill"]
    assert abs(2 * pools["decode"] - whole) <= 1
    if arch == "granite-8b":
        assert (whole, pools["decode"]) == (25_386, 12_693)
    sched = DisaggScheduler(cfg, serve, H100)
    assert sched.lane_chips(serve) == {"prefill": 1, "decode": 1}


@pytest.mark.parametrize("chips,split", [(2, (1, 1)), (8, (4, 4)),
                                         (32, (12, 20)), (1, (1, 2)),
                                         (1, (1, 1))])
def test_other_splits_are_the_references(chips, split):
    """Only the launcher's ``OneCardServeConfig`` is the one-card form;
    a ``ServeConfig`` of any split, (1, 1) on one chip too, sizes each
    pool on its own chips, as the reference does."""
    serve = ServeConfig(mode="disagg", chips=chips, disagg_split=split)
    jserve = JaxServeConfig(mode="disagg", chips=chips, disagg_split=split)
    cfg, jcfg = get_config("granite-8b"), jax_config("granite-8b")
    got = DisaggScheduler(cfg, serve, TPU_V5E).pool_blocks(cfg, serve,
                                                           TPU_V5E)
    want = JaxDisaggScheduler(jcfg, jserve, JAX_TPU_V5E).pool_blocks(
        jcfg, jserve, JAX_TPU_V5E)
    assert got == want


def test_a_one_chip_disagg_replica_of_a_fleet_is_the_references():
    """The cluster turns ``ReplicaSpec("disagg", chips=1)`` into
    ``chips`` 1 with ``disagg_split`` (1, 1): its pools, and its lanes'
    chips after a resize, are the reference's, not the one-card form."""
    from repro.serving.cluster import Cluster as JaxCluster
    from repro.serving.cluster import ReplicaSpec as JaxSpec
    from repro_torch.serving.cluster import Cluster, ReplicaSpec
    from repro.config import get_reduced_config as jax_reduced

    def pools(cluster):
        eng = cluster.replicas[0].engine
        return (eng.kv.allocator.num_blocks, eng.kv_p.allocator.num_blocks,
                eng.scheduler.lane_chips(eng.serve))

    got = Cluster(get_reduced_config("granite-8b"), ServeConfig(),
                  [ReplicaSpec("disagg", chips=1)], hw=TPU_V5E)
    want = JaxCluster(jax_reduced("granite-8b"), JaxServeConfig(),
                      [JaxSpec("disagg", chips=1)], hw=JAX_TPU_V5E)
    assert not isinstance(got.replicas[0].serve,
                          serve_mod.OneCardServeConfig)
    assert pools(got) == pools(want)
    for c in (got, want):
        c.replicas[0].engine.resize_lane("decode", 2)
    assert pools(got) == pools(want)


# ---------------------------------------------------------------------------
# (f) what it refuses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,kw", [
    ("jamba-1.5-large-398b", dict(ffn_pattern=("dense",))),
    ("mixtral-8x7b", {})])
def test_recurrent_and_windowed_models_refused_at_bind(arch, kw):
    cfg = replace(get_reduced_config(arch), dtype="float32", **kw)
    model = tf.init_model(cfg, device="cpu", seed=0)
    serve = serve_mod.serve_config(mode="disagg")
    ex = KernelExecutor(model, prompts={}, serve=serve, device="cpu", hw=HW)
    eng = DisaggEngine(cfg, serve, HW, executor=ex)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        ex.bind(eng)
    assert ex.cache is None and ex.cache_p is None    # nothing allocated
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        serve_mod.main(["--device", "cpu", "--dtype", "float32", "--mode",
                        "disagg", "--arch", arch])


def test_split_pools_of_their_own_chips_refused_at_bind(granite):
    """A split-pool engine of a plain ``ServeConfig`` (the reference's
    pools, a chip group each) is not run on one card (ROADMAP A11)."""
    model = granite[0]
    serve = dataclasses.replace(ServeConfig(mode="disagg", chips=2,
                                            disagg_split=(1, 1)),
                                max_batch_slots=4, page_size=16)
    ex = KernelExecutor(model, prompts={}, serve=serve, device="cpu", hw=HW)
    eng = DisaggEngine(model.cfg, serve, HW, executor=ex)
    with pytest.raises(NotImplementedError, match="ROADMAP A11"):
        ex.bind(eng)
    assert ex.cache is None and ex.cache_p is None


def test_price_batch_still_raises(granite):
    model = granite[0]
    serve = serve_mod.serve_config(mode="disagg")
    ex = KernelExecutor(model, prompts={}, serve=serve, device="cpu", hw=HW)
    eng = DisaggEngine(model.cfg, serve, HW, executor=ex)
    ex.bind(eng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ex.price_batch([], [])


# ---------------------------------------------------------------------------
# (g) the CLI
# ---------------------------------------------------------------------------


def test_serve_main_disagg_on_cpu(capsys):
    assert serve_mod.main(["--device", "cpu", "--dtype", "float32",
                           "--mode", "disagg", "--requests", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    assert '"transfer": 3' in lines[0] and '"tokens_met": true' in lines[0]


def test_serve_main_all_on_cpu(capsys):
    assert serve_mod.main(["--device", "cpu", "--dtype", "float32",
                           "--mode", "all", "--requests", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split()[0] for ln in lines[-4:-1]] == ["rapid", "hybrid",
                                                      "disagg"]
    for ln in lines[-4:-1]:
        for key in ("thpt=", "goodput=", "ttft_p95=", "itl_p95=",
                    "slo_ok="):
            assert key in ln
    assert lines[-1].startswith('{"rapid": ')
