"""The port's engine stack against the reference's, on the CPU.

* Perfmodel: the ``ModelConfig`` helpers, ``costs``, ``interference``,
  the batched array layer and ``build_decode_profile`` over a grid of
  operating points, bit for bit with ``TPU_V5E``.
* Engines: every record of ``tests/golden/engine_parity.json``, bit for
  bit, as ``tests/test_parity.py`` checks the reference.  The traces come
  from the reference's ``generate_trace`` and are converted to the port's
  ``Request`` field by field.
"""
import copy
import dataclasses
import json
import pathlib

import numpy as np
import pytest

from repro.config import SLOConfig as JaxSLOConfig
from repro.config import ServeConfig as JaxServeConfig
from repro.config import get_config as jax_config
from repro.core import resource_manager as jax_rm
from repro.core.request import Request as JaxRequest
from repro.perfmodel import batch as jax_B
from repro.perfmodel import costs as jax_C
from repro.perfmodel import interference as jax_I
from repro.perfmodel.hw import TPU_V5E as JAX_TPU_V5E
from repro.serving import TRACES, generate_trace
from repro_torch.config import SLOConfig, ServeConfig, get_config
from repro_torch.core import drive, make_engine
from repro_torch.core import resource_manager as rm
from repro_torch.core.engines import RapidEngine
from repro_torch.core.request import Request, State
from repro_torch.kvcache import KVCacheManager
from repro_torch.perfmodel import batch as B
from repro_torch.perfmodel import costs as C
from repro_torch.perfmodel import interference as I
from repro_torch.perfmodel.hw import H100, TPU_V5E

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden" /
                     "engine_parity.json").read_text())
ARCHS = ["granite-8b", "llama3-70b", "jamba-1.5-large-398b"]


def _cost(c):
    return None if c is None else (c.flops, c.hbm_bytes, c.coll_bytes)


# ---------------------------------------------------------------------------
# perfmodel
# ---------------------------------------------------------------------------


def test_hardware_specs():
    assert dataclasses.asdict(TPU_V5E) == dataclasses.asdict(JAX_TPU_V5E)
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes, H100.ici_bw,
            H100.dcn_bw) == (989e12, 3.35e12, 80 * 10 ** 9, 450e9, 50e9)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_helpers_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for name in ("param_count", "active_param_count"):
        assert getattr(cfg, name)() == getattr(jcfg, name)()
    assert cfg.attn_layer_count == jcfg.attn_layer_count
    assert cfg.sub_quadratic == jcfg.sub_quadratic
    for nbytes in (1, 2, 4):
        assert cfg.kv_bytes_per_token(nbytes) == \
            jcfg.kv_bytes_per_token(nbytes)
        assert cfg.state_bytes_per_seq(nbytes) == \
            jcfg.state_bytes_per_seq(nbytes)


def test_serve_config_matches_reference():
    assert dataclasses.asdict(ServeConfig()) == \
        dataclasses.asdict(JaxServeConfig())
    assert dataclasses.asdict(SLOConfig(itl_ms=50.0)) == \
        dataclasses.asdict(JaxSLOConfig(itl_ms=50.0))


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_and_interference_match_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    rng = np.random.default_rng(len(arch))
    assert C.weight_bytes(cfg) == jax_C.weight_bytes(jcfg)
    assert C.model_flops_per_token(cfg) == jax_C.model_flops_per_token(jcfg)
    for _ in range(40):
        tp = int(rng.choice([1, 2, 4, 8, 16]))
        seqs = [int(x) for x in rng.integers(0, 8192,
                                             size=rng.integers(1, 5))]
        bs = int(rng.integers(0, 200))
        ctx = float(bs * rng.integers(1, 8192))
        chunk, so_far = int(rng.integers(1, 2048)), int(rng.integers(0, 8192))
        assert C.kv_read_bytes(cfg, ctx) == jax_C.kv_read_bytes(jcfg, ctx)
        assert C.kv_transfer_bytes(cfg, seqs[0]) == \
            jax_C.kv_transfer_bytes(jcfg, seqs[0])
        pc = C.prefill_cost(cfg, seqs, tp)
        dc = C.decode_cost(cfg, bs, ctx, tp)
        cc = C.chunk_prefill_cost(cfg, chunk, so_far, tp)
        jpc = jax_C.prefill_cost(jcfg, seqs, tp)
        jdc = jax_C.decode_cost(jcfg, bs, ctx, tp)
        jcc = jax_C.chunk_prefill_cost(jcfg, chunk, so_far, tp)
        assert (_cost(pc), _cost(dc), _cost(cc)) == \
            (_cost(jpc), _cost(jdc), _cost(jcc))
        f = float(rng.choice([0.1, 0.3, 0.5, 0.9]))
        assert I.phase_time(pc, TPU_V5E, tp, f=f) == \
            jax_I.phase_time(jpc, JAX_TPU_V5E, tp, f=f)
        assert I.compute_utilization(dc, TPU_V5E, tp) == \
            jax_I.compute_utilization(jdc, JAX_TPU_V5E, tp)
        for f_d in (None, f):
            got = I.overlapped_times(pc, dc, TPU_V5E, tp, f_decode=f_d)
            want = jax_I.overlapped_times(jpc, jdc, JAX_TPU_V5E, tp,
                                          f_decode=f_d)
            assert dataclasses.astuple(got) == dataclasses.astuple(want)
            for colocated in (True, False):
                assert I.forecast_phase_times(
                    pc, dc, TPU_V5E, tp, tp, colocated=colocated,
                    f_decode=f_d) == jax_I.forecast_phase_times(
                    jpc, jdc, JAX_TPU_V5E, tp, tp, colocated=colocated,
                    f_decode=f_d)


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_layer_matches_reference(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    rng = np.random.default_rng(7 + len(arch))
    n = 32
    seqs = [[int(x) for x in rng.integers(0, 4096, size=rng.integers(1, 4))]
            for _ in range(n)]
    tp = rng.choice([1, 2, 4, 8], size=n)
    bs = [int(x) for x in rng.integers(0, 128, size=n)]
    ctx = [float(b * rng.integers(1, 4096)) for b in bs]
    chunk = [int(x) for x in rng.integers(1, 1024, size=n)]
    so_far = [int(x) for x in rng.integers(0, 4096, size=n)]
    got = [B.prefill_cost(cfg, seqs, tp), B.decode_cost(cfg, bs, ctx, tp),
           B.chunk_prefill_cost(cfg, chunk, so_far, tp)]
    want = [jax_B.prefill_cost(jcfg, seqs, tp),
            jax_B.decode_cost(jcfg, bs, ctx, tp),
            jax_B.chunk_prefill_cost(jcfg, chunk, so_far, tp)]
    for g, w in zip(got, want):
        for field in ("flops", "hbm_bytes", "coll_bytes"):
            assert np.array_equal(getattr(g, field), getattr(w, field))
    f = rng.choice([0.2, 0.5, 1.0], size=n)
    assert np.array_equal(B.phase_time(got[0], TPU_V5E, tp, f=f),
                          jax_B.phase_time(want[0], JAX_TPU_V5E, tp, f=f))
    f_d = np.where(rng.random(n) < 0.5, np.nan, 0.3)
    for colocated in (True, False):
        t = B.forecast_phase_times(got[0], got[1], TPU_V5E, tp, tp,
                                   colocated=colocated, f_decode=f_d)
        jt = jax_B.forecast_phase_times(want[0], want[1], JAX_TPU_V5E, tp,
                                        tp, colocated=colocated,
                                        f_decode=f_d)
        assert all(np.array_equal(a, b) for a, b in zip(t, jt))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("chips,slo_s,avg_ctx",
                         [(8, 0.1, 4096), (32, 0.05, 8192), (1, 0.02, 2048)])
def test_decode_profile_matches_reference(arch, chips, slo_s, avg_ctx):
    got = rm.build_decode_profile(get_config(arch), TPU_V5E, chips, slo_s,
                                  avg_ctx)
    want = jax_rm.build_decode_profile(jax_config(arch), JAX_TPU_V5E, chips,
                                       slo_s, avg_ctx)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    arm, jarm = rm.AdaptiveResourceManager(got), \
        jax_rm.AdaptiveResourceManager(want)
    for bs in (0, 1, 3, 16, 17, 100, 300):
        for active in (False, True):
            a, b = arm.allocate(bs, active), jarm.allocate(bs, active)
            assert (a.f_decode, a.mode) == (b.f_decode, b.mode)


# ---------------------------------------------------------------------------
# engines: the golden records
# ---------------------------------------------------------------------------


def _port_request(r: JaxRequest) -> Request:
    """The reference's ``Request`` as the port's, field by field."""
    kw = {f.name: copy.deepcopy(getattr(r, f.name))
          for f in dataclasses.fields(JaxRequest)}
    kw["state"] = State[r.state.name]
    return Request(**kw)


def _serve(mode, **kw):
    return ServeConfig(mode=mode, chips=32, slo=SLOConfig(itl_ms=100.0),
                       **kw)


# key -> (trace, qps, duration, seed, serve config, tiny pool)
POINTS = {
    "rapid/lmsys@6.0s3": ("lmsys", 6.0, 20.0, 3, _serve(
        "rapid", disagg_split=(16, 16), max_batch_slots=128), False),
    "rapid/arxiv@4.0s11": ("arxiv", 4.0, 15.0, 11, _serve(
        "rapid", disagg_split=(16, 16), max_batch_slots=128), False),
    "hybrid/lmsys@6.0s3": ("lmsys", 6.0, 20.0, 3, _serve(
        "hybrid", disagg_split=(16, 16), max_batch_slots=128), False),
    "hybrid/arxiv@4.0s11": ("arxiv", 4.0, 15.0, 11, _serve(
        "hybrid", disagg_split=(16, 16), max_batch_slots=128), False),
    "disagg/lmsys@6.0s3": ("lmsys", 6.0, 20.0, 3, _serve(
        "disagg", disagg_split=(16, 16), max_batch_slots=128), False),
    "disagg/arxiv@4.0s11": ("arxiv", 4.0, 15.0, 11, _serve(
        "disagg", disagg_split=(16, 16), max_batch_slots=128), False),
    "rapid/loogle-tinypool": ("loogle", 3.0, 15, 7, _serve(
        "rapid", max_batch_slots=8, max_seq_len=32768), True),
    "hybrid/loogle-tinypool": ("loogle", 3.0, 15, 7, _serve(
        "hybrid", max_batch_slots=32), True),
    "disagg/loogle-tinypool": ("loogle", 3.0, 15, 9, _serve(
        "disagg", disagg_split=(16, 16), max_batch_slots=128), True),
}


def test_every_golden_record_is_covered():
    assert set(POINTS) == set(GOLDEN)


@pytest.mark.parametrize("key", sorted(POINTS))
def test_engine_golden_parity(key):
    trace, qps, dur, seed, serve, tiny = POINTS[key]
    reqs = generate_trace(TRACES[trace], qps=qps, duration_s=dur, seed=seed)
    eng = make_engine(serve.mode, get_config("llama3-70b"), serve)
    if tiny:
        eng.kv = KVCacheManager(num_blocks=1500, page_size=16)
    recs, span = drive(eng, [_port_request(r) for r in reqs])
    golden = GOLDEN[key]
    assert span == golden["span"], f"{key}: span diverged"
    assert len(recs) == len(golden["records"])
    for rec, want in zip(recs, golden["records"]):
        got = dict(rid=rec.rid, ttft=rec.ttft, itl_p95=rec.itl_p95,
                   finish=rec.finish, output_len=rec.output_len,
                   preemptions=rec.preemptions, rejected=rec.rejected)
        assert got == want, f"{key}: rid {rec.rid} diverged"


def test_rapid_engine_on_h100_serves_the_smoke_traffic():
    """The perfmodel engine on ``H100``, one card, at the chip smoke's
    traffic shape (8 prompts of 128-2048 tokens, all at t = 0): request 0
    is prefilled alone, then joins decode while the other seven prefill,
    so exactly one plan holds a prefill and a decode."""
    cfg = get_config("granite-8b")
    serve = ServeConfig(mode="rapid", chips=1, max_batch_slots=4,
                        page_size=16)
    eng = RapidEngine(cfg, serve, H100)
    plans = []
    execute = eng.executor.execute
    eng.executor.execute = lambda p, v: plans.append(
        (p.prefill is not None, p.decode is not None)) or execute(p, v)
    lens = [1762, 1372, 1321, 939, 890, 1595, 473, 1833]
    reqs = [Request(i, 0.0, n, 16 + 5 * i) for i, n in enumerate(lens)]
    recs, _ = drive(eng, reqs)
    plans = [p for p in plans if any(p)]
    assert [r.output_len for r in recs] == [16 + 5 * i for i in range(8)]
    assert plans[:2] == [(True, False), (True, True)]
    assert plans.count((True, True)) == 1
    assert not any(r.preemptions or r.rejected for r in recs)
    assert eng.kv.allocator.free_count == eng.kv.allocator.num_blocks
