"""The port's copy of the cluster layer (``serving/cluster.py``,
``serving/admission.py``) against the reference's, bit for bit.

Each scenario is one of the reference's own (``tests/test_cluster.py``,
``tests/test_admission.py``): it runs once through ``repro`` and once
through ``repro_torch`` on the CPU, with ``TPU_V5E`` and the perfmodel-
priced engines, and every record, request and summary must be equal.
Floats are compared through ``repr``, so equal means bit-identical (and
a NaN equals a NaN).
"""
import copy
import dataclasses
import enum
import importlib
import types

import pytest

ARCH = "llama3-70b"
MODULES = ("config", "core", "core.engines", "core.request", "core.events",
           "kvcache", "serving", "serving.cluster", "serving.gateway",
           "serving.faults", "serving.workloads", "serving.metrics",
           "serving.admission")


def side(pkg: str) -> types.SimpleNamespace:
    """The modules of one package (``repro`` or ``repro_torch``) a
    scenario uses, by their name inside the package."""
    return types.SimpleNamespace(**{
        m.replace(".", "_"): importlib.import_module(f"{pkg}.{m}")
        for m in MODULES})


SIDES = {"repro": side("repro"), "repro_torch": side("repro_torch")}


def canon(x):
    """A comparable form of ``x``: dataclasses by type name and fields,
    enums by value, floats by ``repr``."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [type(x).__name__,
                {f.name: canon(getattr(x, f.name))
                 for f in dataclasses.fields(x)}]
    if isinstance(x, enum.Enum):
        return x.value
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set, frozenset)):
        return [canon(v) for v in (sorted(x) if isinstance(
            x, (set, frozenset)) else x)]
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, (int, str, bool, type(None))):
        return x
    return repr(type(x).__name__)


def both(scenario, *args):
    """Run ``scenario(S, *args)`` on each package; they must agree."""
    got = {pkg: canon(scenario(S, *args)) for pkg, S in SIDES.items()}
    assert got["repro_torch"] == got["repro"]
    return got["repro"]


def serve(S, mode="rapid", chips=32, slots=128):
    return S.config.ServeConfig(
        mode=mode, chips=chips, slo=S.config.SLOConfig(itl_ms=100.0),
        disagg_split=(chips // 2, chips // 2), max_batch_slots=slots)


def trace(S, qps=6.0, duration=20.0, seed=0, name="lmsys"):
    return S.serving.generate_trace(S.serving.TRACES[name], qps=qps,
                                    duration_s=duration, seed=seed)


def skewed_trace(S, bursts=3, smalls=120):
    R = S.core_request.Request
    reqs, rid, t = [], 0, 0.0
    for _ in range(bursts):
        reqs.append(R(rid=rid, arrival=t, prompt_len=16_000,
                      max_new_tokens=64))
        rid += 1
        for j in range(smalls):
            reqs.append(R(rid=rid, arrival=t + 0.005 * (j + 1),
                          prompt_len=64, max_new_tokens=16))
            rid += 1
        t += 5.0
    return reqs


def cluster_result(cluster, recs, span, reqs):
    return {"records": recs, "span": span,
            "per_replica": cluster.per_replica_records(),
            "counts": cluster.per_replica_counts(),
            "requests": reqs,
            "scale_events": list(getattr(cluster, "_scale_events", [])),
            "admission": dict(cluster.admission.stats)
            if cluster.admission is not None else None}


def _mixed_fleet(S, router):
    cfg = S.config.get_config(ARCH)
    reqs = [copy.deepcopy(r) for r in trace(S, qps=4.0, duration=15.0)]
    cluster = S.serving.Cluster(cfg, serve(S), ["rapid", "hybrid", "disagg"],
                                router=router)
    recs, span = cluster.run(reqs)
    return cluster_result(cluster, recs, span, reqs)


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "slo_aware", "bucketed"])
def test_mixed_fleet_under_each_router(router):
    out = both(_mixed_fleet, router)
    assert len(out["counts"]) == 3


def _single_replica(S, mode):
    cfg = S.config.get_config(ARCH)
    reqs = trace(S)
    eng = S.core.make_engine(mode, cfg, serve(S, mode))
    bare = S.core.drive(eng, [copy.deepcopy(r) for r in reqs])
    cluster = S.serving.Cluster(cfg, serve(S, mode), [mode],
                                router="round_robin")
    return {"bare": bare,
            "cluster": cluster.run([copy.deepcopy(r) for r in reqs])}


@pytest.mark.parametrize("mode", ["rapid", "hybrid", "disagg"])
def test_single_replica_cluster(mode):
    out = both(_single_replica, mode)
    assert out["bare"] == out["cluster"]


def _skewed(S, router):
    cfg = S.config.get_config(ARCH)
    reqs = skewed_trace(S, 2, 60)
    cluster = S.serving.Cluster(cfg, serve(S), ["rapid"] * 2, router=router)
    recs, span = cluster.run([copy.deepcopy(r) for r in reqs])
    return cluster_result(cluster, recs, span, reqs)


@pytest.mark.parametrize("router", ["round_robin", "least_loaded",
                                    "slo_aware"])
def test_skewed_trace_two_replicas(router):
    both(_skewed, router)


def _autoscaler(S, kind):
    cfg = S.config.get_config(ARCH)
    if kind == "reactive":
        reqs = trace(S, qps=24.0, duration=20.0)
        policy = S.serving.ScalePolicy(min_replicas=1, max_replicas=3,
                                       check_interval_s=2.0, window_s=5.0)
        modes = ["rapid"]
    else:
        reqs = trace(S, qps=16.0, duration=15.0)
        policy = S.serving.ProjectionPolicy(min_replicas=1, max_replicas=3)
        modes = S.serving.parse_mix("disagg:1x12+20")
    out, cluster = S.serving.run_fleet(cfg, serve(S), modes, "least_loaded",
                                       reqs, scale=policy)
    return {"summary": out, "events": list(cluster._scale_events),
            "replicas": cluster.num_replicas}


@pytest.mark.parametrize("kind", ["reactive", "projection"])
def test_autoscaler(kind):
    out = both(_autoscaler, kind)
    assert out["events"]


def _shrink_pools(S, cluster, blocks, page=16):
    for rep in cluster.replicas:
        rep.engine.kv = S.kvcache.KVCacheManager(blocks, page)
        if getattr(rep.engine, "kv_p", None) is not None:
            rep.engine.kv_p = S.kvcache.KVCacheManager(blocks, page)


def _admission(S, case):
    cfg = S.config.get_config(ARCH)
    R = S.core_request.Request
    P = S.serving.AdmissionPolicy
    if case == "queue_then_serve":
        policy = P(kv_headroom=0.9, projected_output_frac=1.0, retry_s=0.1)
        modes, blocks = ["rapid"] * 2, 200
        reqs = [R(rid=i, arrival=0.0, prompt_len=1000, max_new_tokens=50)
                for i in range(10)]
    elif case == "infeasible":
        policy, modes, blocks = P(), ["rapid"] * 2, 100
        reqs = [R(rid=0, arrival=0.0, prompt_len=5000, max_new_tokens=8),
                R(rid=1, arrival=0.0, prompt_len=256, max_new_tokens=8)]
    else:
        policy = P(kv_headroom=0.9, projected_output_frac=1.0, retry_s=0.2,
                   max_wait_s=1.0)
        modes, blocks = ["rapid"], 100
        reqs = [R(rid=0, arrival=0.0, prompt_len=800, max_new_tokens=300),
                R(rid=1, arrival=0.1, prompt_len=1200, max_new_tokens=8)]
    cluster = S.serving.Cluster(cfg, serve(S), modes, router="least_loaded",
                                admission=policy)
    _shrink_pools(S, cluster, blocks)
    recs, span = cluster.run(reqs)
    return cluster_result(cluster, recs, span, reqs)


@pytest.mark.parametrize("case", ["queue_then_serve", "infeasible",
                                  "timeout"])
def test_admission(case):
    out = both(_admission, case)
    assert sum(out["admission"].values()) > 0


def _rebalance(S):
    cfg = S.config.get_config(ARCH)
    reqs = skewed_trace(S, 2, 40)
    out, cluster = S.serving.run_fleet(
        cfg, serve(S), ["rapid"] * 2, "round_robin", reqs,
        rebalance=S.serving.RebalancePolicy(),
        admission=S.serving.AdmissionPolicy())
    return {"summary": out, "migrations": cluster._migrations}


def test_rebalance_with_admission():
    both(_rebalance)


def _bucketed(S):
    cfg = S.config.get_config(ARCH)
    reqs = trace(S, qps=4.0, duration=10.0, name="loogle")
    out, cluster = S.serving.run_fleet(
        cfg, serve(S), S.serving.parse_mix("rapid:2x16,rapid:1x32"),
        "bucketed", reqs, admission=S.serving.AdmissionPolicy())
    return {"summary": out, "counts": cluster.per_replica_counts()}


def test_heterogeneous_bucketed_fleet():
    both(_bucketed)


def test_unknown_router_raises_alike():
    for S in SIDES.values():
        with pytest.raises(KeyError):
            S.serving.make_router("nope", S.config.get_config(ARCH),
                                  serve(S), None)
