"""The port's copies of ``serving/workloads.py`` and ``serving/faults.py``
(and ``serving/metrics.py``'s class and fleet summaries) against the
reference's, bit for bit, on the scenarios of ``tests/test_workloads.py``
and ``tests/test_faults.py``: the same calls on each package, on the CPU,
with ``TPU_V5E`` and the perfmodel-priced engines, must give equal
results (floats compared through ``repr``)."""
import random

import numpy as np
import pytest
from test_torch_cluster import ARCH, SIDES, both, serve


def _trace_fields(reqs):
    return [(r.rid, r.arrival, r.prompt_len, r.max_new_tokens, r.slo_class,
             r.session_id, r.cached_prefix_len) for r in reqs]


def _multiclass(S, qps, duration, seed, arrival):
    W = S.serving_workloads
    rate = {"flat": None,
            "diurnal": W.diurnal_rate(qps, amplitude=0.5, period_s=20.0),
            "flash": W.flash_crowd_rate(qps, 4 * qps, 5.0, 10.0)}[arrival]
    return _trace_fields(W.generate_multiclass_trace(
        qps=qps, duration_s=duration, seed=seed, rate_fn=rate))


@pytest.mark.parametrize("qps,duration,seed,arrival", [
    (4.0, 20.0, 9, "flat"), (4.0, 30.0, 3, "flat"), (2.0, 40.0, 1, "diurnal"),
    (3.0, 20.0, 5, "flash")])
def test_multiclass_trace(qps, duration, seed, arrival):
    out = both(_multiclass, qps, duration, seed, arrival)
    assert len({r[4] for r in out}) > 1 and any(r[5] for r in out)


def _classes(S):
    W = S.serving_workloads
    return {"classes": W.WORKLOAD_CLASSES, "mix": W.DEFAULT_MIX,
            "slos": W.class_slos()}


def test_classes_and_their_slos():
    both(_classes)


def _nhpp(S, kind):
    W = S.serving_workloads
    rate = W.flash_crowd_rate(2.0, 20.0, 100.0, 200.0) if kind == "flash" \
        else W.diurnal_rate(4.0, amplitude=0.5, period_s=100.0)
    return {"arrivals": W.nhpp_arrivals(rate, 300.0,
                                        np.random.default_rng(0)),
            "rate_max": rate.rate_max}


@pytest.mark.parametrize("kind", ["flash", "diurnal"])
def test_nhpp_arrivals(kind):
    both(_nhpp, kind)


def _pressured(S, class_aware):
    cfg = S.config.get_config(ARCH)
    R = S.core_request.Request
    cluster = S.serving.Cluster(
        cfg, serve(S), ["rapid"], router="least_loaded",
        admission=S.serving.AdmissionPolicy(kv_headroom=0.9,
                                            class_aware=class_aware))
    cluster.replicas[0].engine.kv = S.kvcache.KVCacheManager(200, 16)
    reqs = [R(rid=0, arrival=0.0, prompt_len=2000, max_new_tokens=100,
              slo_class="batch"),
            R(rid=1, arrival=0.1, prompt_len=400, max_new_tokens=50,
              slo_class="best_effort"),
            R(rid=2, arrival=0.2, prompt_len=400, max_new_tokens=50,
              slo_class="interactive")]
    recs, span = cluster.run(reqs)
    return {"records": recs, "span": span, "stats": cluster.admission.stats,
            "states": [r.state for r in reqs]}


@pytest.mark.parametrize("class_aware", [True, False])
def test_class_aware_admission(class_aware):
    both(_pressured, class_aware)


def _fleet_classes(S, modes, affinity):
    cfg = S.config.get_config(ARCH)
    reqs = S.serving_workloads.generate_multiclass_trace(
        qps=3.0, duration_s=10.0, seed=1)
    summary, cluster = S.serving.run_fleet(
        cfg, serve(S), modes, "least_loaded", reqs,
        admission=S.serving.AdmissionPolicy(class_aware=True),
        session_affinity=affinity)
    return {"summary": summary,
            "per_class": S.serving_metrics.per_class_summaries(
                cluster.metrics.records, serve(S).slo, 10.0)}


@pytest.mark.parametrize("modes,affinity", [(["rapid"], False),
                                            (["rapid", "rapid"], True)])
def test_fleet_summary_per_class(modes, affinity):
    out = both(_fleet_classes, modes, affinity)
    assert len(out["summary"]["per_class"]) > 1


def _faults(S):
    F = S.serving_faults
    line = b'{"type": "token", "rid": 1, "t": 0.5, "index": 3}\n'
    return {"storms": [F.FaultPlan.crash_storm(seed=s, workers=3, t0=1.0,
                                               t1=9.0, crashes=4)
                       for s in (7, 8)],
            "delays": [F.RetryPolicy(max_retries=5).delay(n)
                       for n in range(8)],
            "corrupted": [F.line_corruptor(random.Random(s), rate=r)(line)
                          for s in (3, 4) for r in (0.0, 0.5, 1.0)],
            "kinds": F.FAULT_KINDS}


def test_fault_plans_retries_and_line_corruptor():
    both(_faults)


def test_fault_kind_validated_alike():
    for S in SIDES.values():
        with pytest.raises(ValueError):
            S.serving_faults.Fault(kind="meteor", t=0.0)
