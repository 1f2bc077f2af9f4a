"""The port's synthetic traces against the reference's, field for field.

``serving/traces.py`` is numpy only, so the same seed must give the same
requests: rid, arrival, prompt length and new-token budget, exactly.
"""
import pytest

from repro.serving import traces as ref_traces
from repro_torch.serving import traces

CASES = [("lmsys", 0.5, 20.0, 0),     # the smoke's LLaMA trace
         ("lmsys", 2.0, 5.0, 4),
         ("arxiv", 0.5, 6.0, 1),
         ("loogle", 0.3, 10.0, 2),
         ("lmsys", 0.05, 1.0, 0)]     # no arrival within the duration


@pytest.mark.parametrize("trace,qps,duration,seed", CASES)
def test_generate_trace_matches_reference(trace, qps, duration, seed):
    assert traces.TRACES[trace] == traces.TraceSpec(
        **vars(ref_traces.TRACES[trace]))
    mine = traces.generate_trace(traces.TRACES[trace], qps, duration, seed)
    theirs = ref_traces.generate_trace(ref_traces.TRACES[trace], qps,
                                       duration, seed)
    fields = ("rid", "arrival", "prompt_len", "max_new_tokens")
    assert [tuple(getattr(r, f) for f in fields) for r in mine] == \
        [tuple(getattr(r, f) for f in fields) for r in theirs]
    assert all(0 <= r.arrival < duration for r in mine)
    if qps == 0.05:
        assert mine == []
    if (trace, qps, duration, seed) == CASES[0]:
        assert len(mine) == 7
        assert sum(r.prompt_len for r in mine) == 9379
        assert sum(r.max_new_tokens for r in mine) == 1680
