"""The port's KV manager, call for call against the reference's.

Seeded random call sequences (numpy) drive both managers through the
same calls: prompt allocation with and without session prefixes, token
appends across page boundaries, frees, preemption, parking and dropping
session prefixes, staged checkpoint restores and pool growth.  After
every call the results (or the exceptions raised) and the whole
observable state must be identical: block ids, free lists, counts,
utilisations.  The checkpoint store is held to the reference's the same
way.
"""
import numpy as np
import pytest

from repro.kvcache import manager as jax_kv
from repro_torch.kvcache import manager as kv

PAGE = 4


def _call(obj, name, *args, **kw):
    """(result, None) or (None, (exception class name, message))."""
    try:
        return getattr(obj, name)(*args, **kw), None
    except Exception as e:     # noqa: BLE001 - compared across both copies
        return None, (type(e).__name__, str(e))


def _state(m):
    rids = sorted(m._seqs)
    return dict(
        free=list(m.allocator._free), num_blocks=m.allocator.num_blocks,
        free_count=m.allocator.free_count, used=m.allocator.used_count,
        requests=m.num_requests, utilization=m.utilization,
        occupancy=m.token_occupancy, session_blocks=m.session_blocks,
        available=m.available_blocks, sessions=list(m._sessions),
        restores=dict(m._staged_restores),
        blocks={r: m.blocks_of(r) for r in rids},
        tokens={r: m.tokens_of(r) for r in rids})


def _random_call(rng, live, next_rid, sessions):
    """One (method, args, kwargs) drawn over the managers' API."""
    op = rng.choice(["alloc", "alloc", "append", "append", "append", "free",
                     "preempt", "park", "drop", "stage", "restore_hit",
                     "clear", "grow", "project"])
    rid = int(rng.choice(live)) if live and rng.random() < 0.9 else \
        int(rng.integers(0, next_rid + 2))
    sid = str(rng.choice(sessions))
    plen = int(rng.integers(0, 9 * PAGE))
    if op == "alloc":
        if rng.random() < 0.5:
            return "allocate_prompt", (next_rid, plen), {}
        return "allocate_prompt", (next_rid, plen), dict(
            session_id=sid, max_prefix=int(rng.integers(0, plen + 2)))
    if op == "append":
        return "append_token", (rid,), {}
    if op == "free":
        return "free", (rid,), {}
    if op == "preempt":
        return "preempt", (rid,), {}
    if op == "park":
        return "release_to_session", (rid, sid), {}
    if op == "drop":
        return "drop_session", (sid,), {}
    if op == "stage":
        return "stage_restore", (int(rng.integers(0, next_rid + 1)),
                                 int(rng.integers(-2, 6 * PAGE))), {}
    if op == "restore_hit":
        return "restore_hit_tokens", (rid, plen), {}
    if op == "clear":
        return "clear_restore", (rid,), {}
    if op == "grow":
        return "grow", (int(rng.integers(-1, 6)),), {}
    which = rng.choice(["pages_needed", "can_allocate",
                        "session_hit_tokens", "session_tokens"])
    if which == "pages_needed":
        return which, (plen, sid, int(rng.integers(0, plen + 2))), {}
    if which == "can_allocate":
        return which, (plen,), {}
    if which == "session_hit_tokens":
        return which, (sid, plen, int(rng.integers(0, plen + 2))), {}
    return which, (sid,), {}


@pytest.mark.parametrize("seed", range(8))
def test_manager_matches_reference_call_for_call(seed):
    rng = np.random.default_rng(seed)
    blocks = int(rng.integers(8, 40))
    budget = int(rng.integers(0, blocks))
    ref_m = jax_kv.KVCacheManager(blocks, PAGE, session_cache_blocks=budget)
    m = kv.KVCacheManager(blocks, PAGE, session_cache_blocks=budget)
    sessions = [f"s{i}" for i in range(4)]
    next_rid = 0
    seen = set()
    for step in range(400):
        live = sorted(ref_m._seqs)
        name, args, kw = _random_call(rng, live, next_rid, sessions)
        want = _call(ref_m, name, *args, **kw)
        got = _call(m, name, *args, **kw)
        assert got == want, (step, name, args, kw)
        assert _state(m) == _state(ref_m), (step, name, args, kw)
        if name == "allocate_prompt" and want[1] is None:
            next_rid += 1
        seen.add((name, want[1] is None))
    # the sequences reach the paths they are meant to compare
    assert {("allocate_prompt", True), ("append_token", True),
            ("release_to_session", True), ("preempt", True),
            ("grow", True), ("free", False)} <= seen


@pytest.mark.parametrize("seed", range(4))
def test_checkpoint_store_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    budget = int(rng.integers(0, 30))
    ref_s = jax_kv.CheckpointStore(PAGE, budget_blocks=budget)
    s = kv.CheckpointStore(PAGE, budget_blocks=budget)
    for step in range(300):
        rid = int(rng.integers(0, 12))
        op = rng.choice(["put", "put", "get", "drop"])
        if op == "put":
            fields = dict(rid=rid, generated=int(rng.integers(0, 50)),
                          kv_tokens=int(rng.integers(0, 20 * PAGE)),
                          t=float(rng.random()))
            want = ref_s.put(jax_kv.KVCheckpoint(**fields))
            got = s.put(kv.KVCheckpoint(**fields))
        elif op == "get":
            c0, c1 = ref_s.get(rid), s.get(rid)
            want = None if c0 is None else (c0.rid, c0.generated,
                                            c0.kv_tokens, c0.t)
            got = None if c1 is None else (c1.rid, c1.generated,
                                           c1.kv_tokens, c1.t)
        else:
            want, got = ref_s.drop(rid), s.drop(rid)
        assert got == want, step
        assert (len(s), s.blocks, s.taken, s.evicted, s.refused,
                list(s._by_rid)) == (len(ref_s), ref_s.blocks, ref_s.taken,
                                     ref_s.evicted, ref_s.refused,
                                     list(ref_s._by_rid)), step


def test_alloc_zero_takes_nothing():
    """The one deliberate difference: the reference's ``alloc(0)`` would
    take the whole free list (its slice ``_free[-0:]``); the port's takes
    nothing.  The managers never call it with 0, so they agree."""
    a = kv.BlockAllocator(5)
    assert a.alloc(0) == [] and a.free_count == 5
    assert a.alloc(2) == [0, 1]


def test_double_free_and_shrink_raise():
    a = kv.BlockAllocator(3)
    b = a.alloc(2)
    a.free(b)
    with pytest.raises(RuntimeError, match="freed twice"):
        a.free(b)
    with pytest.raises(ValueError, match="only grow"):
        a.grow(-1)
