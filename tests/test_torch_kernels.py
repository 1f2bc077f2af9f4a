"""The port's kernels on the CPU against the reference's Pallas kernels.

On a CPU tensor each kernel wrapper computes its plain version, so these
tests hold the plain versions (and the layout wrappers around them) to
the Pallas kernels run in interpret mode, on the same numpy-seeded inputs.
The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels.flash_prefill import flash_prefill as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.kernels.unified_pd import _make_descriptors as jax_descriptors
from repro.kernels.unified_pd import build_slot_schedule as jax_schedule
from repro.kernels.unified_pd import unified_pd as jax_unified
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_prefill import check_prefill, flash_prefill
from repro_torch.kernels.paged_attention import (MAX_G, SPLIT_KEYS,
                                                 check_decode, counters,
                                                 paged_attention,
                                                 split_count)
from repro_torch.kernels.unified_pd import (_make_descriptors,
                                            build_slot_schedule,
                                            split_descriptors, unified_pd)

# float32 on both sides; the two frameworks sum in different orders
TOL = dict(atol=3e-5, rtol=3e-5)


def _normal(rs, *shape):
    return rs.standard_normal(shape).astype(np.float32)


def _tables(rs, B, N, max_pages):
    return np.stack([rs.permutation(N)[:max_pages]
                     for _ in range(B)]).astype(np.int32)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bq,bk,window", [
    (2, 4, 2, 128, 32, 64, 64, None),
    (1, 8, 2, 257, 64, 64, 128, None),     # ragged S
    (2, 4, 4, 256, 32, 64, 64, 96),        # sliding window
    (1, 2, 1, 64, 16, 32, 32, None),       # MQA
    (1, 4, 1, 96, 32, 32, 32, 32),         # window == block
])
def test_flash_prefill_plain_matches_pallas(B, Hq, Hkv, S, D, bq, bk,
                                            window):
    rs = np.random.RandomState(0)
    q, k, v = (_normal(rs, B, Hq, S, D), _normal(rs, B, Hkv, S, D),
               _normal(rs, B, Hkv, S, D))
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     window=window, block_q=bq, block_k=bk, interpret=True)
    before = flash_prefill.launches
    got = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window=window)
    assert flash_prefill.launches == before     # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("B,Hq,Hkv,D,page,max_pages,N", [
    (2, 4, 2, 32, 8, 4, 16),
    (3, 8, 4, 64, 16, 6, 32),
    (1, 4, 1, 16, 8, 3, 8),
    (4, 2, 2, 32, 4, 5, 24),
])
def test_paged_attention_plain_matches_pallas(B, Hq, Hkv, D, page,
                                              max_pages, N):
    rs = np.random.RandomState(1)
    q = _normal(rs, B, Hq, D)
    kp, vp = _normal(rs, N, page, Hkv, D), _normal(rs, N, page, Hkv, D)
    tabs = _tables(rs, B, N, max_pages)
    lens = rs.randint(1, max_pages * page + 1, size=B).astype(np.int32)
    want = jax_paged(*map(jnp.asarray, (q, kp, vp, tabs, lens)),
                     interpret=True)
    got = paged_attention(*map(torch.from_numpy, (q, kp, vp, tabs, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_paged_attention_plain_len_one():
    """Boundary: a sequence with exactly one valid token."""
    B, Hq, Hkv, D, page, mp, N = 2, 4, 2, 32, 8, 3, 8
    rs = np.random.RandomState(2)
    q = _normal(rs, B, Hq, D)
    kp, vp = _normal(rs, N, page, Hkv, D), _normal(rs, N, page, Hkv, D)
    tabs = np.tile(np.arange(mp, dtype=np.int32), (B, 1))
    lens = np.array([1, page * mp], np.int32)
    want = jax_paged(*map(jnp.asarray, (q, kp, vp, tabs, lens)),
                     interpret=True)
    got = paged_attention(*map(torch.from_numpy, (q, kp, vp, tabs, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("f_decode", [1.0, 0.5, 0.25, 0.1])
def test_slot_schedule_matches_reference(f_decode):
    np.testing.assert_array_equal(build_slot_schedule(24, 6, f_decode),
                                  jax_schedule(24, 6, f_decode))
    np.testing.assert_array_equal(
        _make_descriptors(2, 4, 3, 3, 2, 2, f_decode),
        jax_descriptors(2, 4, 3, 3, 2, 2, f_decode))


@pytest.mark.parametrize("Bp,Bd,Hq,Hkv,Sp,D,page,mp,N,f,win", [
    (1, 2, 4, 2, 128, 32, 8, 4, 16, 0.5, None),
    (2, 3, 4, 4, 64, 16, 8, 3, 12, 0.25, None),
    (1, 2, 8, 2, 96, 32, 16, 2, 8, 1.0, 48),
    (2, 1, 4, 2, 64, 32, 8, 2, 8, 0.1, None),
])
def test_unified_pd_plain_matches_pallas(Bp, Bd, Hq, Hkv, Sp, D, page, mp,
                                         N, f, win):
    rs = np.random.RandomState(3)
    args = (_normal(rs, Bp, Hq, Sp, D), _normal(rs, Bp, Hkv, Sp, D),
            _normal(rs, Bp, Hkv, Sp, D), _normal(rs, Bd, Hq, D),
            _normal(rs, N, page, Hkv, D), _normal(rs, N, page, Hkv, D),
            _tables(rs, Bd, N, mp),
            rs.randint(1, mp * page + 1, size=Bd).astype(np.int32))
    wp, wd = jax_unified(*map(jnp.asarray, args), f_decode=f, window=win,
                         block_q=32, block_k=32, interpret=True)
    gp, gd = unified_pd(*map(torch.from_numpy, args), f_decode=f,
                        window=win)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def test_ops_layout_wrappers_match_reference():
    """(B,S,H,D) wrappers: flash_prefill, paged_attention_dense and
    unified_pd agree with the reference's ops on the same inputs."""
    rs = np.random.RandomState(4)
    B, S, Hq, Hkv, D, Sc = 2, 40, 4, 2, 32, 48
    q, k, v = (_normal(rs, B, S, Hq, D), _normal(rs, B, S, Hkv, D),
               _normal(rs, B, S, Hkv, D))
    np.testing.assert_allclose(
        ops.flash_prefill(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(jax_ops.flash_prefill(*map(jnp.asarray, (q, k, v)))),
        **TOL)

    qd = _normal(rs, B, Hq, D)
    ck, cv = _normal(rs, B, Sc, Hkv, D), _normal(rs, B, Sc, Hkv, D)
    lens = np.array([7, Sc], np.int32)
    for window in (None, 16):
        np.testing.assert_allclose(
            ops.paged_attention_dense(
                *map(torch.from_numpy, (qd, ck, cv, lens)), window=window,
                page=16).numpy(),
            np.asarray(jax_ops.paged_attention_dense(
                *map(jnp.asarray, (qd, ck, cv, lens)), window=window,
                page=16)), **TOL)

    N, page, mp = 12, 8, 4
    kp, vp = _normal(rs, N, page, Hkv, D), _normal(rs, N, page, Hkv, D)
    tabs = _tables(rs, B, N, mp)
    dl = np.array([3, 30], np.int32)
    args = (q, k, v, qd, kp, vp, tabs, dl)
    gp, gd = ops.unified_pd(*map(torch.from_numpy, args), f_decode=0.25)
    wp, wd = jax_ops.unified_pd(*map(jnp.asarray, args), f_decode=0.25)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), **TOL)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), **TOL)


def test_kernel_input_checks_reject_what_the_kernels_cannot_take():
    """The checks run before a launch; they need no card to be tested."""
    q = torch.zeros(1, 4, 8, 32)
    k = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="CUDA"):
        build.check_cuda(q, k)
    with pytest.raises(TypeError):
        build.dtype_code(q, k.bfloat16())
    with pytest.raises(TypeError):
        build.dtype_code(q.half())
    assert build.dtype_code(q, k) == 0 and build.dtype_code(q.bfloat16()) == 1
    with pytest.raises(ValueError, match="aligned"):
        build.check_rows_aligned(torch.zeros(8, 33)[:, 1:])
    build.check_rows_aligned(torch.zeros(2, 8, 4, 32).transpose(1, 2))
    with pytest.raises(ValueError, match="multiple"):
        check_prefill(q, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32))
    with pytest.raises(ValueError, match="head dim"):
        check_prefill(q[..., :24], k[..., :24], k[..., :24])
    with pytest.raises(ValueError, match="int32"):
        check_decode(q[:, :, 0], torch.zeros(4, 8, 2, 32),
                     torch.zeros(4, 8, 2, 32),
                     torch.zeros(1, 2, dtype=torch.int64),
                     torch.zeros(1, dtype=torch.int32))


def test_plain_keeps_input_dtype_and_finite_masked_rows():
    """bf16 in -> bf16 out (f32 math inside); a zero-length sequence and
    a fully windowed-out row still give finite values."""
    rs = np.random.RandomState(5)
    q = torch.from_numpy(_normal(rs, 1, 2, 8, 16)).bfloat16()
    k = torch.from_numpy(_normal(rs, 1, 1, 8, 16)).bfloat16()
    out = ref.causal_attention(q, k, k, window=1)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    kp = torch.from_numpy(_normal(rs, 2, 4, 1, 16))
    od = ref.paged_attention(q[:, :, 0].float(), kp, kp,
                             torch.zeros(1, 2, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
    assert torch.isfinite(od).all()


@pytest.mark.parametrize("max_pages,page,splits", [
    (1, 16, 1), (16, 16, 1), (17, 16, 2), (111, 16, 7), (3, 8, 1),
    (40, 16, 3), (70, 8, 3), (64, 4, 1), (65, 4, 2)])
def test_split_count_from_table_width_and_page(max_pages, page, splits):
    """The decode split count is the table's key capacity in SPLIT_KEYS
    pieces: host shapes only, never seq_lens."""
    assert SPLIT_KEYS == 256
    assert split_count(max_pages, page) == splits


@pytest.mark.parametrize("Bp,Hq,nq,Bd,Hkv,G,splits", [
    (1, 32, 28, 4, 8, 4, 7),      # granite's fused step
    (2, 4, 3, 3, 2, 2, 3),
    (1, 64, 14, 3, 8, 8, 6),      # Jamba's attention heads
    (1, 8, 1, 1, 1, 8, 1)])
@pytest.mark.parametrize("f_decode", [1.0, 0.5, 0.25, 0.1])
def test_split_descriptors_cover_every_split_once(Bp, Hq, nq, Bd, Hkv, G,
                                                  splits, f_decode):
    """Every (sequence, kv head, split) is one decode slot, read as
    kvh * splits + split; every prefill tile is one slot; the slot kinds
    are the reference's schedule for the expanded decode count."""
    desc = split_descriptors(Bp, Hq, nq, Bd, Hkv, G, splits, f_decode)
    n_p, n_d = Bp * Hq * nq, Bd * Hkv * splits
    np.testing.assert_array_equal(desc[:, 0],
                                  jax_schedule(n_p, n_d, f_decode))
    dec = desc[desc[:, 0] == 1]
    got = sorted((int(b), int(c) // splits, int(c) % splits)
                 for b, c in dec[:, 5:7])
    assert got == [(b, h, s) for b in range(Bd) for h in range(Hkv)
                   for s in range(splits)]
    pre = desc[desc[:, 0] == 0]
    assert sorted(map(tuple, pre[:, 1:5].tolist())) == sorted(
        (b, h, h // G, qi) for b in range(Bp) for h in range(Hq)
        for qi in range(nq))
    np.testing.assert_array_equal(
        desc, jax_descriptors(Bp, Hq, nq, Bd, Hkv * splits, G, f_decode))


@pytest.mark.parametrize("B,Hq,Hkv,D,page,max_pages,lens", [
    (3, 8, 4, 64, 16, 40, [1, 256, 257]),
    (4, 4, 2, 32, 8, 70, [560, 300, 20, 513]),
    (2, 8, 1, 128, 16, 33, [528, 255])])
def test_paged_attention_plain_at_split_edges_matches_pallas(
        B, Hq, Hkv, D, page, max_pages, lens):
    """The wrapper's plain version, which the card's split-edge checks hold
    the kernel to, equals the reference kernel where the decode splits
    meet: 1 key, exactly one split, one key more, and sequences whose
    trailing splits are empty."""
    assert split_count(max_pages, page) * SPLIT_KEYS > max(lens)
    rs = np.random.RandomState(6)
    N = B * max_pages
    q = _normal(rs, B, Hq, D)
    kp, vp = _normal(rs, N, page, Hkv, D), _normal(rs, N, page, Hkv, D)
    tabs = _tables(rs, B, N, max_pages)
    seq = np.array(lens, np.int32)
    want = jax_paged(*map(jnp.asarray, (q, kp, vp, tabs, seq)),
                     interpret=True)
    got = paged_attention(*map(torch.from_numpy, (q, kp, vp, tabs, seq)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_split_counters_are_zeroed_and_grow():
    """The per-device arrival counters start at zero, are reused while
    large enough and replaced by a larger zeroed buffer when not."""
    dev = torch.device("cpu")
    a = counters(dev, 10, stream=0)
    assert a.dtype == torch.int32 and a.numel() >= 10 and not a.any()
    assert counters(dev, 10, stream=0) is a
    b = counters(dev, a.numel() + 1, stream=0)
    assert b.numel() > a.numel() and not b.any()
    assert counters(dev, 5, stream=0) is b


def test_split_counters_are_per_stream():
    """Two streams of one device get distinct zeroed counter buffers, and
    each stream reuses its own; the default stream (0) has a third."""
    dev = torch.device("cpu")
    a, b = counters(dev, 10, stream=11), counters(dev, 10, stream=12)
    assert a is not b and a.data_ptr() != b.data_ptr()
    assert not a.any() and not b.any()
    assert counters(dev, 10, stream=11) is a
    assert counters(dev, 10, stream=12) is b
    default = counters(dev, 10, stream=0)
    assert default is not a and default is not b
    grown = counters(dev, a.numel() + 1, stream=11)
    assert grown.numel() > a.numel() and not grown.any()
    assert counters(dev, 10, stream=12) is b


def test_decode_check_rejects_query_groups_past_the_tile():
    """A decode tile holds G = Hq/Hkv <= MAX_G query heads in registers;
    the wrapper refuses more before any launch."""
    assert MAX_G == 8

    def pages(Hkv, D):
        return torch.zeros(4, 8, Hkv, D), torch.zeros(4, 8, Hkv, D)

    tabs = torch.zeros(1, 2, dtype=torch.int32)
    lens = torch.ones(1, dtype=torch.int32)
    check_decode(torch.zeros(1, 8, 128), *pages(1, 128), tabs, lens)
    check_decode(torch.zeros(1, 64, 16), *pages(8, 16), tabs, lens)
    with pytest.raises(ValueError, match="exceed"):
        check_decode(torch.zeros(1, 16, 128), *pages(1, 128), tabs, lens)
    with pytest.raises(ValueError, match="exceed"):
        check_decode(torch.zeros(1, 32, 16), *pages(2, 16), tabs, lens)
