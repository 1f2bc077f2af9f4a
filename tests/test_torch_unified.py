"""The host side of the port's persistent unified P/D kernel.

``unified_pd`` takes its tiles from two work queues built on the host
from the reference's descriptor rows, and ``f_decode`` sets the SMs whose
CTAs take decode tiles first.  These tests hold the queues to the
reference's ``_make_descriptors`` and check the share and the grid.  The
kernel itself runs only on the card (``chip_smoke.py``).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from repro.kernels.unified_pd import _make_descriptors as jax_descriptors
from repro_torch.kernels.flash_prefill import BLOCK_Q
from repro_torch.kernels.unified_pd import (BLOCK_K, DECODE, PREFILL,
                                            TRACE_LEN, TRACE_START,
                                            decode_sms, grid_size, new_trace,
                                            prefill_kblocks, work_queues)

# (Bp, Hq, S, Bd, Hkv, G, splits, window)
SHAPES = [
    (1, 32, 890, 3, 8, 4, 6, 0),       # granite's fused serving step
    (1, 64, 890, 3, 8, 8, 6, 0),       # the Jamba period's attention
    (2, 4, 128, 3, 2, 2, 3, 0),
    (1, 8, 96, 2, 2, 4, 1, 48),        # sliding window
    (2, 4, 300, 1, 4, 1, 2, 100),      # window, ragged S
    (1, 4, 256, 2, 2, 2, 1, 65),       # window starts on a k-block edge
    (1, 2, 64, 4, 1, 2, 5, 0),         # one q-tile
]


def _rows(a):
    return Counter(map(tuple, np.asarray(a).tolist()))


@pytest.mark.parametrize("f_decode", [1.0, 0.5, 0.1])
@pytest.mark.parametrize("shape", SHAPES)
def test_work_queues_hold_every_reference_row_once(shape, f_decode):
    """The two queues together are the reference's descriptor rows (over
    Hkv * splits decode tiles) as a multiset, whatever order f_decode gave
    them there; the decode queue is exactly its decode rows, first."""
    Bp, Hq, S, Bd, Hkv, G, splits, window = shape
    rows, n_decode = work_queues(*shape)
    want = jax_descriptors(Bp, Hq, -(-S // BLOCK_Q), Bd, Hkv * splits, G,
                           f_decode)
    assert rows.dtype == np.int32 and rows.shape == want.shape
    assert _rows(rows) == _rows(want)
    assert n_decode == Bd * Hkv * splits
    assert _rows(rows[:n_decode]) == _rows(want[want[:, 0] == DECODE])
    assert (rows[:n_decode, 0] == DECODE).all()
    assert (rows[n_decode:, 0] == PREFILL).all()


def _kblocks_seen(qi, S, window):
    """k-blocks holding a key that some query row of tile qi sees."""
    rows = range(qi * BLOCK_Q, min(S, (qi + 1) * BLOCK_Q))
    seen = {k // BLOCK_K for q in rows for k in range(q + 1)
            if window <= 0 or k > q - window}
    return len(seen)


@pytest.mark.parametrize("shape", SHAPES)
def test_prefill_queue_is_longest_first(shape):
    """Prefill rows go by the k-blocks their tile reads, most first, and
    in the reference's order among equals; the count is that of the
    k-blocks holding a key the tile's rows see (causal and windowed)."""
    Bp, Hq, S, Bd, Hkv, G, splits, window = shape
    rows, n_decode = work_queues(*shape)
    pre = rows[n_decode:]
    work = [prefill_kblocks(int(qi), S, window) for qi in pre[:, 4]]
    assert all(a >= b for a, b in zip(work, work[1:]))
    ref_order = {r: i for i, r in enumerate(
        (b, h, h // G, qi) for b in range(Bp) for h in range(Hq)
        for qi in range(-(-S // BLOCK_Q)))}
    keys = [(-w, ref_order[tuple(r[1:5])])
            for w, r in zip(work, pre.tolist())]
    assert keys == sorted(keys)
    for qi in range(-(-S // BLOCK_Q)):
        assert prefill_kblocks(qi, S, window) == _kblocks_seen(qi, S, window)


@pytest.mark.parametrize("n_sms", [132, 114, 7, 1])
def test_decode_sms_clamps_and_rises_with_f(n_sms):
    """The decode share: f_decode of the SMs, rounded, in [1, n_sms],
    never falling as f_decode rises; f_decode is clamped to [1e-3, 1]."""
    fs = [-1.0, 0.0, 1e-4, 1e-3, 0.01, 0.1, 0.25, 0.5, 0.75, 0.99, 1.0, 2.0]
    got = [decode_sms(f, n_sms) for f in fs]
    assert all(1 <= n <= n_sms for n in got)
    assert got == sorted(got)
    assert decode_sms(1.0, n_sms) == decode_sms(5.0, n_sms) == n_sms
    assert decode_sms(0.0, n_sms) == decode_sms(-1.0, n_sms) == 1
    assert decode_sms(0.5, n_sms) == max(1, int(n_sms / 2 + 0.5))
    if n_sms == 132:
        assert [decode_sms(f, 132) for f in (1.0, 0.5, 0.25, 0.1)] == \
            [132, 66, 33, 13]


@pytest.mark.parametrize("tiles,ctas,sms,grid", [
    (592, 2, 132, 264), (1040, 2, 132, 264), (100, 2, 132, 100),
    (592, 1, 132, 132), (0, 2, 132, 1)])
def test_grid_is_every_resident_cta_and_no_more_than_the_tiles(tiles, ctas,
                                                                sms, grid):
    assert grid_size(tiles, ctas, sms) == grid


def test_trace_starts_at_the_top_of_int64():
    """The kernel takes the minimum of its CTAs' start times and the
    maximum of everything else, so a fresh trace starts there."""
    tr = new_trace(torch.device("cpu"))
    assert tr.dtype == torch.int64 and tr.shape == (TRACE_LEN,)
    assert tr[TRACE_START] == torch.iinfo(torch.int64).max
    assert not tr[TRACE_START + 1:].any()
