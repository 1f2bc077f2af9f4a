"""``models/decode_graph.py`` on the CPU: the table widths a graph is
keyed by, and the decode step it captures.

On the CPU ``DecodeGraphs.step`` is the eager ``decode_forward`` (the
kernel wrappers compute their plain versions), so these tests hold what
the graph's inputs are: tables padded with block 0 to ``table_width``
must give the logits of the unpadded tables.  The plain paged attention
masks the padding's keys to exp(-1e30) = 0, and only the order of its
float32 sums may change with the width: atol = rtol = 1e-5.  Capture and
replay run on the card (``chip_smoke.py``).
"""
import numpy as np
import pytest
import torch

from repro_torch.config import get_reduced_config, replace
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import SPLIT_KEYS, split_count
from repro_torch.kvcache import kv_pages_for
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ring_table
from repro_torch.models.decode_graph import DecodeGraphs, table_width

F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pages,window,page,want", [
    (1, None, 16, 16),        # one split's pages
    (16, None, 16, 16),       # a whole split
    (17, None, 16, 32),       # one page past it: the next split
    (111, None, 16, 112),     # granite's 1762-token prompt + 8
    (3, None, 8, 32),         # page 8: 32 pages a split
    (2, 4096, 16, 256),       # a ring: W / page, however short the table
    (256, 4096, 16, 256),
    (3, 16, 4, 4)])           # reduced Mixtral's ring
def test_table_width(pages, window, page, want):
    got = table_width(pages, window, page)
    assert got == want
    if window is None:        # no split reads no key, and none is lost
        assert split_count(got, page) == split_count(pages, page) == \
            -(-pages * page // SPLIT_KEYS)


def test_table_width_refuses_a_table_wider_than_its_ring():
    with pytest.raises(ValueError, match="ring tables"):
        table_width(5, 16, 4)


def _prefilled(arch, lens, page, seed):
    """A reduced ``arch`` model (float32, random weights) and a pool
    holding ``lens`` prompts, each through its own scattered blocks (room
    for three decode steps); returns (model, cache, block lists,
    next tokens (B,1), lens (B,), state rows (B,))."""
    cfg = replace(get_reduced_config(arch), dtype="float32")
    model = tf.init_model(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    need = [kv_pages_for(n + 3, page) for n in lens]
    perm = rng.permutation(sum(need) + 3).tolist()
    blocks = [perm[sum(need[:i]):sum(need[:i + 1])]
              for i in range(len(lens))]
    cache = tf.init_cache(cfg, len(perm), page, len(lens), device="cpu",
                          dtype=torch.float32)
    nxt = []
    for i, n in enumerate(lens):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, n))
                                .astype(np.int32))
        logits, aux = tf.forward(model, toks, torch.arange(n)[None],
                                 return_aux=True, last_only=True)
        tab = torch.tensor([ring_table(blocks[i], cfg.sliding_window,
                                       page)], dtype=torch.int32)
        tf.write_prefill_to_cache(cache, aux, tab, torch.tensor([i]),
                                  window=cfg.sliding_window)
        nxt.append(tf.greedy_sample(logits, cfg.vocab_size)[0])
    return (model, cache, blocks, torch.stack(nxt),
            torch.tensor(lens, dtype=torch.int32), torch.arange(len(lens)))


def _tables(blocks, width, window, page):
    rows = [ring_table(b, window, page) for b in blocks]
    width = max(width, max(map(len, rows)))
    return torch.tensor([r + [0] * (width - len(r)) for r in rows],
                        dtype=torch.int32)


@pytest.mark.parametrize("arch,lens,page", [
    ("granite-8b", [21, 13, 40], 8),
    ("mixtral-8x7b", [5, 9, 3], 4)])     # window 16: rings of 4 pages
def test_tables_padded_to_table_width_give_the_same_logits(arch, lens,
                                                           page):
    model, cache, blocks, nxt, n, rows = _prefilled(arch, lens, page, 3)
    window = model.cfg.sliding_window
    widest = max(len(ring_table(b, window, page)) for b in blocks)
    width = table_width(widest, window, page)
    assert width > widest
    out = []
    for w in (widest, width):
        c = [{k: t.clone() for k, t in layer.items()} for layer in cache]
        tabs = _tables(blocks, w, window, page)
        assert tabs.shape == (len(lens), w)
        out.append(tf.decode_forward(model, nxt, n[:, None], c, tabs, n,
                                     rows)[0])
    np.testing.assert_allclose(out[1].numpy(), out[0].numpy(), **F32_TOL)


@pytest.mark.parametrize("arch", ["granite-8b", "llama3-70b"])
def test_decode_graphs_step_on_cpu_is_the_eager_step(arch):
    """Three steps through ``DecodeGraphs.step`` == ``decode_forward`` +
    ``greedy_sample`` on a copy of the same cache, a page boundary and a
    smaller batch included; nothing is captured or counted on the CPU."""
    page = 8
    model, cache, blocks, nxt, n, rows = _prefilled(arch, [15, 22, 9], page,
                                                    5)
    twin = [{k: t.clone() for k, t in layer.items()} for layer in cache]
    graphs = DecodeGraphs(model, cache, max_batch=3)
    ops.reset_launches()
    toks = nxt
    for step, keep in enumerate((3, 3, 2)):   # step 1: 16 cached, page 2
        b = slice(0, keep)
        tabs = _tables(blocks[:keep], table_width(3, None, page), None, page)
        got = graphs.step(toks[b], n[b], tabs, rows[b])
        logits, _ = tf.decode_forward(model, toks[b], n[b, None], twin, tabs,
                                      n[b], rows[b])
        want = tf.greedy_sample(logits, model.cfg.vocab_size)[:, 0]
        assert torch.equal(got, want), step
        np.testing.assert_array_equal(graphs.logits.numpy(), logits.numpy())
        toks, n = got[:, None], n[b] + 1
    assert graphs.ran == "eager"
    assert graphs.stats() == {"graphs": 0, "capture_s": 0.0, "replays": 0,
                              "pool_bytes": None}
    assert ops.launches() == {k: 0 for k in ops.launches()}
