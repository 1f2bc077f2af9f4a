"""The two embedding-input models (Qwen2-VL-72B with M-RoPE,
MusicGen-large) and the port's ``launch/steps.py`` cells, against the
reference.

``mrope_cos_sin`` is held to the reference's with t, h and w streams that
differ (where they coincide M-RoPE is RoPE, and a wrong split of the
rotary half would not show).  Reduced qwen2-vl-72b and musicgen-large run
in float32 with the reference's weights converted (the qkv biases drawn
from a seed, as the reference initialises them to zero), on seeded stub
embeddings (B, S, d) and positions, (B, S, 3) in Qwen2-VL's layout
(``steps.mrope_positions``: a text prefix, an image grid whose patches
share one t, text again): ``forward``, ``decode_forward`` and
``fused_pd_forward`` against the reference's within atol = rtol = 3e-5.
``steps.input_specs`` must give the reference's shapes and dtypes for
every registered arch and every shape of ``cells_for_arch``; each cell
builds and runs on the CPU for both reduced models.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import _identity_pools

from repro.config import get_config as jax_config
from repro.config import get_reduced_config as jax_reduced_config
from repro.config import list_archs as jax_archs
from repro.config import replace as jax_replace
from repro.launch import steps as jax_steps
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.config import (SHAPES, ShapeConfig, get_config,
                                get_one_card_config, get_reduced_config,
                                list_archs, replace)
from repro_torch.convert import model_from_reference
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import serve_real, steps
from repro_torch.models import layers
from repro_torch.models import transformer as tf

ARCHS = ["qwen2-vl-72b", "musicgen-large"]
TOL = dict(atol=3e-5, rtol=3e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops run fastest on one intra-op thread beside other test
    workers; restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# configs and input specs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_configs_match_reference(arch, reduced):
    mine, theirs = ((get_reduced_config(arch), jax_reduced_config(arch))
                    if reduced else (get_config(arch), jax_config(arch)))
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert mine.param_count() == theirs.param_count()
    assert mine.kv_bytes_per_token() == theirs.kv_bytes_per_token()


def test_one_card_cuts():
    """Qwen2-VL-72B's cut keeps every width and 36 of 80 layers: 68.18 GB
    in bf16 (37 would be 69.93 GB); MusicGen-large runs whole."""
    full, cut = get_config("qwen2-vl-72b"), get_one_card_config(
        "qwen2-vl-72b")
    assert cut == replace(full, num_layers=36)
    assert 2 * full.param_count() / 1e9 == pytest.approx(145.41, abs=0.01)
    assert 2 * cut.param_count() / 1e9 == pytest.approx(68.18, abs=0.01)
    assert 2 * replace(full, num_layers=37).param_count() / 1e9 == \
        pytest.approx(69.93, abs=0.01)
    music = get_one_card_config("musicgen-large")
    assert music == get_config("musicgen-large")
    assert 2 * music.param_count() / 1e9 == pytest.approx(4.85, abs=0.01)


def _spec_cases():
    return [(arch, shape.name) for arch in list_archs()
            for shape in steps.cells_for_arch(get_config(arch))]


@pytest.mark.parametrize("arch,shape", _spec_cases())
def test_input_specs_match_reference(arch, shape):
    """Every registered arch x every shape of its cells: the reference's
    input names, shapes and dtypes."""
    assert list_archs() == sorted(jax_archs())
    mine = steps.input_specs(get_config(arch), SHAPES[shape])
    theirs = jax_steps.input_specs(jax_config(arch), jax_steps.SHAPES[shape])
    assert [s.name for s in steps.cells_for_arch(get_config(arch))] == \
        [s.name for s in jax_steps.cells_for_arch(jax_config(arch))]
    assert set(mine) == set(theirs)
    for k, spec in mine.items():
        assert spec.shape == theirs[k].shape, k
        assert str(spec.dtype).removeprefix("torch.") == \
            str(theirs[k].dtype), k


def test_mrope_positions_layout():
    """A 64-token prompt: 8 text tokens, a 5 x 5 image at t = 8, 31 text
    tokens from 13 on; the next token's position is 44 on every stream."""
    pos = steps.mrope_positions(64)
    assert pos.shape == (64, 3)
    np.testing.assert_array_equal(pos[:8], np.repeat(np.arange(8), 3)
                                  .reshape(8, 3))
    img = pos[8:33]
    assert (img[:, 0] == 8).all()
    assert img[:, 1].tolist() == [8 + i // 5 for i in range(25)]
    assert img[:, 2].tolist() == [8 + i % 5 for i in range(25)]
    assert pos[33].tolist() == [13] * 3 and pos[-1].tolist() == [43] * 3
    cfg = get_reduced_config("qwen2-vl-72b")
    assert steps.next_position(cfg, 64) == 44


@pytest.mark.parametrize("head_dim", [32, 128, 80])
def test_mrope_cos_sin_matches_reference(head_dim):
    """Distinct t/h/w streams; the rotary half of 16, 64 or 40 split
    (2, 1, 1) into 8/4/4, 32/16/16 and 10/5/5 frequencies."""
    rs = np.random.RandomState(head_dim)
    pos = rs.randint(0, 4000, size=(2, 9, 3)).astype(np.int32)
    want = jax_layers.mrope_cos_sin(jnp.asarray(pos), head_dim, 1e6)
    got = layers.mrope_cos_sin(torch.from_numpy(pos), head_dim, 1e6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # a swap of two streams moves the rotation
    swapped = layers.mrope_cos_sin(torch.from_numpy(pos[..., [0, 2, 1]]),
                                   head_dim, 1e6)
    assert (swapped[0] - got[0]).abs().max() > 0.1
    same = np.repeat(pos[..., :1], 3, axis=-1)
    rope = layers.rope_cos_sin(torch.from_numpy(same[..., 0]), head_dim,
                               1e6)
    for g, w in zip(layers.mrope_cos_sin(torch.from_numpy(same), head_dim,
                                         1e6), rope):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# the models against the reference
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _models(arch):
    """(port model, reference params (numpy), port cfg, reference cfg)."""
    cfg = replace(get_reduced_config(arch), dtype="float32")
    jcfg = jax_replace(jax_reduced_config(arch), dtype="float32")
    params, _ = jax_tf.init_model(jax.random.PRNGKey(11), jcfg)
    params = jax.tree.map(np.asarray, params)
    rs = np.random.RandomState(11)
    mixer = params["layers"]["pos0"]["mixer"]
    for name in ("bq", "bk", "bv"):
        if name in mixer:
            mixer[name] = (0.5 * rs.standard_normal(mixer[name].shape)
                           ).astype(np.float32)
    return model_from_reference(params, cfg), params, cfg, jcfg


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _models(request.param)


def _embeds(rs, cfg, B, S):
    return rs.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _prompt_positions(cfg, B, S):
    return np.repeat(steps._positions_of(cfg, None, S), B, axis=0)


def _next_positions(cfg, lens):
    return steps._positions_of(cfg, lens, 1)


def _reference_prefilled(params, jcfg, x, pos, Sc):
    logits, aux = jax_tf.forward(params, jcfg, jnp.asarray(x),
                                 jnp.asarray(pos), 1, impl="pallas",
                                 return_aux=True)
    cache = jax_tf.init_cache(jcfg, x.shape[0], Sc, 1)
    return logits, jax_tf.write_prefill_to_cache(jcfg, cache, aux,
                                                 x.shape[1])


def test_mrope_streams_differ_in_the_prompts():
    cfg = get_reduced_config("qwen2-vl-72b")
    pos = _prompt_positions(cfg, 1, 40)[0]
    assert (pos[:, 0] != pos[:, 1]).any() and (pos[:, 1] != pos[:, 2]).any()


def test_forward_matches_reference(models):
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(3)
    B, S = 2, 40
    x, pos = _embeds(rs, cfg, B, S), _prompt_positions(cfg, B, S)
    want, jaux = jax_tf.forward(params, jcfg, jnp.asarray(x),
                                jnp.asarray(pos), 1, impl="pallas",
                                return_aux=True)
    got, aux = tf.forward(model, torch.from_numpy(x), torch.from_numpy(pos),
                          return_aux=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i, a in enumerate(aux):
        np.testing.assert_allclose(a["k"].numpy(),
                                   np.asarray(jaux["pos0"]["k"][i]), **TOL)
    last = tf.forward(model, torch.from_numpy(x), torch.from_numpy(pos),
                      impl="ref", last_only=True)
    np.testing.assert_allclose(last.numpy(), np.asarray(want)[:, -1:],
                               **TOL)


def test_forward_sees_the_streams(models):
    """Swapping the h and w streams moves Qwen2-VL's logits (and nothing
    of MusicGen's, which has no rope)."""
    model, _, cfg, _ = models
    rs = np.random.RandomState(5)
    x = torch.from_numpy(_embeds(rs, cfg, 1, 40))
    pos = _prompt_positions(cfg, 1, 40)
    a = tf.forward(model, x, torch.from_numpy(pos))
    swapped = pos[..., [0, 2, 1]] if pos.ndim == 3 else pos
    b = tf.forward(model, x, torch.from_numpy(np.ascontiguousarray(swapped)))
    moved = (a - b).abs().max().item()
    assert moved > 1e-3 if cfg.rope_type == "mrope" else moved == 0.0


def test_decode_forward_matches_reference(models):
    """Four decode steps after a prefill, each on fresh embeddings at the
    next text position, over identity block tables == the reference's
    slot-dense decode."""
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(4)
    B, S, Sc, page = 2, 24, 32, 8
    x, pos = _embeds(rs, cfg, B, S), _prompt_positions(cfg, B, S)
    _, jcache = _reference_prefilled(params, jcfg, x, pos, Sc)
    pools, tables = _identity_pools(jcache, page)
    lens = np.array([S, S], np.int32)
    for _ in range(4):
        d = _embeds(rs, cfg, B, 1)
        dpos = _next_positions(cfg, lens)
        want, jcache = jax_tf.decode_forward(
            params, jcfg, jnp.asarray(d), jnp.asarray(dpos), jcache,
            jnp.asarray(lens), 1, impl="pallas")
        got, pools = tf.decode_forward(
            model, torch.from_numpy(d), torch.from_numpy(dpos), pools,
            tables, torch.from_numpy(lens), torch.arange(B))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        lens = lens + 1


def test_fused_pd_forward_matches_reference(models):
    """One concurrent step of two prompts and three decodes == the
    reference's forward at the last position + decode_forward."""
    model, params, cfg, jcfg = models
    rs = np.random.RandomState(5)
    Bd, S, Sc, page = 3, 21, 32, 8
    x, pos = _embeds(rs, cfg, Bd, S), _prompt_positions(cfg, Bd, S)
    _, jcache = _reference_prefilled(params, jcfg, x, pos, Sc)
    lens = np.array([S, S, S], np.int32)
    d, dpos = _embeds(rs, cfg, Bd, 1), _next_positions(cfg, lens)
    want_d, _ = jax_tf.decode_forward(
        params, jcfg, jnp.asarray(d), jnp.asarray(dpos), jcache,
        jnp.asarray(lens), 1, impl="pallas")
    Bp, Sp = 2, 17
    p, ppos = _embeds(rs, cfg, Bp, Sp), _prompt_positions(cfg, Bp, Sp)
    want_p = jax_tf.forward(params, jcfg, jnp.asarray(p), jnp.asarray(ppos),
                            1, impl="pallas", last_only=True)
    pools, tables = _identity_pools(jcache, page)
    got_p, aux, got_d, _ = tf.fused_pd_forward(
        model, torch.from_numpy(p), torch.from_numpy(ppos),
        torch.from_numpy(d), torch.from_numpy(dpos), pools, tables,
        torch.from_numpy(lens), torch.arange(Bd), f_decode=0.5)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), **TOL)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    assert aux[0]["k"].shape[:2] == (Bp, Sp)


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

PREFILL = ShapeConfig("prefill_32k", 24, 2, "prefill")
DECODE = ShapeConfig("decode_32k", 40, 3, "decode")


def test_cells_run_on_the_cpu(models):
    """Each cell of a reduced model builds, draws its inputs as its specs
    say and runs: the prefill cell's logits are ``forward``'s last
    position, the decode cell's steps equal the plain path's from the
    same cache, and the fused cell equals its two halves."""
    model, _, cfg, _ = models
    cell = steps.build_cell(model, PREFILL)
    args = cell.materialize(0, "cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in args.items()} == \
        {k: (s.shape, s.dtype) for k, s in cell.args.items()}
    logits, aux = cell(**args)
    assert logits.shape == (2, 1, cfg.vocab_padded)
    np.testing.assert_allclose(
        logits.numpy(), tf.forward(model, **args)[:, -1:].numpy(), **TOL)
    assert len(aux) == cfg.num_layers

    kern = steps.build_cell(model, DECODE)
    plain = steps.build_decode_cell(model, DECODE, impl="ref")
    args = kern.materialize(1, "cpu")
    assert plain.materialize(1, "cpu").keys() == args.keys()
    assert {k: (tuple(v.shape), v.dtype) for k, v in args.items()} == \
        {k: (s.shape, s.dtype) for k, s in kern.args.items()}
    got = steps.decode_steps(kern, args, 3, seed=2)
    want = steps.decode_steps(plain, args, 3, seed=2)
    assert len(got) == 3 and got[0][1].shape == (3, 1, cfg.vocab_padded)
    for (a, g), (b, w) in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(got[2][0]["seq_lens"], args["seq_lens"] + 2)
    assert not torch.equal(got[0][1], got[1][1])

    fused = steps.build_fused_pd_cell(model, prefill_batch=2, prefill_seq=16,
                                      decode_batch=3, decode_ctx=40)
    args = fused.materialize(3, "cpu")
    assert {k: tuple(v.shape) for k, v in args.items()} == \
        {k: s.shape for k, s in fused.args.items()}
    p_logits, _, d_logits = fused(**args)
    np.testing.assert_allclose(
        p_logits.numpy(), tf.forward(model, args["p_inputs"],
                                     args["p_positions"],
                                     last_only=True).numpy(), **TOL)
    assert d_logits.shape == (3, 1, cfg.vocab_padded)
    assert torch.isfinite(d_logits).all()


def test_cells_leave_out_the_mesh():
    model = _models("musicgen-large")[0]
    for name in ("train_4k", "long_500k"):
        with pytest.raises(NotImplementedError, match="mesh"):
            steps.build_cell(model, SHAPES[name])


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_entry_points_refuse_embeddings(arch):
    """Both serving entry points take tokens: they refuse an
    ``embed_stub`` model by name, before it loads."""
    for main in (serve_real.main, serve_mod.main):
        with pytest.raises(SystemExit):
            main(["--arch", arch, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="launch/steps.py"):
        serve_real.serve(_models(arch)[0], [])
