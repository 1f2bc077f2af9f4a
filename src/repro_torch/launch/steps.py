"""Cell builders: (model x input shape) -> a step and the inputs it takes,
on one card.

Counterpart of ``repro/launch/steps.py``, restricted to what runs without
a mesh: the serving cells.

  prefill_32k -> ``forward(inputs, positions, return_aux, last_only)``
  decode_32k  -> ``decode_forward`` over a paged pool, each sequence's
                 block table one contiguous run of blocks, through
                 ``DecodeGraphs`` (captured once per shape on the card)
  fused_pd    -> ``fused_pd_forward``: a prefill batch and a decode batch
                 in one step, the RAPID concurrent step

A ``Cell`` holds its step and, as the reference's holds
``ShapeDtypeStruct``s, the shapes and dtypes of its inputs (``args``);
``materialize(seed, device)`` draws them.  ``input_specs`` gives the
reference's shapes and dtypes for every arch and shape: tokens (B, S)
int32, or an ``embed_stub`` model's embeddings (B, S, d) in its dtype;
positions (B, S) int32, or M-RoPE's (B, S, 3).  A decode or fused cell
owns its cache (the reference passes it as an argument and donates it),
and ``materialize`` fills it too: K/V and recurrent state drawn from the
seed, as the reference's dry-run takes any cache of the right shape.

The stub inputs.  Embeddings are unit normals.  Token positions count
from 0.  M-RoPE positions follow Qwen2-VL's layout (``mrope_positions``):
a text prefix, an image grid whose patches share one t and take their
row and column as h and w, then text again, each stream continuing after
the largest id so far; decode tokens continue the text.  The reference's
cells never feed a sampled token back, and an ``embed_stub`` model has
no token input, so every decode step (``decode_steps``) takes fresh
seeded inputs, one more position and one more cached token.

What it leaves out: meshes, shardings and donation; ``build_train_cell``
and ``long_500k`` wait for A10's mesh half (``build_cell`` raises).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict

import numpy as np
import torch

from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.kvcache import kv_pages_for
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ring_table
from repro_torch.models.decode_graph import DecodeGraphs, table_width

PAGE = 16
# a decode cell's sequences hold between half its length and this many
# tokens short of it, so that ``decode_steps`` has room to write
DECODE_ROOM = 16


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    shape: tuple
    dtype: torch.dtype


def _spec(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(shape), getattr(torch, dtype)
                      if isinstance(dtype, str) else dtype)


def _input_tokens(cfg, B: int, S: int) -> TensorSpec:
    if cfg.frontend == "embed_stub":
        return _spec((B, S, cfg.d_model), cfg.dtype)
    return _spec((B, S), "int32")


def _positions(cfg, B: int, S: int) -> TensorSpec:
    if cfg.rope_type == "mrope":
        return _spec((B, S, 3), "int32")
    return _spec((B, S), "int32")


def input_specs(cfg, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """The shapes and dtypes of every model input of a cell, as the
    reference's ``input_specs``."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"inputs": _input_tokens(cfg, B, S),
                "labels": _spec((B, S), "int32"),
                "positions": _positions(cfg, B, S)}
    if shape.kind == "prefill":
        return {"inputs": _input_tokens(cfg, B, S),
                "positions": _positions(cfg, B, S)}
    # decode / long_decode: one new token against an S-token cache
    return {"inputs": _input_tokens(cfg, B, 1),
            "positions": _positions(cfg, B, 1),
            "seq_lens": _spec((B,), "int32")}


def cells_for_arch(cfg):
    """The shape list for an arch, as the reference's: decode/long
    shapes obey the sub-quadratic / family rules."""
    shapes = [SHAPES["train_4k"], SHAPES["prefill_32k"],
              SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        shapes.append(SHAPES["long_500k"])
    return shapes


# ---------------------------------------------------------------------------
# Stub inputs
# ---------------------------------------------------------------------------


def mrope_layout(n: int):
    """(text prefix, image side g) of an ``n``-token M-RoPE prompt."""
    g = math.isqrt(n // 2)
    return n // 8, g


def mrope_positions(n: int) -> np.ndarray:
    """(n, 3) int32 (t, h, w) ids of an n-token prompt: a text prefix of
    n // 8 tokens (t = h = w = i), an image of g x g patches (g the
    largest with g^2 <= n / 2) at t = a and h, w = a + row, a + col (a the
    prefix's length), then text from the largest id + 1."""
    a, g = mrope_layout(n)
    text = np.arange(a)
    rows, cols = np.divmod(np.arange(g * g), g)
    image = np.stack([np.full(g * g, a), a + rows, a + cols], axis=1)
    rest = a + g + np.arange(n - a - g * g)
    return np.concatenate([np.stack([text] * 3, axis=1), image,
                           np.stack([rest] * 3, axis=1)]).astype(np.int32)


def next_position(cfg, n: int) -> int:
    """The position id of the token after an n-token prompt (every stream
    the same: it is text)."""
    if cfg.rope_type != "mrope":
        return n
    a, g = mrope_layout(n)
    return n - g * g + g


def _positions_of(cfg, lens, S: int) -> np.ndarray:
    """Positions (B, S[, 3]) of prompts of S tokens (``lens`` None), or
    (B, 1[, 3]) of the next token after ``lens`` (B,) cached tokens."""
    if lens is None:
        if cfg.rope_type == "mrope":
            one = mrope_positions(S)
        else:
            one = np.arange(S, dtype=np.int32)
        return np.ascontiguousarray(np.broadcast_to(one, (1,) + one.shape))
    nxt = np.array([next_position(cfg, int(n)) for n in lens], np.int32)
    if cfg.rope_type == "mrope":
        return np.repeat(nxt[:, None, None], 3, axis=2)
    return nxt[:, None]


def draw_inputs(cfg, rng: np.random.Generator, B: int, S: int, device,
                dtype) -> torch.Tensor:
    """Tokens (B, S) int32, or unit-normal embeddings (B, S, d) in
    ``dtype``, from ``rng``."""
    if cfg.frontend == "embed_stub":
        x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        return torch.from_numpy(x).to(device=device, dtype=dtype)
    return torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(device)


def _prompt_args(cfg, rng, B, S, device, dtype, prefix=""):
    pos = np.repeat(_positions_of(cfg, None, S), B, axis=0)
    return {prefix + "inputs": draw_inputs(cfg, rng, B, S, device, dtype),
            prefix + "positions": torch.from_numpy(pos).to(device)}


def _decode_args(cfg, rng, B, lens, device, dtype, prefix=""):
    return {prefix + "inputs": draw_inputs(cfg, rng, B, 1, device, dtype),
            prefix + "positions": torch.from_numpy(
                _positions_of(cfg, lens, 1)).to(device),
            "seq_lens": torch.from_numpy(lens.astype(np.int32)).to(device)}


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    """``step_fn(**args)`` runs the cell; ``args`` are the shapes and
    dtypes of its inputs; ``materialize`` draws them (and fills the
    cell's cache, where it has one).  A decode cell on the kernels keeps
    its ``DecodeGraphs`` in ``graphs``."""
    cfg: Any
    shape: str
    step_fn: Callable[..., Any]
    args: Dict[str, TensorSpec]
    draw: Callable[[np.random.Generator, torch.device],
                   Dict[str, torch.Tensor]]
    cache: Any = None
    graphs: Any = None

    @property
    def arch(self) -> str:
        return self.cfg.name

    def materialize(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return self.draw(np.random.default_rng(seed), torch.device(device))

    def __call__(self, **args):
        return self.step_fn(**args)


def _model_dtype(model):
    return model.tok.dtype


def build_prefill_cell(model, shape: ShapeConfig, *,
                       impl: str = "kernel") -> Cell:
    """``forward`` with ``return_aux`` and ``last_only``: (logits (B,1,Vp),
    per-layer K/V or final state)."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len

    def prefill_step(inputs, positions):
        return tf.forward(model, inputs, positions, impl=impl,
                          return_aux=True, last_only=True)

    def draw(rng, device):
        return _prompt_args(cfg, rng, B, S, device, _model_dtype(model))

    ins = input_specs(cfg, shape)
    return Cell(cfg, shape.name, prefill_step,
                {"inputs": ins["inputs"], "positions": ins["positions"]},
                draw)


class _PagedCache:
    """A decode batch's cache: the pools of ``B`` sequences of up to
    ``S`` tokens, each sequence's block table one contiguous run of
    blocks (its ring's first W / page under a sliding window), padded to
    ``table_width``, and state rows 0..B-1."""

    def __init__(self, model, B: int, S: int, page: int):
        cfg, dev = model.cfg, model.tok.device
        self.B, self.S, self.page = B, S, page
        pages = kv_pages_for(S, page)
        self.layers = tf.init_cache(cfg, B * pages, page, B, device=dev,
                                    dtype=_model_dtype(model))
        rows = [ring_table(list(range(b * pages, (b + 1) * pages)),
                           cfg.sliding_window, page) for b in range(B)]
        width = table_width(len(rows[0]), cfg.sliding_window, page)
        self.tables = torch.tensor([r + [0] * (width - len(r))
                                    for r in rows], dtype=torch.int32,
                                   device=dev)
        self.slots = torch.arange(B, device=dev)

    def fill(self, seed: int) -> None:
        """Every K/V and state leaf drawn from ``seed``: unit normals (the
        state's stabilisers m too: any finite value is a state)."""
        dev = self.tables.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for layer in self.layers:
            for t in layer.values():
                t.normal_(generator=gen)

    def lens(self, rng: np.random.Generator) -> np.ndarray:
        """Cached tokens per sequence, in [S/2, S - DECODE_ROOM]."""
        hi = max(self.S - DECODE_ROOM, 1)
        return rng.integers(min(self.S // 2, hi), hi + 1, size=self.B)


def build_decode_cell(model, shape: ShapeConfig, *, page: int = PAGE,
                      impl: str = "kernel") -> Cell:
    """One decode step of ``shape.global_batch`` sequences, each with up
    to ``shape.seq_len`` tokens cached in the paged pool.  With ``impl``
    "kernel" the step goes through ``DecodeGraphs`` (a CUDA graph per
    shape on the card; eager on the CPU), with "ref" through the plain
    ``decode_forward``.  Returns the logits (B, 1, Vp), valid until the
    next step."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    cache = _PagedCache(model, B, S, page)
    graphs = DecodeGraphs(model, cache.layers, max_batch=B) \
        if impl == "kernel" else None

    def serve_step(inputs, positions, seq_lens):
        if graphs is not None:
            graphs.step(inputs, seq_lens, cache.tables, cache.slots,
                        positions)
            return graphs.logits
        return tf.decode_forward(model, inputs, positions, cache.layers,
                                 cache.tables, seq_lens, cache.slots,
                                 impl=impl)[0]

    def draw(rng, device):
        cache.fill(int(rng.integers(2 ** 31)))
        return _decode_args(cfg, rng, B, cache.lens(rng), device,
                            _model_dtype(model))

    return Cell(cfg, shape.name, serve_step, input_specs(cfg, shape), draw,
                cache, graphs)


def build_fused_pd_cell(model, *, prefill_batch: int = 2,
                        prefill_seq: int = 4096, decode_batch: int = 64,
                        decode_ctx: int = 8192, page: int = PAGE,
                        f_decode: float = 0.5,
                        impl: str = "kernel") -> Cell:
    """The RAPID concurrent step: ``prefill_batch`` prompts of
    ``prefill_seq`` tokens and one decode step of ``decode_batch``
    sequences with up to ``decode_ctx`` tokens cached, through
    ``fused_pd_forward`` (one ``unified_pd`` launch per attention layer,
    ``f_decode`` its decode share).  Returns (p_logits, aux, d_logits)."""
    cfg = model.cfg
    Bp, Sp, Bd = prefill_batch, prefill_seq, decode_batch
    cache = _PagedCache(model, Bd, decode_ctx, page)

    def fused_step(p_inputs, p_positions, d_inputs, d_positions, seq_lens):
        p_logits, aux, d_logits, _ = tf.fused_pd_forward(
            model, p_inputs, p_positions, d_inputs, d_positions,
            cache.layers, cache.tables, seq_lens, cache.slots,
            f_decode=f_decode, impl=impl)
        return p_logits, aux, d_logits

    def draw(rng, device):
        dtype = _model_dtype(model)
        cache.fill(int(rng.integers(2 ** 31)))
        return {**_prompt_args(cfg, rng, Bp, Sp, device, dtype, "p_"),
                **_decode_args(cfg, rng, Bd, cache.lens(rng), device,
                               dtype, "d_")}

    args = {"p_inputs": _input_tokens(cfg, Bp, Sp),
            "p_positions": _positions(cfg, Bp, Sp),
            "d_inputs": _input_tokens(cfg, Bd, 1),
            "d_positions": _positions(cfg, Bd, 1),
            "seq_lens": _spec((Bd,), "int32")}
    return Cell(cfg, "fused_pd", fused_step, args, draw, cache)


def build_cell(model, shape: ShapeConfig, **kw) -> Cell:
    if shape.kind == "prefill":
        return build_prefill_cell(model, shape, **kw)
    if shape.kind == "decode":
        return build_decode_cell(model, shape, **kw)
    raise NotImplementedError(
        f"{shape.name} ({shape.kind}): the train cell and the long-context "
        f"decode need a mesh (ROADMAP A10's mesh half)")


def decode_steps(cell: Cell, args: Dict[str, torch.Tensor], steps: int,
                 seed: int) -> list:
    """``steps`` decode steps of a decode cell from ``args``: step i takes
    fresh inputs drawn from (``seed``, i), the positions one further and
    one more cached token.  Returns each step's (inputs, logits (a
    copy))."""
    out, args = [], dict(args)
    for i in range(steps):
        if i:
            x = args["inputs"]
            args = dict(args, inputs=draw_inputs(
                cell.cfg, np.random.default_rng((seed, i)), x.shape[0], 1,
                x.device, x.dtype), positions=args["positions"] + 1,
                seq_lens=args["seq_lens"] + 1)
        out.append((args, cell(**args).clone()))
    return out
