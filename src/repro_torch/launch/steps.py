"""Cell builders: (model x input shape x mesh) -> a step and the inputs it
takes.

Counterpart of ``repro/launch/steps.py``.

  train_4k    -> ``make_train_step`` (microbatches, remat; the state's
                 parameters and moments updated in place)
  prefill_32k -> ``forward(inputs, positions, return_aux, last_only)``
  decode_32k  -> ``decode_forward`` over a paged pool, each sequence's
                 block table one contiguous run of blocks, through
                 ``DecodeGraphs`` (captured once per shape on the card)
  long_500k   -> the decode cell with context-parallel KV: the pool's
                 blocks split over the sequence (``seq`` -> the data axis)
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

Meshes.  Every builder takes ``mesh`` (None: one device, no DTensor) and
``rules`` (default: the reference's for the cell, ``_rules``).
Under a mesh the cell places the model's parameters as DTensors by the
reference's rules (``_rules``, ``param_sharding`` with FSDP where
``_serve_fsdp`` says so for serving and always for training), its inputs
split over "batch", and its cache by ``cache_specs``; the model runs
under ``sharding.spmd()`` with ``constrain`` at the reference's places,
and the cell returns DTensors (``gather`` makes them whole).  The model
must have been made at the cell's TP degree (``tp_for``).  A decode
pool's blocks are split over the batch, or under context parallelism
over the sequence; each chip's block tables and state rows hold its own
ids.  On a one-chip mesh the decode cell's CUDA graphs capture the
chip's own program (its local parameters and cache, the same tensors);
on more chips the decode step runs eagerly.  The fused cell takes no
mesh of more than one chip: its ``unified_pd`` step has no split form.

The stub inputs.  Embeddings are unit normals.  Token positions count
from 0.  M-RoPE positions follow Qwen2-VL's layout (``mrope_positions``):
a text prefix, an image grid whose patches share one t and take their
row and column as h and w, then text again, each stream continuing after
the largest id so far; decode tokens continue the text.  The reference's
cells never feed a sampled token back, and an ``embed_stub`` model has
no token input, so every decode step (``decode_steps``) takes fresh
seeded inputs, one more position and one more cached token.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import sharding
from repro_torch.config import SHAPES, ShapeConfig
from repro_torch.kvcache import kv_pages_for
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ring_pages, ring_table
from repro_torch.models.decode_graph import DecodeGraphs, table_width
from repro_torch.perfmodel.hw import TPU_V5E, HardwareSpec
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_lib import (make_train_step,
                                            train_state_from_model)

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
# Mesh rules (the reference's, ``repro/launch/steps.py:52-101``)
# ---------------------------------------------------------------------------

SMALL_MODEL_PARAMS = 2_000_000_000


def _small_dp_only(cfg, shape: Optional[ShapeConfig]) -> bool:
    """Sub-2B models (xlstm-125m) replicate their weights and run pure
    data parallelism: at TP 16 their products would be 96 wide."""
    return cfg is not None and cfg.param_count() < SMALL_MODEL_PARAMS


def _rules(mesh, shape: ShapeConfig, cfg=None) -> sharding.ShardingRules:
    rules = sharding.rules_for_mesh(mesh)
    if _small_dp_only(cfg, shape):
        axes = (("pod", "data", "model") if "pod" in mesh.mesh_dim_names
                else ("data", "model"))
        if shape.global_batch % mesh.size():
            axes = axes[:-1]
        return dataclasses.replace(rules, model=None, expert=None,
                                   data=None, batch=axes)
    if shape.kind == "long_decode":
        # context parallelism: the cache's sequence over the data axis,
        # otherwise idle at batch 1
        return dataclasses.replace(rules, seq="data")
    if shape.kind == "train":
        # sequence parallelism: the inter-block residuals (and their
        # remat checkpoints) split S over the TP axis
        return dataclasses.replace(rules, seq="model")
    return rules


def tp_for(cfg, mesh, shape: Optional[ShapeConfig] = None) -> int:
    """The TP degree a cell's model is made at: 1 without a mesh and
    under the small-model DP-only policy, else the "model" axis."""
    if mesh is None or (shape is not None and _small_dp_only(cfg, shape)):
        return 1
    return sharding.mesh_sizes(mesh)["model"]


def _serve_fsdp(cfg, mesh, hw: HardwareSpec = TPU_V5E) -> bool:
    """Serve TP-only (no FSDP, whose weight all-gathers run at every
    decode token) whenever a chip's TP shard of the bf16 weights fits in
    three quarters of ``hw``'s memory.  ``TPU_V5E`` gives the reference's
    choices; ``H100`` the card's."""
    tp = sharding.mesh_sizes(mesh)["model"]
    return cfg.param_count() * 2 / tp > 0.75 * hw.hbm_bytes


class Placed:
    """A model placed on ``mesh`` for a cell of ``shape`` (or itself, with
    no mesh): ``model`` its parameters as DTensors, ``constrain`` the
    reference's hook, ``split`` an input over "batch", ``context`` what
    the model runs in."""

    def __init__(self, model, shape: ShapeConfig, mesh, *, fsdp: bool,
                 rules: Optional[sharding.ShardingRules] = None):
        self.mesh, self.cfg = mesh, model.cfg
        self.model, self.rules = model, None
        self.constrain = sharding.identity
        if mesh is None:
            return
        cfg = model.cfg
        tp = getattr(model, "tp", 1)
        if rules is None and tp != tp_for(cfg, mesh, shape):
            raise ValueError(f"{cfg.name} was made at tp {tp}; a "
                             f"{shape.name} cell on this mesh runs at tp "
                             f"{tp_for(cfg, mesh, shape)}")
        self.rules = rules or _rules(mesh, shape, cfg)
        self.pspecs = sharding.param_sharding(
            tf.param_specs(cfg, tp),
            {n: p.shape for n, p in model.named_parameters()}, mesh,
            rules=self.rules, fsdp=fsdp, periods=cfg.num_periods)
        self.model = sharding.shard_module(model, mesh, self.pspecs)
        self.constrain = sharding.make_constrain(mesh, self.rules)

    def pspec(self, spec, shape):
        return sharding.spec_to_pspec(spec, self.mesh, self.rules, shape)

    def split(self, t, spec=None):
        """``t`` placed by ``spec`` (default: dim 0 over "batch")."""
        if self.mesh is None or t is None:
            return t
        spec = spec or ("batch",) + (None,) * (t.dim() - 1)
        return sharding.place(t, self.mesh, sharding.to_placements(
            self.pspec(spec, t.shape), self.mesh))

    def context(self):
        return sharding.spmd() if self.mesh is not None else \
            contextlib.nullcontext()


def gather(x):
    """DTensors made whole (in tuples, lists and dicts too)."""
    if sharding.is_dtensor(x):
        return x.full_tensor()
    if isinstance(x, (tuple, list)):
        return type(x)(gather(t) for t in x)
    if isinstance(x, dict):
        return {k: gather(v) for k, v in x.items()}
    return x


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
    placed: Any = None
    state: Any = None

    @property
    def arch(self) -> str:
        return self.cfg.name

    def materialize(self, seed: int, device) -> Dict[str, torch.Tensor]:
        return self.draw(np.random.default_rng(seed), torch.device(device))

    def __call__(self, **args):
        return self.step_fn(**args)


def _model_dtype(model):
    return model.tok.dtype


def build_prefill_cell(model, shape: ShapeConfig, *, mesh=None,
                       fsdp: Optional[bool] = None,
                       hw: HardwareSpec = TPU_V5E, rules=None,
                       impl: str = "kernel") -> Cell:
    """``forward`` with ``return_aux`` and ``last_only``: (logits (B,1,Vp),
    per-layer K/V or final state)."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    if mesh is not None and fsdp is None:
        fsdp = _serve_fsdp(cfg, mesh, hw)
    placed = Placed(model, shape, mesh, fsdp=fsdp, rules=rules)

    def prefill_step(inputs, positions):
        with placed.context():
            return tf.forward(placed.model, placed.split(inputs),
                              placed.split(positions), impl=impl,
                              return_aux=True, last_only=True,
                              constrain=placed.constrain)

    def draw(rng, device):
        return _prompt_args(cfg, rng, B, S, device, _model_dtype(model))

    ins = input_specs(cfg, shape)
    return Cell(cfg, shape.name, prefill_step,
                {"inputs": ins["inputs"], "positions": ins["positions"]},
                draw, placed=placed)


class _PagedCache:
    """A decode batch's cache: the pools of ``B`` sequences of up to
    ``S`` tokens, each sequence's block table one contiguous run of
    blocks (its ring's first W / page under a sliding window, the only
    blocks it takes), padded to ``table_width``, and state rows 0..B-1.

    Under a mesh (``placed``) the whole cache is made as without one and
    then placed (``place``): each pool's blocks over "batch" when the
    batch divides, else over "seq" (context parallelism: batch 1, each
    chip a slice of the sequence, ``offsets`` its first positions), its
    KV heads as ``cache_specs`` say; the tables and state rows hold each
    chip's own ids."""

    def __init__(self, model, B: int, S: int, page: int, placed=None):
        cfg, dev = model.cfg, model.tok.device
        self.B, self.S, self.page = B, S, page
        pages = ring_pages(cfg.sliding_window, page) or kv_pages_for(S, page)
        self.whole = tf.init_cache(cfg, B * pages, page, B, device=dev,
                                   dtype=_model_dtype(model),
                                   tp=getattr(model, "tp", 1))
        self.placed, self.offsets = placed, None
        self.whole_blocks = B * pages
        split = self._split(cfg, B, pages)    # chips sharing the blocks
        per = B * pages // split
        rows = [ring_table(list(range(b * pages, (b + 1) * pages)),
                           cfg.sliding_window, page) for b in range(B)]
        if self.cp:
            rows = [list(range(per))]
        else:
            rows = [[i % per for i in r] for r in rows]
        width = table_width(len(rows[0]), cfg.sliding_window, page)
        self.tables = torch.tensor([r + [0] * (width - len(r))
                                    for r in rows], dtype=torch.int32,
                                   device=dev)
        self.slots = torch.arange(B, device=dev) % (B // self.bsplit)
        self.place()

    def _split(self, cfg, B, pages) -> int:
        """Sets ``bsplit`` (chips splitting the batch) and ``cp`` (the pool
        split over the sequence); returns the chips sharing the blocks."""
        self.bsplit, self.cp, self.block_axes = 1, False, None
        placed = self.placed
        if placed is None or placed.mesh is None:
            return 1
        mesh, rules = placed.mesh, placed.rules
        n_b = sharding._axis_size(mesh, rules.batch)
        n_s = sharding._axis_size(mesh, rules.seq)
        if B % n_b == 0:
            self.bsplit, self.block_axes = n_b, rules.batch
            return n_b
        if n_s > 1 and pages % n_s == 0:
            if B != 1:
                raise NotImplementedError("context-parallel KV of more "
                                          "than one sequence")
            self.cp, self.block_axes = True, rules.seq
            return n_s
        return 1

    def place(self) -> None:
        """``layers`` (what the cell's step reads): the cache placed on
        the mesh, or the whole cache without one."""
        placed = self.placed
        if placed is None or placed.mesh is None:
            self.layers, self.tables_in, self.slots_in = \
                self.whole, self.tables, self.slots
            return
        mesh = placed.mesh
        specs = tf.cache_specs(placed.cfg, getattr(placed.model, "tp", 1))
        out = []
        for layer, spec in zip(self.whole, specs):
            d = {}
            for k, t in layer.items():
                ps = list(placed.pspec(spec[k][1:], t.shape[1:])) \
                    if isinstance(spec[k][0], tuple) else None
                if ps is not None:     # a pool: its blocks as decided
                    pspec = (self.block_axes,) + tuple(ps)
                else:                  # state rows: split with the batch
                    pspec = placed.pspec(spec[k], t.shape) \
                        if self.bsplit > 1 else \
                        (None,) + tuple(placed.pspec(spec[k][1:],
                                                     t.shape[1:]))
                d[k] = sharding.place(t, mesh, sharding.to_placements(
                    pspec, mesh))
            out.append(d)
        self.layers = out
        if self.cp:
            self.tables_in = sharding.place(
                self.tables, mesh, sharding.replicated(mesh))
            n = sharding._axis_size(mesh, self.block_axes)
            span = self.whole_blocks // n * self.page
            self.offsets = sharding.place(
                torch.arange(n, device=self.tables.device) * span, mesh,
                sharding.to_placements((self.block_axes,), mesh))
            self.slots_in = sharding.place(self.slots, mesh,
                                           sharding.replicated(mesh))
        else:
            self.tables_in = placed.split(self.tables)
            self.slots_in = placed.split(self.slots)

    def fill(self, seed: int) -> None:
        """Every K/V and state leaf drawn from ``seed``: unit normals (the
        state's stabilisers m too: any finite value is a state)."""
        dev = self.tables.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for layer in self.whole:
            for t in layer.values():
                t.normal_(generator=gen)
        self.place()

    def lens(self, rng: np.random.Generator) -> np.ndarray:
        """Cached tokens per sequence, in [S/2, S - DECODE_ROOM]."""
        hi = max(self.S - DECODE_ROOM, 1)
        return rng.integers(min(self.S // 2, hi), hi + 1, size=self.B)


def build_decode_cell(model, shape: ShapeConfig, *, mesh=None,
                      page: int = PAGE, fsdp: Optional[bool] = None,
                      hw: HardwareSpec = TPU_V5E, rules=None,
                      impl: str = "kernel") -> Cell:
    """One decode step of ``shape.global_batch`` sequences, each with up
    to ``shape.seq_len`` tokens cached in the paged pool (``long_500k``:
    context-parallel KV under a mesh).  With ``impl`` "kernel" the step
    goes through ``DecodeGraphs`` (a CUDA graph per shape on the card;
    eager on the CPU; under a mesh of one chip the chip's own program),
    with "ref" through the plain ``decode_forward``.  Returns the logits
    (B, 1, Vp), valid until the next step."""
    cfg = model.cfg
    B, S = shape.global_batch, shape.seq_len
    if mesh is not None and fsdp is None:
        fsdp = _serve_fsdp(cfg, mesh, hw)
    placed = Placed(model, shape, mesh, fsdp=fsdp, rules=rules)
    cache = _PagedCache(model, B, S, page, placed)
    graphs = None
    if impl == "kernel" and (mesh is None or mesh.size() == 1):
        # one chip: its program is the whole one, on the same tensors
        graphs = DecodeGraphs(model, cache.whole, max_batch=B)

    def serve_step(inputs, positions, seq_lens):
        if graphs is not None:
            graphs.step(inputs, seq_lens, cache.tables, cache.slots,
                        positions)
            return graphs.logits
        with placed.context():
            return tf.decode_forward(
                placed.model, placed.split(inputs), placed.split(positions),
                cache.layers, cache.tables_in, placed.split(seq_lens),
                cache.slots_in, impl=impl, constrain=placed.constrain,
                cp_offsets=cache.offsets)[0]

    def draw(rng, device):
        cache.fill(int(rng.integers(2 ** 31)))
        return _decode_args(cfg, rng, B, cache.lens(rng), device,
                            _model_dtype(model))

    return Cell(cfg, shape.name, serve_step, input_specs(cfg, shape), draw,
                cache, graphs, placed)


def eager_decode_step(cell: Cell, inputs, positions, seq_lens,
                      impl: str = "kernel"):
    """A decode cell's step run eagerly through its placed model (DTensors
    under a mesh, however many chips), not through its graphs: the
    program the graphs of a one-chip mesh stand in for."""
    placed, cache = cell.placed, cell.cache
    with placed.context():
        return tf.decode_forward(
            placed.model, placed.split(inputs), placed.split(positions),
            cache.layers, cache.tables_in, placed.split(seq_lens),
            cache.slots_in, impl=impl, constrain=placed.constrain,
            cp_offsets=cache.offsets)[0]


def build_fused_pd_cell(model, *, mesh=None, prefill_batch: int = 2,
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
    if mesh is not None and mesh.size() > 1:
        raise NotImplementedError("the fused cell on a mesh of more than "
                                  "one chip (unified_pd has no split form)")
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


def build_train_cell(model, shape: ShapeConfig, *, mesh=None,
                     fsdp: bool = True, opt: Optional[OptConfig] = None,
                     microbatches: Optional[int] = None,
                     remat: bool = True, rules=None) -> Cell:
    """One ``make_train_step`` of ``model`` (trainable) over a batch of
    ``shape``: the state (``cell.state``, parameters and moments placed
    as the reference's ``train_state_specs``) is updated in place.  The
    optimizer keeps its moments and accumulates its gradients in the
    config's ``opt_dtype``, and the microbatches adapt to the mesh as the
    reference's: each one still splits over every data-parallel row.
    Returns the step's metrics."""
    cfg = model.cfg
    placed = Placed(model, shape, mesh, fsdp=fsdp, rules=rules)
    opt = opt or OptConfig(moment_dtype=cfg.opt_dtype,
                           grad_accum_dtype=cfg.opt_dtype)
    dp = 1 if mesh is None else mesh.size() // getattr(model, "tp", 1)
    mb = microbatches or max(1, min(cfg.train_microbatches,
                                    shape.global_batch // dp))
    step = make_train_step(cfg, opt, microbatches=mb, remat=remat,
                           constrain=placed.constrain)
    cell = None

    def train_step(inputs, labels, positions):
        with placed.context():
            cell.state, metrics = step(cell.state, {
                "inputs": placed.split(inputs),
                "labels": placed.split(labels),
                "positions": placed.split(positions)})
        return metrics

    def draw(rng, device):
        B, S = shape.global_batch, shape.seq_len
        dtype = _model_dtype(model)
        args = _prompt_args(cfg, rng, B, S, device, dtype)
        args["labels"] = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, size=(B, S)).astype(np.int32)).to(device)
        return args

    with placed.context():
        state = train_state_from_model(placed.model, opt)
    cell = Cell(cfg, shape.name, train_step, input_specs(cfg, shape), draw,
                placed=placed, state=state)
    cell.microbatches = mb
    return cell


def build_cell(model, shape: ShapeConfig, mesh=None, **kw) -> Cell:
    if shape.kind == "train":
        return build_train_cell(model, shape, mesh=mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(model, shape, mesh=mesh, **kw)
    if shape.kind in ("decode", "long_decode"):
        return build_decode_cell(model, shape, mesh=mesh, **kw)
    raise ValueError(f"{shape.name}: no such cell kind {shape.kind!r}")


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
