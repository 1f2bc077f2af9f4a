"""Model and serving configuration for the port: the ``ModelConfig``
fields and the helpers the ported modules and the perfmodel read, the
serving engine's ``SLOConfig`` and ``ServeConfig``, the cells' input
shapes (``ShapeConfig``, ``SHAPES``), and the architecture registry.

A copy of the parts of ``repro/config.py`` the port needs, with the
MoE, Mamba and xLSTM sub-configs.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    partition: str = "auto"


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class XLSTMConfig:
    # which positions within the layer pattern are sLSTM (rest are mLSTM)
    proj_factor: float = 2.0
    num_heads: int = 4


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str               # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # Per-layer mixer pattern, cycled over layers: entries in
    # {"attn", "mamba", "mlstm", "slstm"}.
    layer_pattern: tuple = ("attn",)
    # Per-layer FFN pattern cycled over layers: entries in {"dense","moe","none"}.
    ffn_pattern: tuple = ("dense",)
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    qkv_bias: bool = False
    rope_type: str = "rope"   # rope | mrope | none
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None
    frontend: str = "token"   # token | embed_stub (audio/vlm backbones)
    norm_eps: float = 1e-5
    act: str = "silu"
    ffn_glu: bool = True      # SwiGLU-style 3-matrix FFN vs plain 2-matrix
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    train_microbatches: int = 1
    source: str = ""          # provenance note [arXiv/hf; tier]

    def heads_padded(self, tp: int) -> int:
        return int(math.ceil(self.num_heads / tp) * tp)

    def kv_heads_padded(self, tp: int) -> int:
        if self.kv_shard_mode(tp) == "heads":
            return int(math.ceil(self.num_kv_heads / tp) * tp)
        return self.num_kv_heads

    def kv_shard_mode(self, tp: int) -> str:
        """'heads' when padding KV heads costs <= 2x, else 'seq'."""
        padded = math.ceil(self.num_kv_heads / tp) * tp
        return "heads" if padded <= 2 * self.num_kv_heads else "seq"

    @property
    def vocab_padded(self) -> int:
        return int(math.ceil(self.vocab_size / 256) * 256)

    @property
    def period(self) -> int:
        """Length of the repeating layer group."""
        p = _lcm(len(self.layer_pattern), len(self.ffn_pattern))
        if self.num_layers % p:
            raise ValueError(
                f"{self.name}: num_layers={self.num_layers} not divisible by "
                f"pattern period {p}")
        return p

    @property
    def num_periods(self) -> int:
        return self.num_layers // self.period

    def mixer_at(self, pos: int) -> str:
        return self.layer_pattern[pos % len(self.layer_pattern)]

    def ffn_at(self, pos: int) -> str:
        return self.ffn_pattern[pos % len(self.ffn_pattern)]

    # NOTE on the ``self.__dict__`` memos below: the serving perfmodel
    # prices every simulated step through these derived scalars, and each
    # walks the full layer pattern.  They are pure in the (frozen) config,
    # so the first result is stashed in the instance ``__dict__`` — the
    # generated ``__eq__``/``__hash__`` only see declared fields, so the
    # memo never leaks into config identity, and ``object.__setattr__``
    # is not needed because the dict itself is mutable.

    @property
    def attn_layer_count(self) -> int:
        v = self.__dict__.get("_attn_layer_count")
        if v is None:
            v = sum(1 for i in range(self.num_layers)
                    if self.mixer_at(i) == "attn")
            self.__dict__["_attn_layer_count"] = v
        return v

    @property
    def d_inner(self) -> int:
        m = self.mamba or MambaConfig()
        return m.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        m = self.mamba or MambaConfig()
        return m.dt_rank or math.ceil(self.d_model / 16)

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can run 500K-token decode: SSM/hybrid
        (recurrent state + few attn layers) or sliding-window attention
        (bounded KV).  Pure full-attention archs skip long_500k
        (DESIGN.md §5 records the skips)."""
        if self.family in ("ssm", "hybrid"):
            return True
        if not any(m == "attn" for m in self.layer_pattern):
            return True
        return self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (logical, unpadded)."""
        v = self.__dict__.get("_param_count")
        if v is None:
            v = self.__dict__["_param_count"] = self._param_count()
        return v

    def _param_count(self) -> int:
        d, L = self.d_model, self.num_layers
        D = self.head_dim
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d
        for i in range(L):
            mx = self.mixer_at(i)
            if mx == "attn":
                total += d * (self.num_heads * D) * 2  # q, o
                total += d * (self.num_kv_heads * D) * 2  # k, v
                if self.qkv_bias:
                    total += (self.num_heads + 2 * self.num_kv_heads) * D
            elif mx == "mamba":
                din = self.d_inner
                m = self.mamba or MambaConfig()
                total += d * 2 * din            # in_proj
                total += din * m.d_conv         # conv
                total += din * (self.dt_rank + 2 * m.d_state)  # x_proj
                total += self.dt_rank * din     # dt_proj
                total += din * m.d_state + din  # A, D
                total += din * d                # out_proj
            elif mx in ("mlstm", "slstm"):
                x = self.xlstm or XLSTMConfig()
                if mx == "mlstm":
                    din = int(x.proj_factor * d)
                    total += d * din * 2 + din * d  # up(2x), down
                    total += din * din * 3          # q,k,v inner
                    total += 3 * din                # i,f,o gates (per-ch)
                else:
                    total += 4 * d * d * 2          # 4 gates, x & recurrent
            fn = self.ffn_at(i)
            if fn == "dense":
                total += (3 if self.ffn_glu else 2) * d * self.d_ff
            elif fn == "moe":
                assert self.moe is not None
                total += d * self.moe.num_experts  # router
                total += self.moe.num_experts * 3 * d * self.moe.d_ff_expert
            total += 2 * d  # norms
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        v = self.__dict__.get("_active_param_count")
        if v is None:
            v = self.__dict__["_active_param_count"] = \
                self._active_param_count()
        return v

    def _active_param_count(self) -> int:
        if self.moe is None:
            return self.param_count()
        total = self.param_count()
        moe_layers = sum(1 for i in range(self.num_layers)
                         if self.ffn_at(i) == "moe")
        full = moe_layers * self.moe.num_experts * 3 * self.d_model * \
            self.moe.d_ff_expert
        active = moe_layers * self.moe.top_k * 3 * self.d_model * \
            self.moe.d_ff_expert
        return total - full + active

    def kv_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Eq. (1) of the paper: 2 * L_attn * H_kv * D * E per token."""
        key = ("_kv_bytes_per_token", dtype_bytes)
        v = self.__dict__.get(key)
        if v is None:
            v = self.__dict__[key] = 2 * self.attn_layer_count * \
                self.num_kv_heads * self.head_dim * dtype_bytes
        return v

    def state_bytes_per_seq(self, dtype_bytes: int = 2) -> int:
        """Recurrent-state bytes per sequence (SSM/xLSTM layers)."""
        key = ("_state_bytes_per_seq", dtype_bytes)
        v = self.__dict__.get(key)
        if v is None:
            v = self.__dict__[key] = \
                self._state_bytes_per_seq(dtype_bytes)
        return v

    def _state_bytes_per_seq(self, dtype_bytes: int = 2) -> int:
        total = 0
        m = self.mamba or MambaConfig()
        x = self.xlstm or XLSTMConfig()
        for i in range(self.num_layers):
            mx = self.mixer_at(i)
            if mx == "mamba":
                total += (self.d_inner * m.d_state +
                          self.d_inner * m.d_conv) * dtype_bytes
            elif mx == "mlstm":
                din = int(x.proj_factor * self.d_model)
                hd = din // x.num_heads
                total += (x.num_heads * hd * hd + 2 * din) * dtype_bytes
            elif mx == "slstm":
                total += 4 * self.d_model * dtype_bytes
        return total


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}


@dataclass(frozen=True)
class SLOConfig:
    itl_ms: float = 100.0           # inter-token latency ceiling
    ttft_base_s: float = 1.0        # TTFT ceiling for <=1000 prompt tokens
    ttft_tokens_per_ceiling: int = 1000  # +1s ceiling per 1000 tokens


@dataclass(frozen=True)
class ServeConfig:
    """Serving-engine configuration (one engine instance)."""
    mode: str = "rapid"             # rapid | hybrid | disagg
    chips: int = 8                  # chips per serving instance
    slo: SLOConfig = field(default_factory=SLOConfig)
    max_batch_slots: int = 64       # decode batch slots
    max_seq_len: int = 32_768
    page_size: int = 16             # tokens per KV page
    kv_reserve_frac: float = 0.05   # HBM held back from the KV pool
    chunk_size: int = 512           # hybrid batching prefill chunk
    token_budget: int = 2048        # hybrid per-iteration token budget
    prefill_max_tokens: int = 16_384  # rapid: max prompt tokens per prefill step
    # disagg split (prefill chips, decode chips)
    disagg_split: tuple = (4, 4)
    kv_transfer_gbps: float = 50.0  # ICI link for intra-node KV transfer
    # session prefix cache: fraction of the decode pool a finished
    # session's KV may keep occupying so the next turn skips re-prefill
    # of the shared prefix.  Inert (no blocks retained) unless requests
    # carry session ids, so the default single-class path is unchanged.
    session_cache_frac: float = 0.25
    # adaptive resource manager
    overalloc_decode_bs_limit: int = 16  # Fig 7 crossover (profiled)
    scheduler_overhead_ms: float = 2.0   # CPU work per step (sync path)
    async_scheduling: bool = True


@dataclass(frozen=True)
class OneCardServeConfig(ServeConfig):
    """The port's replica on one card (ROADMAP C4): a split-pool engine's
    two KV pools share the card and its one copy of the weights, each with
    half of what the card holds for KV, and the prefill pool also holds a
    finished prefill's staged pages until they join the decode pool.  Only
    the launcher's ``serve_config`` builds it; a ``ServeConfig`` of any
    ``chips`` and ``disagg_split`` keeps the reference's pools."""


ARCH_REGISTRY: dict = {}
_REDUCED_REGISTRY: dict = {}
_ONE_CARD_REGISTRY: dict = {}


def register(config: ModelConfig, reduced: Callable[[], ModelConfig],
             one_card: Optional[Callable[[], ModelConfig]] = None):
    """``one_card``: the cut of ``config`` that one 80 GB H100 serves, for
    a model whose published config does not fit one."""
    ARCH_REGISTRY[config.name] = config
    _REDUCED_REGISTRY[config.name] = reduced
    if one_card is not None:
        _ONE_CARD_REGISTRY[config.name] = one_card


def get_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    if arch not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[arch]


def get_reduced_config(arch: str) -> ModelConfig:
    _ensure_loaded()
    if arch not in _REDUCED_REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_REGISTRY)}")
    return _REDUCED_REGISTRY[arch]()


def get_one_card_config(arch: str) -> ModelConfig:
    """The published config, or its registered one-card cut where one
    card cannot hold it (every width kept; the cut is the config's)."""
    _ensure_loaded()
    if arch in _ONE_CARD_REGISTRY:
        return _ONE_CARD_REGISTRY[arch]()
    return get_config(arch)


def list_archs():
    _ensure_loaded()
    return sorted(ARCH_REGISTRY)


def _ensure_loaded():
    if not ARCH_REGISTRY:
        importlib.import_module("repro_torch.configs")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
