"""Model configuration for the port: the ``ModelConfig`` fields and the
helpers the ported modules read, plus the architecture registry.

A copy of the parts of ``repro/config.py`` the port needs.  The MoE and
Mamba sub-configs are copied as data; the xLSTM one stays ``None`` until
the slice that ports that mixer brings its class.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass
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
    xlstm: Optional[object] = None
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

    @property
    def d_inner(self) -> int:
        m = self.mamba or MambaConfig()
        return m.expand * self.d_model

    @property
    def dt_rank(self) -> int:
        m = self.mamba or MambaConfig()
        return m.dt_rank or math.ceil(self.d_model / 16)

    def mixer_at(self, pos: int) -> str:
        return self.layer_pattern[pos % len(self.layer_pattern)]

    def ffn_at(self, pos: int) -> str:
        return self.ffn_pattern[pos % len(self.ffn_pattern)]


ARCH_REGISTRY: dict = {}
_REDUCED_REGISTRY: dict = {}


def register(config: ModelConfig, reduced: Callable[[], ModelConfig]):
    ARCH_REGISTRY[config.name] = config
    _REDUCED_REGISTRY[config.name] = reduced


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


def _ensure_loaded():
    if not ARCH_REGISTRY:
        importlib.import_module("repro_torch.configs")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
