"""Mixtral-8x22B: 8 experts top-2, sliding-window attention.

[arXiv:2401.04088; hf] — 56L, d_model=6144, 48H (GQA kv=8), expert
d_ff=16384, vocab=32768.  SWA window 4096 bounds the KV cache, making
long_500k decode sub-quadratic (O(window) per token).
"""
from repro_torch.config import MoEConfig, ModelConfig, register

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    head_dim=128,
    ffn_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    sliding_window=4096,
    opt_dtype="bfloat16",
    train_microbatches=16,
    source="[arXiv:2401.04088; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=512,
        head_dim=32,
        ffn_pattern=("moe",),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        sliding_window=16,
    )


register(CONFIG, reduced)
