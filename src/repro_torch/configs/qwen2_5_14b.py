"""Qwen2.5-14B: GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B; hf]

48L, d_model=5120, 40H (GQA kv=8), d_ff=13824, vocab=152064.
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    train_microbatches=8,
    source="[hf:Qwen/Qwen2.5-0.5B; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        qkv_bias=True,
    )


register(CONFIG, reduced)
