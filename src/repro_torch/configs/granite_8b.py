"""Granite-8B-Code: llama-arch (SwiGLU, RoPE, GQA).  [arXiv:2405.04324; hf]

36L, d_model=4096, 32H (GQA kv=8), d_ff=14336, vocab=49152.
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    head_dim=128,
    tie_embeddings=True,
    train_microbatches=8,
    source="[arXiv:2405.04324; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        tie_embeddings=True,
    )


register(CONFIG, reduced)
