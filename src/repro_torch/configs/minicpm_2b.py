"""MiniCPM-2B: llama-like, MHA (kv=36), tied embeddings, WSD schedule.

[arXiv:2404.06395; hf] — 40L, d_model=2304, 36H (kv=36), d_ff=5760,
vocab=122753, head_dim=64.  (The WSD learning-rate schedule is a training
detail, implemented in repro/training/schedule.py.)
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    tie_embeddings=True,
    train_microbatches=4,
    source="[arXiv:2404.06395; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=6,
        d_ff=192,
        vocab_size=511,  # odd on purpose: exercises vocab padding
        head_dim=16,
        tie_embeddings=True,
    )


register(CONFIG, reduced)
