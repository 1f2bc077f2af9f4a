"""LLaMA-3.1-70B — the paper's dense evaluation model.  [arXiv:2407.21783]

80L, d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="llama3-70b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    opt_dtype="bfloat16",
    train_microbatches=16,
    source="[arXiv:2407.21783; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama3-70b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
    )


register(CONFIG, reduced)
