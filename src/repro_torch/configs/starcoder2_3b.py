"""StarCoder2-3B: GQA + RoPE, plain GELU MLP, biases.  [arXiv:2402.19173; hf]

30L, d_model=3072, 24H (GQA kv=2), d_ff=12288, vocab=49152.
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    d_ff=12288,
    vocab_size=49152,
    head_dim=128,
    qkv_bias=True,
    ffn_glu=False,
    act="gelu",
    rope_theta=999_999.0,
    train_microbatches=4,
    source="[arXiv:2402.19173; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        qkv_bias=True,
        ffn_glu=False,
        act="gelu",
    )


register(CONFIG, reduced)
