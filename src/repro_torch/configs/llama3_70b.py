"""LLaMA-3.1-70B — the paper's dense evaluation model.  [arXiv:2407.21783]

80L, d_model=8192, 64H (GQA kv=8), d_ff=28672, vocab=128256.

``one_card``: the published model in bf16 is 141.1 GB of weights, more
than one 80 GB H100 holds.  The cut keeps every width (heads, d_ff, the
untied LM head over the whole vocab) and cuts depth 80 -> 38: 34.62 B
parameters, 69.23 GB in bf16, which leaves the KV pool 2,717 blocks of
16 tokens (6.77 GB, 43,472 tokens) on the perfmodel's ``H100`` spec.
"""
from repro_torch.config import ModelConfig, register, replace

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

ONE_CARD_LAYERS = 38


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


def one_card() -> ModelConfig:
    return replace(CONFIG, num_layers=ONE_CARD_LAYERS)


register(CONFIG, reduced, one_card)
