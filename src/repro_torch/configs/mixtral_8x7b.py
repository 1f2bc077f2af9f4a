"""Mixtral-8x7B — the paper's MoE evaluation model.  [arXiv:2401.04088]

32L, d_model=4096, 32H (GQA kv=8), expert d_ff=14336, vocab=32000,
8 experts top-2, sliding window 4096.

``one_card``: the published model in bf16 is 93.4 GB of weights, more
than one 80 GB H100 holds.  The cut keeps every width (heads, experts,
expert d_ff, vocab, window) and cuts depth 32 -> 24: 35.09 B parameters,
70.19 GB in bf16, which leaves the KV pool 5.81 GB (59,150 tokens) on
the perfmodel's ``H100`` spec.
"""
from repro_torch.config import MoEConfig, ModelConfig, register, replace

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    ffn_pattern=("moe",),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14336),
    sliding_window=4096,
    train_microbatches=16,
    source="[arXiv:2401.04088; hf]",
)

ONE_CARD_LAYERS = 24


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=500,
        head_dim=32,
        ffn_pattern=("moe",),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        sliding_window=16,
    )


def one_card() -> ModelConfig:
    return replace(CONFIG, num_layers=ONE_CARD_LAYERS)


register(CONFIG, reduced, one_card)
