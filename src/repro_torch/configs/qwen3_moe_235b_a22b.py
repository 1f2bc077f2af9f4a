"""Qwen3-MoE-235B-A22B: 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]

94L, d_model=4096, 64H (GQA kv=4), expert d_ff=1536, vocab=151936.
Every layer is MoE (no dense FFN layers).

``one_card``: the published model in bf16 is 470.19 GB of weights, six
80 GB H100s' worth.  The cut keeps every width (64/4 heads, 128 experts
top-8 of d_ff 1536, the untied LM head over the whole vocab) and cuts
depth 94 -> 13: 4.98 GB a layer, 33.59 B parameters, 67.17 GB in bf16,
which leaves the KV pool 20,726 blocks of 16 tokens (8.83 GB, 331,616
tokens) on the perfmodel's ``H100`` spec.  Fourteen layers would be
72.15 GB, past the 69-71 GB of weights the LLaMA and Mixtral cuts hold.
"""
from repro_torch.config import MoEConfig, ModelConfig, register, replace

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    d_ff=1536,
    vocab_size=151_936,
    head_dim=128,
    ffn_pattern=("moe",),
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=1536),
    rope_theta=1_000_000.0,
    opt_dtype="bfloat16",
    train_microbatches=16,
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
)

ONE_CARD_LAYERS = 13


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=64,
        vocab_size=512,
        head_dim=32,
        ffn_pattern=("moe",),
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=64),
    )


def one_card() -> ModelConfig:
    return replace(CONFIG, num_layers=ONE_CARD_LAYERS)


register(CONFIG, reduced, one_card)
