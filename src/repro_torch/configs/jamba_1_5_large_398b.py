"""Jamba-1.5-Large (398B): Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] — 72L, d_model=8192, 64H (GQA kv=8), d_ff=24576,
vocab=65536.  Each period of 8 layers has one attention layer (position 4,
matching Jamba's attn_layer_offset); MoE replaces the dense FFN on every
other layer (e=2).  Jamba uses no explicit positional encoding (the Mamba
layers carry position); rope_type="none".

``one_card``: one full-width period without experts, what one 80 GB H100
serves.  Two cuts of the published model: depth 72 -> 8 (one whole
period: 7 Mamba layers and the attention layer at position 4), and the
MoE FFN of odd layers -> Jamba's dense FFN (d_ff 24576) on every layer:
one period with its 4 MoE layers is 90.5 GB of bf16 (each MoE layer
19.3 GB of experts).  9.0 B parameters, 18 GB.
"""
from repro_torch.config import (MambaConfig, MoEConfig, ModelConfig, register,
                                replace)

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    layer_pattern=("mamba", "mamba", "mamba", "mamba",
                   "attn", "mamba", "mamba", "mamba"),
    ffn_pattern=("dense", "moe"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_type="none",
    opt_dtype="bfloat16",
    train_microbatches=16,
    source="[arXiv:2403.19887; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        family="hybrid",
        num_layers=8,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        layer_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        ffn_pattern=("dense", "moe"),
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        rope_type="none",
    )


def one_card() -> ModelConfig:
    return replace(CONFIG, num_layers=8, ffn_pattern=("dense",))


register(CONFIG, reduced, one_card)
