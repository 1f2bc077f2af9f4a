"""Qwen2-VL-72B backbone: M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

80L, d_model=8192, 64H (GQA kv=8), d_ff=29568, vocab=152064.  The vision
tower is a STUB: ``launch/steps.py``'s ``input_specs`` give precomputed
patch embeddings (frontend='embed_stub') plus 3-D (t, h, w) position ids
consumed by M-RoPE.

``one_card``: the published model in bf16 is 145.4 GB of weights (80 x
1.755 GB of layers, 2 x 2.49 GB of embedding and untied head), more than
one 80 GB H100 holds.  The cut keeps every width (heads, d_ff, the qkv
biases, the untied LM head over the whole vocab) and cuts depth 80 -> 36:
34.09 B parameters, 68.18 GB in bf16, which leaves about 11 GB for the
cells' paged pool, their prefill activations and the plain path they are
held against.
"""
from repro_torch.config import ModelConfig, register, replace

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152_064,
    head_dim=128,
    qkv_bias=True,
    rope_type="mrope",
    rope_theta=1_000_000.0,
    frontend="embed_stub",
    opt_dtype="bfloat16",
    train_microbatches=16,
    source="[arXiv:2409.12191; hf]",
)

ONE_CARD_LAYERS = 36


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-72b",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        head_dim=32,
        qkv_bias=True,
        rope_type="mrope",
        frontend="embed_stub",
    )


def one_card() -> ModelConfig:
    return replace(CONFIG, num_layers=ONE_CARD_LAYERS)


register(CONFIG, reduced, one_card)
