"""MusicGen-large: decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

48L, d_model=2048, 32H (kv=32), d_ff=8192, vocab=2048.  The EnCodec audio
frontend is a STUB: ``launch/steps.py``'s ``input_specs`` give precomputed
frame embeddings (frontend='embed_stub'); the backbone is what is served.
Plain GELU MLP (T5-style), no GLU; sinusoidal positions in the original ->
modeled as rope_type='none' with embeddings arriving position-encoded
from the stub.  2.42 B parameters, 4.85 GB in bf16: one H100 holds it
whole.
"""
from repro_torch.config import ModelConfig, register

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    ffn_glu=False,
    act="gelu",
    rope_type="none",
    frontend="embed_stub",
    train_microbatches=4,
    source="[arXiv:2306.05284; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        d_ff=256,
        vocab_size=128,
        head_dim=32,
        ffn_glu=False,
        act="gelu",
        rope_type="none",
        frontend="embed_stub",
    )


register(CONFIG, reduced)
