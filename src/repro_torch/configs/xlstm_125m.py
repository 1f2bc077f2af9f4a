"""xLSTM-125M: sLSTM + mLSTM blocks.  [arXiv:2405.04517; unverified]

12L, d_model=768, 4 heads, vocab=50304, no separate FFN (d_ff=0 — xLSTM
blocks carry their own pre/post up-projections).  Pattern mLSTM:sLSTM 2:1
(the paper's xLSTM[7:1] ratio does not divide 12 layers; recorded as an
assumption in DESIGN.md).
"""
from repro_torch.config import ModelConfig, XLSTMConfig, register

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    num_layers=12,
    d_model=768,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    head_dim=192,
    layer_pattern=("mlstm", "mlstm", "slstm"),
    ffn_pattern=("none",),
    xlstm=XLSTMConfig(proj_factor=2.0, num_heads=4),
    rope_type="none",
    tie_embeddings=True,
    train_microbatches=2,
    source="[arXiv:2405.04517; unverified]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=3,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        head_dim=16,
        layer_pattern=("mlstm", "mlstm", "slstm"),
        ffn_pattern=("none",),
        xlstm=XLSTMConfig(proj_factor=2.0, num_heads=4),
        rope_type="none",
        tie_embeddings=True,
    )


register(CONFIG, reduced)
