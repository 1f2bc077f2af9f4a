from repro_torch.models.transformer import (  # noqa: F401
    decode_forward, forward, fused_pd_forward, init_cache, init_model,
)
