"""Architecture registry — import every ported config module to populate it."""
from repro_torch.configs import granite_8b  # noqa: F401
from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401
from repro_torch.configs import llama3_70b  # noqa: F401
from repro_torch.configs import minicpm_2b  # noqa: F401
from repro_torch.configs import mixtral_8x7b  # noqa: F401
from repro_torch.configs import mixtral_8x22b  # noqa: F401
from repro_torch.configs import musicgen_large  # noqa: F401
from repro_torch.configs import qwen2_5_14b  # noqa: F401
from repro_torch.configs import qwen2_vl_72b  # noqa: F401
from repro_torch.configs import qwen3_moe_235b_a22b  # noqa: F401
from repro_torch.configs import starcoder2_3b  # noqa: F401
from repro_torch.configs import xlstm_125m  # noqa: F401
