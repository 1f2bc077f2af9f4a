"""Architecture registry — import every ported config module to populate it."""
from repro_torch.configs import granite_8b  # noqa: F401
from repro_torch.configs import jamba_1_5_large_398b  # noqa: F401
from repro_torch.configs import llama3_70b  # noqa: F401
from repro_torch.configs import mixtral_8x7b  # noqa: F401
from repro_torch.configs import mixtral_8x22b  # noqa: F401
