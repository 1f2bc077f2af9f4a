"""Architecture registry — import every ported config module to populate it."""
from repro_torch.configs import granite_8b  # noqa: F401
