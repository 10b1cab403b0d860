"""Config module for --arch musicgen-large (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "musicgen-large"
CONFIG = get_config(ARCH_ID)
