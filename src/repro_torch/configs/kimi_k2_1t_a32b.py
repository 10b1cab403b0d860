"""Config module for --arch kimi-k2-1t-a32b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "kimi-k2-1t-a32b"
CONFIG = get_config(ARCH_ID)
