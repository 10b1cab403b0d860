"""Config module for --arch stablelm-3b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "stablelm-3b"
CONFIG = get_config(ARCH_ID)
