"""Config module for --arch starcoder2-15b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "starcoder2-15b"
CONFIG = get_config(ARCH_ID)
