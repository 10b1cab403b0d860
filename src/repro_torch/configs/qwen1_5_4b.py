"""Config module for --arch qwen1.5-4b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "qwen1.5-4b"
CONFIG = get_config(ARCH_ID)
