"""Config module for --arch qwen3-8b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "qwen3-8b"
CONFIG = get_config(ARCH_ID)
