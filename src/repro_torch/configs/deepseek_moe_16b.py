"""Config module for --arch deepseek-moe-16b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "deepseek-moe-16b"
CONFIG = get_config(ARCH_ID)
