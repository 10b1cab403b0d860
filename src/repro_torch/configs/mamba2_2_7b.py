"""Config module for --arch mamba2-2.7b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "mamba2-2.7b"
CONFIG = get_config(ARCH_ID)
