"""Config module for --arch eventor-davis240 (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "eventor-davis240"
CONFIG = get_config(ARCH_ID)
