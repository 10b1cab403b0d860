"""Config module for --arch jamba-1.5-large-398b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "jamba-1.5-large-398b"
CONFIG = get_config(ARCH_ID)
