"""Config module for --arch llava-next-mistral-7b (see configs/archs.py)."""
from repro_torch.configs import get_config

ARCH_ID = "llava-next-mistral-7b"
CONFIG = get_config(ARCH_ID)
