"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); with no card and no such request they raise instead of
falling back.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run its plain CPU path")
    return dev
