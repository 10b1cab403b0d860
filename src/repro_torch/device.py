"""Where the port's entry points run.

Entry points run on the CUDA card unless the caller asks for the CPU
(`device="cpu"`); with no card and no such request they raise instead of
falling back. `to_host` brings an array or tensor to host numpy.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """`None` means the CUDA card; raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run its plain CPU path")
    return dev


def to_host(x, dtype=None) -> np.ndarray:
    """`x` (a tensor on any device, a numpy array or a sequence) as a host
    numpy array, of `dtype` when given; a CPU tensor shares its memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)
