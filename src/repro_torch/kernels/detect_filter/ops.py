"""Public wrapper for the detection tail on the card: the device picks the path.

A CUDA tensor launches the kernel (one launch for any leading batch), a
meta tensor traces it; the CPU's path is `core.detection`'s eager code,
which routes every other device here. Any other device raises.
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from repro_torch.kernels.detect_filter.kernel import detect_filter_cuda

Tensor = torch.Tensor


def detect_filter(conf: Tensor, zf: Tensor, planes: Tensor, taps: Sequence[float], *,
                  threshold_c: float, min_votes: float, median_filter: bool
                  ) -> tuple[Tensor, Tensor]:
    """(depth, mask) (..., h, w) from conf and zf (..., h, w), planes (Nz,)
    and the blur's Gaussian taps: the adaptive threshold, the depth
    interpolation and, with `median_filter`, the 3x3 median."""
    if conf.device.type not in ("cuda", "meta"):
        raise ValueError(f"detect_filter: no kernel path for device {conf.device}")
    lead, hw = conf.shape[:-2], conf.shape[-2:]
    depth, mask = detect_filter_cuda(
        conf.reshape(-1, *hw), zf.reshape(-1, *hw), planes, taps,
        threshold_c=threshold_c, min_votes=min_votes, median_filter=median_filter)
    return depth.reshape(*lead, *hw), mask.reshape(*lead, *hw)
