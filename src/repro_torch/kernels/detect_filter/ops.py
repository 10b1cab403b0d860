"""Public wrapper for the detection tail: the device picks the path.

A CPU tensor takes the plain version, `core.detection`'s eager code (the
package has no `ref.py`); a CUDA tensor launches the kernel (one launch for
any leading batch), a meta tensor traces it; any other device raises.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.core import detection
from repro_torch.core.detection import ADAPTIVE_RADIUS, ADAPTIVE_SIGMA, DepthMap
from repro_torch.kernels.detect_filter.kernel import detect_filter_cuda

Tensor = torch.Tensor


@functools.lru_cache(maxsize=None)
def _gaussian_taps(sigma: float, radius: int) -> tuple[float, ...]:
    """The CPU path's kernel weights as host floats: the card's kernel takes
    them by value, so a call makes no device tensor and no copy."""
    return tuple(detection.gaussian_kernel1d(sigma, radius, device="cpu").tolist())


# at import, so that a traced call (fake tensors, a dispatch mode) finds the
# default weights made and records no operation of theirs
_gaussian_taps(ADAPTIVE_SIGMA, ADAPTIVE_RADIUS)


def detect_filter(conf: Tensor, zf: Tensor, planes: Tensor, *, threshold_c: float = 6.0,
                  min_votes: float = 3.0, median_filter: bool = True,
                  adaptive_radius: int = ADAPTIVE_RADIUS) -> DepthMap:
    """The DepthMap (..., h, w) from a depth reduction (`conf` max, `zf`
    refined argmax) and planes (Nz,): the adaptive Gaussian threshold (sigma
    `ADAPTIVE_SIGMA`), the depth interpolation and, with `median_filter`,
    the 3x3 median."""
    if conf.device.type == "cpu":
        dm = detection.detect_structure_from(conf, zf, planes, threshold_c=threshold_c,
                                             adaptive_radius=adaptive_radius,
                                             min_votes=min_votes)
        if median_filter:
            dm = dm._replace(depth=detection.median_filter3(dm.depth, dm.mask))
        return dm
    if conf.device.type not in ("cuda", "meta"):
        raise ValueError(f"detect_filter: no path for device {conf.device}")
    conf = conf.to(torch.float32)
    lead, hw = conf.shape[:-2], conf.shape[-2:]
    depth, mask = detect_filter_cuda(
        conf.reshape(-1, *hw), zf.to(torch.float32).reshape(-1, *hw), planes,
        _gaussian_taps(ADAPTIVE_SIGMA, adaptive_radius),
        threshold_c=threshold_c, min_votes=min_votes, median_filter=median_filter)
    return DepthMap(depth.reshape(*lead, *hw), mask.reshape(*lead, *hw), conf)
