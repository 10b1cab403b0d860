"""Public wrapper for the sweep's front end: the device picks the path.

A CPU tensor takes the plain version (`ref.py`), a CUDA tensor launches
the kernel (one launch a bucket), a meta tensor traces it; any other
device raises.
"""
from __future__ import annotations

import functools
from typing import Any

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.kernels.canonical_project.kernel import canonical_project_cuda
from repro_torch.kernels.canonical_project.ref import canonical_project_ref

Tensor = torch.Tensor


@functools.lru_cache(maxsize=16)
def _intrinsics(cam: CameraModel) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """K and K^-1 as the kernel takes them: nine float32 values each, row-major."""
    return tuple(cam.K_values().ravel().tolist()), tuple(cam.K_inv_values().ravel().tolist())


def canonical_project(cam: CameraModel, batch: Any, planes: Tensor, z0: Tensor, *,
                      quantized: bool) -> tuple[Tensor, Tensor, Tensor]:
    """The sweep kernel's inputs `(xy0, valid, phi)` for a `SegmentBatch`:
    each frame's pose relative to its segment's key frame, the canonical
    homography and the plane-sweep coefficients at `planes` around `z0`,
    under `quantized` Table 1 (Q9.7 events and canonical coordinates, Q11.21
    H and phi), the homography on every event and the frame mask on its
    validity. The batch's masks must be bool (votes weigh 1 or 0)."""
    if batch.xy.device.type == "cpu":
        return canonical_project_ref(cam, batch, planes, z0, quantized=quantized)
    if batch.xy.device.type not in ("cuda", "meta"):
        raise ValueError(f"canonical_project: no path for device {batch.xy.device}")
    k, k_inv = _intrinsics(cam)
    return canonical_project_cuda(
        *(t.contiguous() for t in (batch.xy, batch.valid, batch.frame_valid, batch.poses_R,
                                   batch.poses_t, batch.ref_R, batch.ref_t, planes, z0)),
        K=k, K_inv=k_inv, quantized=quantized)
