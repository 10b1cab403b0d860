"""Plain PyTorch version of the sweep's front end (the kernel formulation's F).

The reference computes these steps as plain JAX. Per bucket: each frame's
pose against its segment's key frame, H and phi
(`core.backproject.frame_geometry`), then Table 1, the homography and the
frame mask (`canonical_inputs`). The CUDA kernel equals it bit for bit.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.backproject import frame_geometry
from repro_torch.core.camera import CameraModel
from repro_torch.core.geometry import SE3
from repro_torch.kernels.backproject_vote.ops import canonical_inputs

Tensor = torch.Tensor


def canonical_project_ref(cam: CameraModel, batch: Any, planes: Tensor, z0: Tensor, *,
                          quantized: bool) -> tuple[Tensor, Tensor, Tensor]:
    """`(xy0, valid, phi)`, (S, C, E, 2), (S, C, E), (S, C, Nz, 3), for a
    `SegmentBatch` with (S, C, ...) fields."""
    geoms = frame_geometry(cam, SE3(batch.ref_R[:, None], batch.ref_t[:, None]),
                           SE3(batch.poses_R, batch.poses_t), z0, planes)
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y],
                      dim=-1)  # (S, C, Nz, 3)
    return canonical_inputs(batch.xy, batch.valid, geoms.H, phi, quantized=quantized,
                            frame_valid=batch.frame_valid)
