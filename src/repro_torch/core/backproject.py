"""Event back-projection (P): P(Z0) + P(Z0 -> Zi), in PyTorch.

Counterpart of `repro.core.backproject`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.geometry import (
    SE3,
    PlaneSweepCoeffs,
    apply_homography,
    canonical_homography,
    propagate_to_planes,
    proportional_coeffs,
    relative_pose_ref_from_cam,
)

Tensor = torch.Tensor


class FrameGeometry(NamedTuple):
    """Per-event-frame geometry (paper: computed on the ARM side).

    H:   (..., 3, 3) canonical homography, quantizable to Q11.21
    phi: PlaneSweepCoeffs with (..., Nz) alpha/beta_x/beta_y
    """

    H: Tensor
    phi: PlaneSweepCoeffs


def frame_geometry(
    cam: CameraModel, T_w_ref: SE3, T_w_cam: SE3, z0: Tensor, planes: Tensor
) -> FrameGeometry:
    """H_Z0 and phi for one frame, or a batch (leading dims of T_w_cam)."""
    T_ref_cam = relative_pose_ref_from_cam(T_w_ref, T_w_cam)
    H = canonical_homography(cam, T_ref_cam, z0)
    phi = proportional_coeffs(cam, T_ref_cam, z0, planes)
    return FrameGeometry(H, phi)


def backproject_canonical(cam: CameraModel, xy: Tensor, H: Tensor) -> Tensor:
    """Sub-task 2, P(Z0): homography + normalization per event."""
    del cam  # kept in the signature for symmetry with the quantized path
    return apply_homography(H, xy)


def backproject_planes(
    cam: CameraModel, xy0: Tensor, phi: PlaneSweepCoeffs
) -> tuple[Tensor, Tensor]:
    """Sub-task 4, P(Z0 -> Zi): (E,2) -> ((Nz,E), (Nz,E))."""
    return propagate_to_planes(cam, xy0, phi)


def backproject_frame(
    cam: CameraModel, xy: Tensor, geom: FrameGeometry
) -> tuple[Tensor, Tensor]:
    """Full P for one event frame: (E,2) raw coords -> per-plane coords."""
    xy0 = backproject_canonical(cam, xy, geom.H)
    return backproject_planes(cam, xy0, geom.phi)
