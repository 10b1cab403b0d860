"""Pinhole camera model with radial-tangential distortion, in PyTorch.

Counterpart of `repro.core.camera`. The DAVIS240C sensor of the paper is
240x180; intrinsics follow the event-camera dataset calibration format.
Distortion correction runs per event, before aggregation.
"""
from __future__ import annotations

import dataclasses

import torch

Tensor = torch.Tensor

DAVIS240_WIDTH = 240
DAVIS240_HEIGHT = 180


@dataclasses.dataclass(frozen=True)
class CameraModel:
    """Intrinsics + distortion for a pinhole camera."""

    width: int = DAVIS240_WIDTH
    height: int = DAVIS240_HEIGHT
    fx: float = 199.0
    fy: float = 199.0
    cx: float = 132.0
    cy: float = 110.0
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0

    @property
    def K(self) -> Tensor:
        """3x3 intrinsic matrix (float32, on the CPU)."""
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def K_inv(self) -> Tensor:
        """Inverse intrinsics, each entry rounded once from a Python float."""
        return torch.tensor(
            [
                [1.0 / self.fx, 0.0, -self.cx / self.fx],
                [0.0, 1.0 / self.fy, -self.cy / self.fy],
                [0.0, 0.0, 1.0],
            ],
            dtype=torch.float32,
        )

    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


# The sensors the examples and `chip_smoke.py` run: the paper's DAVIS240C,
# and DAVIS346 with the intrinsics of MVSEC's indoor_flying left camera and
# no distortion (the simulator renders undistorted events).
CAMERAS = {
    "davis240": CameraModel(),
    "davis346": CameraModel(width=346, height=260, fx=226.38, fy=226.15, cx=173.65,
                            cy=133.73),
}


def project(cam: CameraModel, points_cam: Tensor) -> Tensor:
    """3D points in the camera frame (..., 3) -> pixel coords (..., 2)."""
    z = points_cam[..., 2]
    x = cam.fx * points_cam[..., 0] / z + cam.cx
    y = cam.fy * points_cam[..., 1] / z + cam.cy
    return torch.stack([x, y], dim=-1)


def unproject(cam: CameraModel, pixels: Tensor, depth: Tensor) -> Tensor:
    """Pixels (..., 2) at `depth` -> 3D points in the camera frame (..., 3)."""
    x = (pixels[..., 0] - cam.cx) / cam.fx
    y = (pixels[..., 1] - cam.cy) / cam.fy
    x, y, depth = torch.broadcast_tensors(x, y, depth)
    return torch.stack([x * depth, y * depth, depth], dim=-1)


def distort_normalized(cam: CameraModel, xn: Tensor, yn: Tensor) -> tuple[Tensor, Tensor]:
    """Apply plumb-bob distortion to normalized image coordinates."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = xn * radial + 2.0 * cam.p1 * xn * yn + cam.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + cam.p1 * (r2 + 2.0 * yn * yn) + 2.0 * cam.p2 * xn * yn
    return xd, yd


def undistort_events(cam: CameraModel, xy: Tensor, num_iters: int = 5) -> Tensor:
    """Streaming event distortion correction (fixed-point inversion of the
    plumb-bob model, as OpenCV's undistortPoints). xy: (..., 2) raw pixels."""
    if not cam.has_distortion():
        return xy
    xd = (xy[..., 0] - cam.cx) / cam.fx
    yd = (xy[..., 1] - cam.cy) / cam.fy
    xn, yn = xd, yd
    for _ in range(num_iters):
        xdd, ydd = distort_normalized(cam, xn, yn)
        xn, yn = xn + (xd - xdd), yn + (yd - ydd)
    return torch.stack([xn * cam.fx + cam.cx, yn * cam.fy + cam.cy], dim=-1)


def in_bounds_mask(cam: CameraModel, xy: Tensor, margin: float = 0.0) -> Tensor:
    """Valid-pixel mask ('projection missing judgement' in the paper)."""
    x, y = xy[..., 0], xy[..., 1]
    return (
        (x >= margin)
        & (x <= cam.width - 1 - margin)
        & (y >= margin)
        & (y <= cam.height - 1 - margin)
    )
