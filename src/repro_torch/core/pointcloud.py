"""Depth-map -> point-cloud conversion (M), in PyTorch.

Counterpart of `repro.core.pointcloud` (the conversions; the host-side
outlier filter and map merging are not ported).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.camera import CameraModel, unproject
from repro_torch.core.detection import DepthMap
from repro_torch.core.geometry import SE3

Tensor = torch.Tensor


class PointCloud(NamedTuple):
    points: Tensor  # (..., N, 3) world-frame
    weights: Tensor  # (..., N) confidence (ray-density score)
    valid: Tensor  # (..., N) bool — fixed-size padding mask


def depth_map_to_points(cam: CameraModel, dm: DepthMap, T_w_ref: SE3) -> PointCloud:
    """A semi-dense depth map (..., h, w) -> a fixed-size masked cloud.

    Leading dims of the depth map pair with leading dims of `T_w_ref`, so a
    bucket of segments converts in one call.
    """
    h, w = dm.depth.shape[-2:]
    lead = dm.depth.shape[:-2]
    dev = dm.depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pix = torch.stack([xs, ys], dim=-1).reshape(-1, 2)
    pts_cam = unproject(cam, pix, dm.depth.reshape(*lead, h * w))
    return PointCloud(
        points=T_w_ref.apply(pts_cam),
        weights=dm.confidence.reshape(*lead, h * w),
        valid=dm.mask.reshape(*lead, h * w),
    )


def depth_maps_to_points(cam: CameraModel, dms: DepthMap, T_w_refs: SE3) -> PointCloud:
    """Batched `depth_map_to_points`: (S, h, w) maps -> (S, h*w, ...) clouds."""
    return depth_map_to_points(cam, dms, T_w_refs)
