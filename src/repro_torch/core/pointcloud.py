"""Depth-map -> point-cloud conversion and global map merging (M), in PyTorch.

Counterpart of `repro.core.pointcloud`. The radius outlier filter runs on
the cloud's device, with the reference's float32 arithmetic.
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


def radius_outlier_filter(pc: PointCloud, radius: float = 0.05, min_neighbors: int = 2,
                          max_points: int = 20000) -> PointCloud:
    """Radius outlier removal (as in EMVS post-processing), on the cloud's
    device: a point stays valid when at least `min_neighbors` other points
    lie closer than `radius`.

    Only the first `max_points` valid points of the flat (N,) cloud take
    part; the rest become invalid, as in the reference. O(N^2) over them,
    1,024 rows at a time. Distances are the reference's float32
    ((a - b) ** 2).sum(-1) < radius ** 2, summed x, y, then z (not
    `torch.cdist`, which expands |a|^2 + |b|^2 - 2ab and rounds otherwise).
    """
    idx = torch.nonzero(pc.valid.reshape(-1)).reshape(-1)[:max_points]
    if idx.numel() == 0:
        return pc
    sub = pc.points.reshape(-1, 3)[idx]
    r2 = torch.tensor(radius * radius, dtype=sub.dtype, device=sub.device)
    keep = torch.empty(idx.shape[0], dtype=torch.bool, device=sub.device)
    chunk = 1024
    for s in range(0, sub.shape[0], chunk):
        d = sub[s:s + chunk, None, :] - sub[None, :, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        keep[s:s + chunk] = (d2 < r2).sum(-1) - 1 >= min_neighbors
    new_valid = torch.zeros_like(pc.valid).reshape(-1)
    new_valid[idx[keep]] = True
    return PointCloud(pc.points, pc.weights, new_valid.reshape(pc.valid.shape))


def merge(global_pc: list[PointCloud], pc: PointCloud) -> list[PointCloud]:
    """Append a local cloud to the global map (a list of fixed-size blocks)."""
    global_pc.append(pc)
    return global_pc


def concatenate(clouds: list[PointCloud]) -> PointCloud:
    """One flat cloud from a list of (N_i, ...) clouds."""
    return PointCloud(
        points=torch.cat([c.points for c in clouds], dim=0),
        weights=torch.cat([c.weights for c in clouds], dim=0),
        valid=torch.cat([c.valid for c in clouds], dim=0),
    )
