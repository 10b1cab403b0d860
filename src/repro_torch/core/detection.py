"""Scene-structure detection (D): DSI -> semi-dense depth map, in PyTorch.

Counterpart of `repro.core.detection`:
  1. confidence c(x,y) = max_z DSI, z* = argmax_z (first max);
  2. adaptive Gaussian thresholding of c selects semi-dense pixels;
  3. sub-voxel refinement by a parabola fit around the argmax;
  4. optional 3x3 median filter on the depth map.

The Gaussian blur is a sum of shifted slices, not a convolution: cuDNN
would run a float32 convolution in TF32 on the card. Every function takes
an optional leading batch of segments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.local_max.ref import depth_argmax_ref

Tensor = torch.Tensor


class DepthMap(NamedTuple):
    depth: Tensor  # (..., h, w) float32; undefined where mask is False
    mask: Tensor  # (..., h, w) bool — semi-dense support
    confidence: Tensor  # (..., h, w) float32 ray-density score


def gaussian_kernel1d(sigma: float, radius: int, device=None) -> Tensor:
    x = torch.arange(-radius, radius + 1, dtype=torch.float32, device=device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / torch.sum(k)


def _blur_axis(img: Tensor, k: Tensor, radius: int, dim: int) -> Tensor:
    """'valid' correlation with the symmetric kernel `k` along `dim` after
    edge padding: sum_j k[j] * img[i + j - radius], accumulated in
    ascending j with one rounding per term."""
    n = img.shape[dim]
    first = img.narrow(dim, 0, 1)
    last = img.narrow(dim, n - 1, 1)
    shape = list(img.shape)
    shape[dim] = radius
    padded = torch.cat([first.expand(shape), img, last.expand(shape)], dim=dim)
    out = padded.narrow(dim, 0, n) * k[0]
    for j in range(1, 2 * radius + 1):
        out = torch.addcmul(out, padded.narrow(dim, j, n), k[j])
    return out


def gaussian_blur(img: Tensor, sigma: float = 2.0, radius: int = 5) -> Tensor:
    """Separable Gaussian blur with edge padding, (..., h, w) -> (..., h, w)."""
    k = gaussian_kernel1d(sigma, radius, device=img.device)
    return _blur_axis(_blur_axis(img, k, radius, -2), k, radius, -1)


def detect_structure_from(
    conf: Tensor,
    zf: Tensor,
    planes: Tensor,
    *,
    threshold_c: float = 6.0,
    adaptive_sigma: float = 2.5,
    adaptive_radius: int = 5,
    min_votes: float = 3.0,
) -> DepthMap:
    """Detection tail from a depth reduction (`conf` max, `zf` refined
    argmax): adaptive Gaussian threshold mask + piecewise-linear depth
    interpolation between plane centres."""
    conf = conf.to(torch.float32)
    zf = zf.to(torch.float32)
    local_mean = gaussian_blur(conf, adaptive_sigma, adaptive_radius)
    mask = (conf > local_mean + threshold_c) & (conf >= min_votes)

    nz = planes.shape[0]
    z_lo = torch.clamp(torch.floor(zf).to(torch.int64), 0, nz - 1)
    z_hi = torch.clamp(z_lo + 1, 0, nz - 1)
    frac = zf - z_lo.to(torch.float32)
    # rounded as the reference: fma(planes[z_hi], frac, planes[z_lo] * (1 - frac))
    depth = torch.addcmul(planes[z_lo] * (1.0 - frac), planes[z_hi], frac)
    return DepthMap(depth=depth, mask=mask, confidence=conf)


def detect_structure(
    dsi: Tensor,
    planes: Tensor,
    *,
    threshold_c: float = 6.0,
    adaptive_sigma: float = 2.5,
    adaptive_radius: int = 5,
    min_votes: float = 3.0,
    refine_subvoxel: bool = True,
) -> DepthMap:
    """DSI (..., Nz, h, w) -> semi-dense DepthMap at the reference view.

    Pixel kept iff c > blur(c) + threshold_c and c >= min_votes.
    """
    if refine_subvoxel:
        conf, zf = depth_argmax_ref(dsi)
    else:
        conf, zidx = torch.max(dsi.to(torch.float32), dim=-3)
        zf = zidx.to(torch.float32)
    return detect_structure_from(
        conf, zf, planes,
        threshold_c=threshold_c, adaptive_sigma=adaptive_sigma,
        adaptive_radius=adaptive_radius, min_votes=min_votes,
    )


def median_filter3(depth: Tensor, mask: Tensor) -> Tensor:
    """3x3 median over valid neighbours (wrap-around shifts, as the
    reference's `jnp.roll`)."""
    big = torch.full((), float("inf"), dtype=torch.float32, device=depth.device)
    shifts = []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d = torch.roll(depth, (dy, dx), dims=(-2, -1))
            m = torch.roll(mask, (dy, dx), dims=(-2, -1))
            shifts.append(torch.where(m, d, big))
    stack = torch.stack(shifts, dim=0)  # (9, ..., h, w)
    valid_count = torch.sum(stack < big, dim=0)
    sorted_stack = torch.sort(stack, dim=0).values
    mid = torch.clamp(torch.div(valid_count - 1, 2, rounding_mode="floor"), min=0)
    med = torch.gather(sorted_stack, 0, mid.unsqueeze(0)).squeeze(0)
    return torch.where(mask & (valid_count > 0), med, depth)


def _median_tail(dm: DepthMap, median_filter: bool) -> DepthMap:
    if not median_filter:
        return dm
    return DepthMap(median_filter3(dm.depth, dm.mask), dm.mask, dm.confidence)


def detect_and_filter(
    dsi: Tensor,
    planes: Tensor,
    *,
    threshold_c: float = 6.0,
    min_votes: float = 3.0,
    median_filter: bool = True,
) -> DepthMap:
    """D (+ optional 3x3 median) for one DSI volume or a batch of them."""
    dm = detect_structure(dsi, planes, threshold_c=threshold_c, min_votes=min_votes)
    return _median_tail(dm, median_filter)


def detect_and_filter_from(
    conf: Tensor,
    zf: Tensor,
    planes: Tensor,
    *,
    threshold_c: float = 6.0,
    min_votes: float = 3.0,
    median_filter: bool = True,
) -> DepthMap:
    """`detect_and_filter` for callers that already hold (conf, zf), such as
    the fused sweep kernel's output."""
    dm = detect_structure_from(conf, zf, planes,
                               threshold_c=threshold_c, min_votes=min_votes)
    return _median_tail(dm, median_filter)
