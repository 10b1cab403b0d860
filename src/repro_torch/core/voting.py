"""Volumetric ray-counting (R): DSI voting, in PyTorch.

Counterpart of `repro.core.voting`, with its two tensor formulations:

  1. `vote_scatter`       — scatter-add into the volume (the FPGA's Vote
                            Execute Unit semantics);
  2. `vote_onehot_matmul` — per plane, votes = Oy^T @ Ox with one-hot
                            (nearest) or two-hot (bilinear) event rows.

The fused formulation is the CUDA kernel in `repro_torch.kernels
.backproject_vote`. Out-of-bounds projections are dropped. Both functions
take a DSI (..., Nz, h, w) and coords (..., Nz, E) with the same leading
dims, so a bucket of segments votes in one call. Integer accumulation is
exact in any order; float (bilinear) sums depend on the order of the
scatter on a GPU.
"""
from __future__ import annotations

import torch

from repro_torch.quant.fixed_point import round_half_away

Tensor = torch.Tensor


def _sanitize(coord: Tensor) -> Tensor:
    """Non-finite coords -> -1e6, then clamp to ±1e6, so they fail the
    bounds check instead of poisoning the votes."""
    c = torch.where(torch.isfinite(coord), coord, torch.full_like(coord, -1e6))
    return torch.clamp(c, -1e6, 1e6)


def _round_half_up(x: Tensor) -> Tensor:
    """RTL-style nearest-pixel rounding: floor(x + 0.5)."""
    return torch.floor(x + 0.5)


def _bounds_mask_nearest(xi: Tensor, yi: Tensor, w: int, h: int) -> Tensor:
    xr, yr = _round_half_up(xi), _round_half_up(yi)
    return (xr >= 0) & (xr <= w - 1) & (yr >= 0) & (yr <= h - 1)


def _bounds_mask_bilinear(xi: Tensor, yi: Tensor, w: int, h: int) -> Tensor:
    x0, y0 = torch.floor(xi), torch.floor(yi)
    return (x0 >= 0) & (x0 + 1 <= w - 1) & (y0 >= 0) & (y0 + 1 <= h - 1)


def _plane_offsets(dsi: Tensor) -> Tensor:
    """Flat offset of each (..., z) plane of `dsi`, shaped (..., Nz, 1)."""
    lead_nz = dsi.shape[:-2]
    hw = dsi.shape[-2] * dsi.shape[-1]
    n = 1
    for d in lead_nz:
        n *= d
    return (torch.arange(n, device=dsi.device) * hw).reshape(*lead_nz, 1)


def vote_scatter(
    dsi: Tensor, x_i: Tensor, y_i: Tensor, *, w: int, h: int, mode: str = "nearest",
    weights: Tensor | None = None,
) -> Tensor:
    """Scatter-add votes into dsi (..., Nz, h, w); returns the new volume.

    x_i, y_i: (..., Nz, E) projected coords; weights: optional (..., Nz, E).
    """
    x_i, y_i = _sanitize(x_i), _sanitize(y_i)
    base = torch.ones_like(x_i) if weights is None else weights
    plane = _plane_offsets(dsi)
    if mode == "nearest":
        m = _bounds_mask_nearest(x_i, y_i, w, h)
        xr = torch.clamp(_round_half_up(x_i).to(torch.int64), 0, w - 1)
        yr = torch.clamp(_round_half_up(y_i).to(torch.int64), 0, h - 1)
        votes = torch.where(m, base, torch.zeros_like(base))
        if dsi.dtype in (torch.int16, torch.int32):
            votes = votes.to(dsi.dtype)
        idx = plane + yr * w + xr
        return dsi.reshape(-1).index_add(0, idx.reshape(-1), votes.reshape(-1)
                                         ).reshape(dsi.shape)
    if mode == "bilinear":
        m = _bounds_mask_bilinear(x_i, y_i, w, h)
        x0 = torch.clamp(torch.floor(x_i).to(torch.int64), 0, w - 2)
        y0 = torch.clamp(torch.floor(y_i).to(torch.int64), 0, h - 2)
        fx = x_i - x0.to(x_i.dtype)
        fy = y_i - y0.to(y_i.dtype)
        wmask = torch.where(m, base, torch.zeros_like(base))
        out = dsi.to(torch.float32).reshape(-1)
        for dx, dy, wgt in (
            (0, 0, (1 - fx) * (1 - fy)),
            (1, 0, fx * (1 - fy)),
            (0, 1, (1 - fx) * fy),
            (1, 1, fx * fy),
        ):
            idx = plane + (y0 + dy) * w + (x0 + dx)
            out = out.index_add(0, idx.reshape(-1), (wmask * wgt).reshape(-1))
        return out.reshape(dsi.shape).to(dsi.dtype)
    raise ValueError(f"unknown voting mode: {mode}")


def onehot_rows_nearest(coord: Tensor, size: int, valid: Tensor) -> Tensor:
    """(..., E) coords -> (..., E, size) one-hot rows; invalid rows all-zero."""
    idx = _round_half_up(coord).to(torch.int64)
    grid = torch.arange(size, device=coord.device)
    rows = (idx[..., None] == grid).to(torch.float32)
    return rows * valid[..., None].to(torch.float32)


def twohot_rows_bilinear(coord: Tensor, size: int, valid: Tensor) -> Tensor:
    """(..., E) coords -> (..., E, size) two-hot rows with (1-f, f) weights."""
    c0 = torch.floor(coord).to(torch.int64)
    f = coord - c0.to(coord.dtype)
    grid = torch.arange(size, device=coord.device)
    lo = (c0[..., None] == grid).to(torch.float32) * (1.0 - f)[..., None]
    hi = ((c0 + 1)[..., None] == grid).to(torch.float32) * f[..., None]
    return (lo + hi) * valid[..., None].to(torch.float32)


def vote_onehot_matmul(
    dsi: Tensor, x_i: Tensor, y_i: Tensor, *, w: int, h: int, mode: str = "nearest",
    weights: Tensor | None = None,
) -> Tensor:
    """Per-plane votes = Oy^T @ Ox, accumulated into dsi (..., Nz, h, w)."""
    x_i, y_i = _sanitize(x_i), _sanitize(y_i)
    if mode == "nearest":
        valid = _bounds_mask_nearest(x_i, y_i, w, h)
        ox = onehot_rows_nearest(x_i, w, valid)
        oy = onehot_rows_nearest(y_i, h, valid)
    elif mode == "bilinear":
        valid = _bounds_mask_bilinear(x_i, y_i, w, h)
        ox = twohot_rows_bilinear(x_i, w, valid)
        oy = twohot_rows_bilinear(y_i, h, valid)
    else:
        raise ValueError(f"unknown voting mode: {mode}")
    if weights is not None:
        ox = ox * weights[..., None]
    votes = torch.matmul(oy.transpose(-1, -2), ox)  # contraction over events
    if dsi.dtype in (torch.int16, torch.int32):
        # RTL rounding convention: half away from zero
        votes = round_half_away(votes).to(dsi.dtype)
    return dsi + votes
