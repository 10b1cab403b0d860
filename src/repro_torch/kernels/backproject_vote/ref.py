"""Plain PyTorch version of the fused back-projection + vote (+ detection).

Counterpart of `repro.kernels.backproject_vote.ref`: given canonical-plane
event coords xy0 (F, E, 2), validity (F, E) and per-frame coefficients
phi (F, Nz, 3) = (alpha, beta_x, beta_y), the DSI (Nz, h, w) is

    x_i = alpha[z] * (x0 - cx) + beta_x[z] + cx
    y_i = alpha[z] * (y0 - cy) + beta_y[z] + cy
    DSI[z] += sum_e onehot(y_i[e]) ⊗ onehot(x_i[e])     (nearest)
    DSI[z] += sum_e twohot(y_i[e]) ⊗ twohot(x_i[e])     (bilinear)

with out-of-bounds projections dropped against the logical w, h.
`backproject_vote_detect_ref` adds the store and the detection reduction
of `kernels/local_max/ref.py`: the fused datapath the CUDA wrapper runs.
"""
from __future__ import annotations

import torch

from repro_torch.core import dsi as dsi_lib
from repro_torch.core.voting import _sanitize
from repro_torch.kernels.local_max.ref import depth_argmax_ref
from repro_torch.quant.policies import TABLE1

Tensor = torch.Tensor


def _vote_frame(xy: Tensor, v: Tensor, ph: Tensor, *, cx: float, cy: float,
                w: int, h: int, mode: str, quantize_plane_coords: bool) -> Tensor:
    alpha, beta_x, beta_y = ph[:, 0:1], ph[:, 1:2], ph[:, 2:3]
    x_i = torch.addcmul(beta_x, alpha, xy[None, :, 0] - cx) + cx
    y_i = torch.addcmul(beta_y, alpha, xy[None, :, 1] - cy) + cy
    if quantize_plane_coords:
        x_i, y_i = TABLE1.quantize_plane_coords(x_i, y_i)
    x_i, y_i = _sanitize(x_i), _sanitize(y_i)
    vf = v.to(torch.float32)
    gx = torch.arange(w, dtype=torch.float32, device=xy.device)
    gy = torch.arange(h, dtype=torch.float32, device=xy.device)
    if mode == "nearest":
        # RTL convention: round half up (floor(x + 0.5)), as in the kernel
        xr, yr = torch.floor(x_i + 0.5), torch.floor(y_i + 0.5)
        ok = (xr >= 0) & (xr <= w - 1) & (yr >= 0) & (yr <= h - 1)
        wt = vf[None, :] * ok.to(torch.float32)
        ox = (xr[..., None] == gx).to(torch.float32) * wt[..., None]
        oy = (yr[..., None] == gy).to(torch.float32)
    elif mode == "bilinear":
        x0f, y0f = torch.floor(x_i), torch.floor(y_i)
        ok = (x0f >= 0) & (x0f + 1 <= w - 1) & (y0f >= 0) & (y0f + 1 <= h - 1)
        wt = vf[None, :] * ok.to(torch.float32)
        fx, fy = x_i - x0f, y_i - y0f
        ox = ((x0f[..., None] == gx) * (1 - fx)[..., None]
              + ((x0f + 1)[..., None] == gx) * fx[..., None])
        oy = ((y0f[..., None] == gy) * (1 - fy)[..., None]
              + ((y0f + 1)[..., None] == gy) * fy[..., None])
        ox = ox * wt[..., None]
    else:
        raise ValueError(f"unknown voting mode: {mode}")
    return torch.bmm(oy.transpose(1, 2), ox)  # (Nz, h, w): contraction over events


def backproject_vote_ref(
    xy0: Tensor,  # (..., F, E, 2) float32 canonical coords
    valid: Tensor,  # (..., F, E) bool or float
    phi: Tensor,  # (..., F, Nz, 3) float32: alpha, beta_x, beta_y
    *,
    cx: float,
    cy: float,
    w: int,
    h: int,
    mode: str = "nearest",
    quantize_plane_coords: bool = False,
) -> Tensor:
    """Float32 DSI (..., Nz, h, w), accumulated frame by frame.

    `quantize_plane_coords` applies the Table-1 int8 plane-coord rule
    (through the policy object) before the vote sanitize, as the quantized
    nearest datapath does.
    """
    lead = xy0.shape[:-3]
    f, e = xy0.shape[-3:-1]
    nz = phi.shape[-2]
    xy0 = xy0.reshape(-1, f, e, 2)
    valid = valid.reshape(-1, f, e)
    phi = phi.reshape(-1, f, nz, 3)
    out = torch.zeros((xy0.shape[0], nz, h, w), dtype=torch.float32, device=xy0.device)
    for s in range(xy0.shape[0]):
        for k in range(f):
            out[s] += _vote_frame(xy0[s, k], valid[s, k], phi[s, k], cx=cx, cy=cy,
                                  w=w, h=h, mode=mode,
                                  quantize_plane_coords=quantize_plane_coords)
    return out.reshape(*lead, nz, h, w)


def backproject_vote_detect_ref(
    xy0: Tensor, valid: Tensor, phi: Tensor, *, cx: float, cy: float, w: int,
    h: int, mode: str = "nearest", quantized: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """`(dsi, conf, zf)`: the vote, the store (int16 clamp-then-truncate when
    `quantized`, else float32) and the depth reduction of the stored DSI."""
    acc = backproject_vote_ref(
        xy0, valid, phi, cx=cx, cy=cy, w=w, h=h, mode=mode,
        quantize_plane_coords=quantized and mode == "nearest")
    dsi = dsi_lib.to_storage(acc) if quantized else acc
    conf, zf = depth_argmax_ref(dsi)
    return dsi, conf, zf
