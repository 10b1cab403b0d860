"""Plain PyTorch version of the detection reduction (stage D hot loop).

Counterpart of `repro.kernels.local_max.ref`. Per pixel:
  conf — max_z DSI
  zf   — first argmax_z refined by a 3-point parabola, offset clipped to ±0.5
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def depth_argmax_ref(dsi: Tensor) -> tuple[Tensor, Tensor]:
    """dsi (..., Nz, h, w) -> (conf (..., h, w) f32, zf (..., h, w) f32)."""
    dsi_f = dsi.to(torch.float32)
    nz = dsi.shape[-3]
    conf, zidx = torch.max(dsi_f, dim=-3)  # first maximal index
    zm = torch.clamp(zidx - 1, 0, nz - 1)
    zp = torch.clamp(zidx + 1, 0, nz - 1)
    cm = torch.gather(dsi_f, -3, zm.unsqueeze(-3)).squeeze(-3)
    c0 = torch.gather(dsi_f, -3, zidx.unsqueeze(-3)).squeeze(-3)
    cp = torch.gather(dsi_f, -3, zp.unsqueeze(-3)).squeeze(-3)
    denom = cm - 2.0 * c0 + cp
    offset = torch.where(torch.abs(denom) > 1e-6, 0.5 * (cm - cp) / denom,
                         torch.zeros_like(denom))
    offset = torch.clamp(offset, -0.5, 0.5)
    return conf, zidx.to(torch.float32) + offset
