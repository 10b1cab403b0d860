"""Public wrapper for the detection reduction: the device picks the path."""
from __future__ import annotations

import torch

from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
from repro_torch.kernels.local_max.ref import depth_argmax_ref

Tensor = torch.Tensor


def depth_argmax(dsi: Tensor) -> tuple[Tensor, Tensor]:
    """(conf, refined argmax) over the depth axis of a DSI (..., Nz, h, w).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one launch for any leading batch), a meta tensor traces it;
    any other device raises.
    """
    if dsi.device.type == "cpu":
        return depth_argmax_ref(dsi)
    if dsi.device.type not in ("cuda", "meta"):
        raise ValueError(f"depth_argmax: no path for device {dsi.device}")
    lead = dsi.shape[:-3]
    conf, zf = depth_argmax_cuda(dsi.reshape(-1, *dsi.shape[-3:]))
    return conf.reshape(*lead, *conf.shape[-2:]), zf.reshape(*lead, *zf.shape[-2:])
