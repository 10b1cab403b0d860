"""Public wrapper for the frame poses: the device picks the path.

A CPU tensor takes the plain version (`ref.py`), a CUDA tensor launches
the kernel (one launch a call), a meta tensor traces it; any other device
raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import SE3
from repro_torch.kernels.frame_poses.kernel import frame_poses_cuda
from repro_torch.kernels.frame_poses.ref import frame_poses_ref

Tensor = torch.Tensor


def frame_poses(times: Tensor, R: Tensor, t: Tensor, t_query: Tensor) -> SE3:
    """The trajectory's poses (times (N,), R (N, 3, 3), t (N, 3)) interpolated
    at the frames' mid-times `t_query` (F,): the bracketing samples, the
    translation lerp, the rotation by axis-angle; out-of-span queries clamp
    to the end samples."""
    if times.device.type == "cpu":
        return frame_poses_ref(times, R, t, t_query)
    if times.device.type not in ("cuda", "meta"):
        raise ValueError(f"frame_poses: no path for device {times.device}")
    return SE3(*frame_poses_cuda(*(x.contiguous() for x in (times, R, t, t_query))))
