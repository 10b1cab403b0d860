"""Plain PyTorch version of the frame-pose kernel: `pose_at_times`.

The reference interpolates poses as plain JAX. The CUDA kernel equals this
chain, run eagerly on the card, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core.geometry import SE3
from repro_torch.events.simulator import Trajectory
from repro_torch.events.trajectory_stream import pose_at_times

Tensor = torch.Tensor


def frame_poses_ref(times: Tensor, R: Tensor, t: Tensor, t_query: Tensor) -> SE3:
    """The trajectory `(times, R, t)` interpolated at `t_query`, clamped
    outside its span."""
    return pose_at_times(Trajectory(times, SE3(R, t)), t_query)
