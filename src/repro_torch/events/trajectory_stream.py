"""Pose interpolation and the out-of-span policy, in PyTorch.

Counterpart of the offline part of `repro.events.trajectory_stream`:
`pose_at_times`, `enforce_pose_span` and the error/warning classes. The
streamed `TrajectoryBuffer` is not ported yet.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.geometry import SE3, interpolate_pose
from repro_torch.events.simulator import Trajectory

Tensor = torch.Tensor

# Out-of-span pose-query policies: "clamp" silently freezes the pose at the
# nearest trajectory endpoint, "warn" clamps with PoseExtrapolationWarning,
# "raise" refuses with PoseExtrapolationError.
POSE_EXTRAPOLATION_POLICIES = ("clamp", "warn", "raise")


class PoseExtrapolationError(RuntimeError):
    """A pose query fell outside the span covered by trajectory samples."""


class PoseStallError(RuntimeError):
    """A streaming flush was asked to finish while frames still await poses."""


class PoseExtrapolationWarning(UserWarning):
    """A pose query outside the trajectory span was clamped to an endpoint."""


def enforce_pose_span(times: np.ndarray, t_query, policy: str,
                      context: str = "pose query") -> None:
    """Apply the out-of-span policy for queries against host `times`
    (at least 2 sorted samples)."""
    if policy not in POSE_EXTRAPOLATION_POLICIES:
        raise ValueError(
            f"unknown pose_extrapolation policy {policy!r}: expected one of "
            f"{POSE_EXTRAPOLATION_POLICIES}")
    if policy == "clamp":
        return
    tq = np.atleast_1d(np.asarray(t_query))
    t0, t1 = float(times[0]), float(times[-1])
    below = tq < t0
    above = tq > t1
    n_out = int(below.sum() + above.sum())
    if n_out == 0:
        return
    worst = float(tq.max()) if above.any() else float(tq.min())
    msg = (f"{context}: {n_out} of {tq.shape[0]} query time(s) outside the "
           f"trajectory span [{t0:.6g}, {t1:.6g}] (worst t={worst:.6g}); "
           f"interpolation would freeze the pose at the span endpoint")
    if policy == "raise":
        raise PoseExtrapolationError(msg)
    warnings.warn(msg, PoseExtrapolationWarning, stacklevel=2)


def pose_at_times(traj: Trajectory, t_query: Tensor, *, strict: bool = False) -> SE3:
    """Interpolate trajectory poses at query times (vectorized), on the
    trajectory's device. Out-of-span queries clamp unless `strict`."""
    times = torch.as_tensor(traj.times)
    n = int(times.shape[0])
    if n < 2:
        raise ValueError(
            f"pose interpolation needs at least 2 trajectory samples, got "
            f"{n}: one sample cannot bracket any query time")
    if strict:
        enforce_pose_span(times.cpu().numpy(), np.asarray(t_query), "raise")
    R = torch.as_tensor(traj.poses.R, device=times.device)
    t = torch.as_tensor(traj.poses.t, device=times.device)
    tq = torch.as_tensor(t_query, dtype=torch.float32, device=times.device)
    idx = torch.clamp(torch.searchsorted(times, tq, right=True) - 1, 0, n - 2)
    t0, t1 = times[idx], times[idx + 1]
    frac = torch.clamp((tq - t0) / torch.clamp(t1 - t0, min=1e-9), 0.0, 1.0)
    return interpolate_pose(SE3(R[idx], t[idx]), SE3(R[idx + 1], t[idx + 1]),
                            frac[..., None])
