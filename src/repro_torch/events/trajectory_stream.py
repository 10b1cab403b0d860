"""Streamed trajectory: pose interpolation, the out-of-span policy and
incremental pose ingestion with a safety watermark, in PyTorch.

Counterpart of `repro.events.trajectory_stream`. A tracker delivers poses
in chunks behind the event front; `TrajectoryBuffer` holds them on the
host and keeps a monotonically advancing **pose-lag watermark**, the
latest time that received samples bracket. Queries outside the covered
span raise `PoseExtrapolationError` instead of freezing the pose at an
endpoint. `pose_at_times` interpolates on the trajectory's device;
`enforce_pose_span` is the out-of-span policy ("clamp", "warn", "raise")
shared by the offline and the streaming aggregation.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.core.geometry import SE3, interpolate_pose, matmul3, so3_log
from repro_torch.device import to_host
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


_F32 = np.float32


def _fma_operand(a: np.ndarray) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _matmul3_host(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """`geometry.matmul3` on host arrays: the same three-term chain, its two
    fused multiply-adds by `torch.addcmul` on the same shapes."""
    p = A[..., :, 0, None] * B[..., None, 0, :]
    r = torch.addcmul(torch.from_numpy(p), _fma_operand(A[..., :, 1, None]),
                      _fma_operand(B[..., None, 1, :]))
    return torch.addcmul(r, _fma_operand(A[..., :, 2, None]),
                         _fma_operand(B[..., None, 2, :])).numpy()


def _so3_exp_host(w: np.ndarray) -> np.ndarray:
    """`geometry.so3_exp` on a host array, rounding as it does: the norm,
    sin, cos and the fused multiply-adds through the same torch calls, every
    other step a float32 operation that numpy rounds alike."""
    theta_t = torch.linalg.vector_norm(torch.from_numpy(w), dim=-1)[..., None, None]
    sin, cos = torch.sin(theta_t).numpy(), torch.cos(theta_t).numpy()
    theta = theta_t.numpy()
    small = theta < _F32(1e-8)
    safe = np.where(small, _F32(1.0), theta)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    K = np.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], -1).reshape(
        *w.shape[:-1], 3, 3) / safe
    eye = np.broadcast_to(np.eye(3, dtype=_F32), K.shape)
    R = eye + sin * K + (_F32(1.0) - cos) * _matmul3_host(K, K)
    return np.where(small, eye, R)


class PoseInterpolator:
    """`pose_at_times` over one fully known trajectory, on the host, for
    many small queries: a stream poses each frame as its push completes it.

    Bitwise what `pose_at_times` gives on the CPU, for any batch of
    queries. Each interval's rotation log, `so3_log(R[k+1] R[k]^T)`, is
    taken once for the whole trajectory instead of once per query; the
    per-query arithmetic runs on host arrays, except the norm, sin, cos and
    the fused multiply-adds, which go through the same torch calls as
    `geometry`'s. Out-of-span queries clamp, as in `pose_at_times`.
    """

    def __init__(self, traj: Trajectory):
        self._times = to_host(traj.times, np.float32)
        n = int(self._times.shape[0])
        if n < 2:
            raise ValueError(
                f"pose interpolation needs at least 2 trajectory samples, got "
                f"{n}: one sample cannot bracket any query time")
        R = torch.from_numpy(to_host(traj.poses.R, np.float32))
        self._R = R.numpy()
        self._t = to_host(traj.poses.t, np.float32)
        self._w = so3_log(matmul3(R[1:], R[:-1].transpose(-1, -2))).numpy()

    def __call__(self, t_query) -> SE3:
        """Poses (CPU tensors) at the query times."""
        return SE3(torch.from_numpy(self.rotations(t_query)),
                   torch.from_numpy(self.translations(t_query)))

    def _interval(self, t_query) -> tuple[np.ndarray, np.ndarray]:
        tq = to_host(t_query, np.float32)
        n = self._times.shape[0]
        idx = np.clip(np.searchsorted(self._times, tq, side="right") - 1, 0, n - 2)
        t0, t1 = self._times[idx], self._times[idx + 1]
        frac = np.clip((tq - t0) / np.maximum(t1 - t0, _F32(1e-9)),
                       _F32(0.0), _F32(1.0))[..., None]
        return idx, frac

    def translations(self, t_query) -> np.ndarray:
        """The poses' translations at the query times, (n, 3): a few numpy
        operations, for callers that need the rotations only later."""
        idx, frac = self._interval(t_query)
        return self._t[idx] + frac * (self._t[idx + 1] - self._t[idx])

    def rotations(self, t_query) -> np.ndarray:
        """The poses' rotations at the query times, (n, 3, 3). The fixed
        cost of a call is most of its cost, so many queries are best
        posed in one call; the bits do not depend on the batch."""
        idx, frac = self._interval(t_query)
        return _matmul3_host(_so3_exp_host(self._w[idx] * frac), self._R[idx])


class TrajectoryBuffer:
    """Incrementally received trajectory with a pose-lag watermark, on the host.

    Pose chunks are pushed in time order (each chunk strictly after the
    previous one; times strictly increasing within a chunk). The
    **watermark** is the latest time interpolation is bracketed by
    received samples: `times[-1]` once at least two samples exist, `-inf`
    before that; it only ever advances. `pose_at_times` answers queries
    within `[start_time, watermark]` and raises `PoseExtrapolationError`
    outside it.

    For a query `t < watermark` the bracketing interval can no longer
    change when later chunks arrive, so interpolating from a prefix of the
    trajectory is bit-identical to interpolating from the full one; at
    `t == watermark` it still can, so callers that need bitwise offline
    equivalence gate on strict inequality until the pose stream ends.
    Chunks may be numpy arrays or tensors on any device.
    """

    def __init__(self, chunk: Trajectory | None = None):
        self._times = np.zeros((0,), np.float32)
        self._R = np.zeros((0, 3, 3), np.float32)
        self._t = np.zeros((0, 3), np.float32)
        if chunk is not None:
            self.push(chunk)

    @property
    def num_samples(self) -> int:
        return int(self._times.shape[0])

    @property
    def watermark(self) -> float:
        """Latest safely interpolable time; -inf until 2 samples exist."""
        if self.num_samples < 2:
            return float("-inf")
        return float(self._times[-1])

    @property
    def start_time(self) -> float:
        """Earliest covered time; +inf until 2 samples exist."""
        if self.num_samples < 2:
            return float("inf")
        return float(self._times[0])

    def push(self, chunk: Trajectory) -> float:
        """Append one pose chunk; returns the (possibly advanced) watermark.

        Chunks must arrive in time order: strictly increasing times within
        the chunk, and strictly after everything already buffered. Empty
        chunks are allowed (a tracker tick with no new poses).
        """
        times = to_host(chunk.times, np.float32).reshape(-1)
        R = to_host(chunk.poses.R, np.float32)
        t = to_host(chunk.poses.t, np.float32)
        m = times.shape[0]
        if R.shape != (m, 3, 3) or t.shape != (m, 3):
            raise ValueError(
                f"pose chunk shape mismatch: {m} times vs R {R.shape}, "
                f"t {t.shape}")
        if m == 0:
            return self.watermark
        if np.any(np.diff(times) <= 0):
            raise ValueError("pose chunk times must be strictly increasing")
        if self.num_samples and times[0] <= self._times[-1]:
            raise ValueError(
                f"pose chunk starts at t={float(times[0]):.6g} but the "
                f"buffer already covers up to t={float(self._times[-1]):.6g}: "
                f"chunks must arrive in time order")
        self._times = np.concatenate([self._times, times])
        self._R = np.concatenate([self._R, R])
        self._t = np.concatenate([self._t, t])
        return self.watermark

    @property
    def times(self) -> np.ndarray:
        """Host view of the received sample times (do not mutate)."""
        return self._times

    def covers(self, t_query) -> np.ndarray:
        """Elementwise: is the query bracketed by received samples?"""
        tq = to_host(t_query, np.float32)
        if self.num_samples < 2:
            return np.zeros(tq.shape, bool)
        return (tq >= self._times[0]) & (tq <= self._times[-1])

    def trajectory(self, lo: int = 0, hi: int | None = None) -> Trajectory:
        """Samples [lo, hi) (everything by default) as CPU tensors that share
        the buffer's memory. Callers that interpolate repeatedly over an
        unbounded stream pass the slice that brackets their queries."""
        sl = slice(lo, hi)
        return Trajectory(times=torch.from_numpy(self._times[sl]),
                          poses=SE3(torch.from_numpy(self._R[sl]),
                                    torch.from_numpy(self._t[sl])))

    def pose_at_times(self, t_query) -> SE3:
        """Interpolate within the covered span only (on the CPU).

        Raises `PoseExtrapolationError` for any query outside
        `[start_time, watermark]`, and for every query while fewer than
        two samples have been received.
        """
        if self.num_samples < 2:
            raise PoseExtrapolationError(
                f"trajectory buffer holds {self.num_samples} pose sample(s); "
                f"interpolation needs at least 2 (watermark {self.watermark})")
        tq = to_host(t_query, np.float32)
        enforce_pose_span(
            self._times, tq, "raise",
            context=f"streamed trajectory (watermark t={self.watermark:.6g})")
        return pose_at_times(self.trajectory(), torch.from_numpy(tq))
