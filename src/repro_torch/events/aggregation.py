"""Event aggregation (A): stream -> fixed-size event frames, in PyTorch.

Counterpart of `repro.events.aggregation`: 1024 events per frame (paper
§4.3), one pose per frame interpolated at the frame's median timestamp.
`StreamingAggregator` carries the partial-frame remainder across pushes on
the host, so any chunking of a stream gives the same frames; the offline
`aggregate` is one push plus a flush. Emitted frames are tensors on the
aggregator's device.

Poses come from a fully-known `Trajectory` (the offline oracle) or from a
`TrajectoryBuffer` fed the tracker's pose chunks. In that pose-gated mode a
completed frame whose mid-time is not strictly below the buffer's
watermark stalls until the bracketing pose chunk arrives, and is then
posed bit-identically to the oracle, so any interleaving of event and pose
chunks gives the same frames.
"""
from __future__ import annotations

from collections import deque
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.camera import CameraModel, undistort_events
from repro_torch.core.geometry import SE3
from repro_torch.device import resolve_device, to_host
from repro_torch.events.simulator import EventStream, Trajectory
from repro_torch.events.stream_hygiene import check_chunk_monotone
from repro_torch.events.trajectory_stream import (
    POSE_EXTRAPOLATION_POLICIES,
    PoseExtrapolationError,
    PoseStallError,
    TrajectoryBuffer,
    enforce_pose_span,
    pose_at_times,
)

Tensor = torch.Tensor

EVENTS_PER_FRAME = 1024  # paper §4.3

# Pad coordinate for events that only fill out a frame: parked far outside
# the image so every downstream stage masks them.
PARKED_COORD = -1e4


class EventFrames(NamedTuple):
    """Aggregated frames, as tensors on one device."""

    xy: Tensor  # (F, E, 2) rectified coords
    valid: Tensor  # (F, E) bool
    t_mid: Tensor  # (F,)
    poses: SE3  # batched (F,3,3),(F,3): per-frame camera pose


def empty_event_frames(events_per_frame: int = EVENTS_PER_FRAME, device=None
                       ) -> EventFrames:
    """A zero-frame EventFrames with the usual field shapes/dtypes."""
    f32 = torch.float32
    return EventFrames(
        xy=torch.zeros((0, events_per_frame, 2), dtype=f32, device=device),
        valid=torch.zeros((0, events_per_frame), dtype=torch.bool, device=device),
        t_mid=torch.zeros((0,), dtype=f32, device=device),
        poses=SE3(torch.zeros((0, 3, 3), dtype=f32, device=device),
                  torch.zeros((0, 3), dtype=f32, device=device)),
    )


def concat_event_frames(parts: list[EventFrames]) -> EventFrames:
    """Concatenate EventFrames along the frame axis (empties dropped)."""
    parts = [p for p in parts if p.xy.shape[0] > 0]
    if not parts:
        return empty_event_frames()
    if len(parts) == 1:
        return parts[0]
    return EventFrames(
        xy=torch.cat([p.xy for p in parts]),
        valid=torch.cat([p.valid for p in parts]),
        t_mid=torch.cat([p.t_mid for p in parts]),
        poses=SE3(torch.cat([p.poses.R for p in parts]),
                  torch.cat([p.poses.t for p in parts])),
    )


class _StalledFrame(NamedTuple):
    """A completed frame waiting for its bracketing pose samples."""

    xy: np.ndarray  # (E, 2)
    valid: np.ndarray  # (E,)
    t_mid: float


class StreamingAggregator:
    """Incremental A stage: push raw event chunks, receive completed frames.

    Each `push` applies distortion correction to the chunk, prepends the
    remainder of the previous push, and emits every completed
    `events_per_frame`-sized frame with its interpolated pose; `flush`
    emits the tail as one frame padded with parked, invalid events. Any
    chunking of a stream gives bitwise the same frames.

    Pose source (`traj`):
      * a `Trajectory` — the offline oracle; every completed frame is posed
        at once. Frame mid-times outside the trajectory span follow
        `pose_extrapolation` ("warn" clamps with a warning, "raise"
        refuses, "clamp" is silent).
      * a `TrajectoryBuffer` — the streamed tracker. Completed frames whose
        `t_mid` is not yet strictly below the buffer's watermark stall
        (`stalled_frames`) and are released in order by `push_poses` /
        `finalize_poses` once the bracketing samples arrive, posed
        bit-identically to the oracle. `finalize_poses` declares the pose
        stream over: the frames left release through `pose_extrapolation`.

    `max_stalled` (pose-gated mode only) bounds the frames a push may
    leave stalled past the current watermark: beyond it the push raises
    `PoseStallError` after buffering the frames, so no event is lost and
    pushing the missing pose chunks recovers.
    """

    def __init__(self, cam: CameraModel, traj: Trajectory | TrajectoryBuffer,
                 events_per_frame: int = EVENTS_PER_FRAME, *,
                 pose_extrapolation: str = "warn",
                 max_stalled: int | None = None, device=None):
        if events_per_frame < 1:
            raise ValueError(f"events_per_frame must be >= 1, got {events_per_frame}")
        if pose_extrapolation not in POSE_EXTRAPOLATION_POLICIES:
            raise ValueError(
                f"unknown pose_extrapolation policy {pose_extrapolation!r}: "
                f"expected one of {POSE_EXTRAPOLATION_POLICIES}")
        if max_stalled is not None and max_stalled < 1:
            raise ValueError(
                f"max_stalled must be >= 1 (or None for unbounded), got "
                f"{max_stalled}")
        self.device = resolve_device(device)
        self.cam = cam
        self._gated = isinstance(traj, TrajectoryBuffer)
        if max_stalled is not None and not self._gated:
            raise ValueError(
                "max_stalled requires a TrajectoryBuffer pose source: a "
                "fully-known Trajectory oracle never stalls frames, so "
                "the bound would silently do nothing")
        if self._gated:
            self.traj = traj
            self._traj_times_host = None
        else:
            self.traj = Trajectory(
                times=torch.as_tensor(traj.times, device=self.device),
                poses=SE3(torch.as_tensor(traj.poses.R, device=self.device),
                          torch.as_tensor(traj.poses.t, device=self.device)))
            self._traj_times_host = to_host(traj.times, np.float32)
        self.pose_extrapolation = pose_extrapolation
        self.max_stalled = max_stalled
        self.events_per_frame = int(events_per_frame)
        self._rem_xy = np.zeros((0, 2), np.float32)
        self._rem_t = np.zeros((0,), np.float32)
        self._rem_valid = np.zeros((0,), bool)
        self._last_t = float("-inf")
        self._stalled: deque[_StalledFrame] = deque()
        self._pose_final = False

    @property
    def pending_events(self) -> int:
        """Events buffered toward the next (incomplete) frame."""
        return self._rem_xy.shape[0]

    @property
    def pose_gated(self) -> bool:
        """True when the pose source is a streamed `TrajectoryBuffer`."""
        return self._gated

    @property
    def stalled_frames(self) -> int:
        """Completed frames held back waiting for pose chunks."""
        return len(self._stalled)

    @property
    def oldest_stalled_t(self) -> float:
        """Mid-time of the oldest stalled frame (+inf if none)."""
        return self._stalled[0].t_mid if self._stalled else float("inf")

    @property
    def pose_watermark(self) -> float:
        """Latest safely interpolable pose time received so far."""
        if self._gated:
            return self.traj.watermark
        return float(self._traj_times_host[-1])

    def push(self, chunk: EventStream) -> EventFrames:
        """Ingest a chunk (sorted, contiguous with prior pushes) of events;
        a regressing chunk raises (`NonMonotoneEventError` /
        `StreamOverlapError`)."""
        t_chunk = to_host(chunk.t, np.float32)
        check_chunk_monotone(t_chunk, self._last_t,
                             context="StreamingAggregator.push")
        if t_chunk.shape[0]:
            self._last_t = float(t_chunk[-1])
        xy = chunk.xy
        if self.cam.has_distortion():
            xy = undistort_events(self.cam, torch.as_tensor(xy, device=self.device))
        xy = np.concatenate([self._rem_xy, to_host(xy, np.float32)])
        t = np.concatenate([self._rem_t, t_chunk])
        valid = np.concatenate([self._rem_valid, to_host(chunk.valid, bool)])
        e = self.events_per_frame
        n_frames = xy.shape[0] // e
        n_keep = n_frames * e
        self._rem_xy, self._rem_t, self._rem_valid = (
            xy[n_keep:], t[n_keep:], valid[n_keep:])
        return self._emit(xy[:n_keep], t[:n_keep], valid[:n_keep], n_frames)

    def push_poses(self, chunk: Trajectory) -> EventFrames:
        """Feed one pose chunk to the streamed trajectory; returns the
        stalled frames the advanced watermark releases (possibly none)."""
        if not self._gated:
            raise RuntimeError(
                "push_poses requires a TrajectoryBuffer pose source; this "
                "aggregator was built with a fully-known Trajectory oracle")
        self.traj.push(chunk)
        return self._release()

    def finalize_poses(self) -> EventFrames:
        """Declare the pose stream complete and release every stalled frame;
        those at or past the final watermark release through the
        `pose_extrapolation` policy."""
        if not self._gated:
            raise RuntimeError(
                "finalize_poses requires a TrajectoryBuffer pose source; "
                "a Trajectory oracle is always complete")
        self._pose_final = True
        return self._release()

    def flush(self) -> EventFrames:
        """Emit the buffered tail as one padded frame (empty if no tail).

        In pose-gated mode the tail frame joins the stall queue like any
        other; the result holds only what the current watermark releases."""
        e = self.events_per_frame
        n_rem = self._rem_xy.shape[0]
        if n_rem == 0:
            return self._release() if self._gated else empty_event_frames(e, self.device)
        # t_mid from the REAL tail events only
        t_mid = np.asarray(np.median(self._rem_t), np.float32).reshape(1)
        pad = e - n_rem
        xy = np.concatenate(
            [self._rem_xy, np.full((pad, 2), PARKED_COORD, np.float32)])
        t = np.concatenate(
            [self._rem_t, np.full((pad,), self._rem_t[-1], np.float32)])
        valid = np.concatenate([self._rem_valid, np.zeros((pad,), bool)])
        self._rem_xy = np.zeros((0, 2), np.float32)
        self._rem_t = np.zeros((0,), np.float32)
        self._rem_valid = np.zeros((0,), bool)
        return self._emit(xy, t, valid, 1, t_mid=t_mid)

    def _emit(self, xy: np.ndarray, t: np.ndarray, valid: np.ndarray,
              n_frames: int, t_mid: np.ndarray | None = None) -> EventFrames:
        e = self.events_per_frame
        if n_frames == 0:
            return self._release() if self._gated else empty_event_frames(e, self.device)
        if t_mid is None:
            t_mid = np.median(t.reshape(n_frames, e), axis=1)
        t_mid = np.asarray(t_mid, np.float32)
        xy_f = xy.reshape(n_frames, e, 2)
        valid_f = valid.reshape(n_frames, e)
        if self._gated:
            for k in range(n_frames):
                self._stalled.append(_StalledFrame(xy_f[k], valid_f[k], float(t_mid[k])))
            # Max-stall back-pressure: only frames the current watermark
            # cannot release count, and the check runs after buffering and
            # before any release, so on overflow no frame is lost
            if self.max_stalled is not None:
                wm = self.pose_watermark
                backlog = sum(1 for f in self._stalled if not f.t_mid < wm)
                if backlog > self.max_stalled:
                    raise PoseStallError(
                        f"pose tracker too far behind the event front: "
                        f"{backlog} frame(s) stalled past the watermark "
                        f"exceeds max_stalled={self.max_stalled} (watermark "
                        f"t={wm:.6g}, oldest stalled frame "
                        f"t_mid={self.oldest_stalled_t:.6g}); the frames "
                        f"are buffered — push the missing pose chunks to "
                        f"drain the stall queue before feeding more events")
            return self._release()
        enforce_pose_span(self._traj_times_host, t_mid,
                          self.pose_extrapolation, context="frame mid-times")
        return self._frames(xy_f, valid_f, t_mid, self.traj)

    def _frames(self, xy: np.ndarray, valid: np.ndarray, t_mid: np.ndarray,
                traj: Trajectory) -> EventFrames:
        """EventFrames on the aggregator's device, posed from `traj`."""
        t_mid_d = torch.from_numpy(t_mid).to(self.device)
        return EventFrames(
            xy=torch.from_numpy(xy).to(self.device),
            valid=torch.from_numpy(valid).to(self.device),
            t_mid=t_mid_d,
            poses=pose_at_times(traj, t_mid_d),
        )

    def _release(self) -> EventFrames:
        """Pose and emit the oldest stalled frames the watermark covers
        (everything, once the pose stream is finalized)."""
        e = self.events_per_frame
        if not self._stalled:
            return empty_event_frames(e, self.device)
        buf: TrajectoryBuffer = self.traj
        if buf.num_samples < 2:
            if self._pose_final:
                raise PoseExtrapolationError(
                    f"pose stream finalized with {buf.num_samples} sample(s) "
                    f"received; {len(self._stalled)} stalled frame(s) can "
                    f"never be posed")
            return empty_event_frames(e, self.device)
        if self._pose_final:
            take = len(self._stalled)
        else:
            # strictly below the watermark: the bracketing interval can no
            # longer change, so the pose is the one the full trajectory gives
            wm = buf.watermark
            take = 0
            while take < len(self._stalled) and self._stalled[take].t_mid < wm:
                take += 1
        if take == 0:
            return empty_event_frames(e, self.device)
        frames = [self._stalled.popleft() for _ in range(take)]
        t_mid = np.asarray([f.t_mid for f in frames], np.float32)
        times = buf.times
        n_s = times.shape[0]
        enforce_pose_span(times, t_mid, self.pose_extrapolation,
                          context="stalled frame mid-times")
        # only the slice of the pose history that brackets the released
        # (ascending) mid-times: the same intervals, so the same poses
        lo = int(np.clip(np.searchsorted(times, t_mid[0], side="right") - 1,
                         0, n_s - 2))
        hi = max(min(n_s, int(np.searchsorted(times, t_mid[-1], side="right")) + 1),
                 lo + 2)
        traj = buf.trajectory(lo, hi)
        traj = Trajectory(traj.times.to(self.device),
                          SE3(traj.poses.R.to(self.device), traj.poses.t.to(self.device)))
        return self._frames(np.stack([f.xy for f in frames]),
                            np.stack([f.valid for f in frames]), t_mid, traj)


def aggregate(cam: CameraModel, stream: EventStream, traj: Trajectory,
              events_per_frame: int = EVENTS_PER_FRAME,
              keep_tail: bool = True, *,
              pose_extrapolation: str = "warn", device=None) -> EventFrames:
    """Slice the (sorted) stream into frames of `events_per_frame`.

    One push through `StreamingAggregator` plus, with `keep_tail`, a flush
    of the trailing partial frame as a final padded frame.
    """
    agg = StreamingAggregator(cam, traj, events_per_frame,
                              pose_extrapolation=pose_extrapolation, device=device)
    full = agg.push(stream)
    if not keep_tail:
        return full
    tail = agg.flush()
    if full.xy.shape[0] == 0 and tail.xy.shape[0] == 0:
        return empty_event_frames(events_per_frame, agg.device)
    return concat_event_frames([full, tail])
