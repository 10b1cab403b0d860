"""Event aggregation (A): stream -> fixed-size event frames, in PyTorch.

Counterpart of `repro.events.aggregation` in its trajectory-oracle mode:
1024 events per frame (paper §4.3), one pose per frame interpolated at the
frame's median timestamp. `StreamingAggregator` carries the partial-frame
remainder across pushes on the host, so any chunking of a stream gives the
same frames; the offline `aggregate` is one push plus a flush. Emitted
frames are tensors on the aggregator's device. The pose-gated
`TrajectoryBuffer` mode and its stall bound are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.camera import CameraModel, undistort_events
from repro_torch.core.geometry import SE3
from repro_torch.device import resolve_device
from repro_torch.events.simulator import EventStream, Trajectory
from repro_torch.events.stream_hygiene import check_chunk_monotone
from repro_torch.events.trajectory_stream import (
    POSE_EXTRAPOLATION_POLICIES,
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


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class StreamingAggregator:
    """Incremental A stage: push raw event chunks, receive completed frames.

    Each `push` applies distortion correction to the chunk, prepends the
    remainder of the previous push, and emits every completed
    `events_per_frame`-sized frame with its interpolated pose; `flush`
    emits the tail as one frame padded with parked, invalid events. Frame
    mid-times outside the trajectory span follow `pose_extrapolation`
    ("warn" clamps with a warning, "raise" refuses, "clamp" is silent).
    """

    def __init__(self, cam: CameraModel, traj: Trajectory,
                 events_per_frame: int = EVENTS_PER_FRAME, *,
                 pose_extrapolation: str = "warn", device=None):
        if events_per_frame < 1:
            raise ValueError(f"events_per_frame must be >= 1, got {events_per_frame}")
        if pose_extrapolation not in POSE_EXTRAPOLATION_POLICIES:
            raise ValueError(
                f"unknown pose_extrapolation policy {pose_extrapolation!r}: "
                f"expected one of {POSE_EXTRAPOLATION_POLICIES}")
        self.device = resolve_device(device)
        self.cam = cam
        self.traj = Trajectory(
            times=torch.as_tensor(traj.times, device=self.device),
            poses=SE3(torch.as_tensor(traj.poses.R, device=self.device),
                      torch.as_tensor(traj.poses.t, device=self.device)))
        self.pose_extrapolation = pose_extrapolation
        self._traj_times_host = _host(traj.times, np.float32)
        self.events_per_frame = int(events_per_frame)
        self._rem_xy = np.zeros((0, 2), np.float32)
        self._rem_t = np.zeros((0,), np.float32)
        self._rem_valid = np.zeros((0,), bool)
        self._last_t = float("-inf")

    def push(self, chunk: EventStream) -> EventFrames:
        """Ingest a chunk (sorted, contiguous with prior pushes) of events;
        a regressing chunk raises (`NonMonotoneEventError` /
        `StreamOverlapError`)."""
        t_chunk = _host(chunk.t, np.float32)
        check_chunk_monotone(t_chunk, self._last_t,
                             context="StreamingAggregator.push")
        if t_chunk.shape[0]:
            self._last_t = float(t_chunk[-1])
        xy = chunk.xy
        if self.cam.has_distortion():
            xy = undistort_events(self.cam, torch.as_tensor(xy, device=self.device))
        xy = np.concatenate([self._rem_xy, _host(xy, np.float32)])
        t = np.concatenate([self._rem_t, t_chunk])
        valid = np.concatenate([self._rem_valid, _host(chunk.valid, bool)])
        e = self.events_per_frame
        n_frames = xy.shape[0] // e
        n_keep = n_frames * e
        self._rem_xy, self._rem_t, self._rem_valid = (
            xy[n_keep:], t[n_keep:], valid[n_keep:])
        return self._emit(xy[:n_keep], t[:n_keep], valid[:n_keep], n_frames)

    def flush(self) -> EventFrames:
        """Emit the buffered tail as one padded frame (empty if no tail)."""
        e = self.events_per_frame
        n_rem = self._rem_xy.shape[0]
        if n_rem == 0:
            return empty_event_frames(e, self.device)
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
            return empty_event_frames(e, self.device)
        if t_mid is None:
            t_mid = np.median(t.reshape(n_frames, e), axis=1)
        t_mid = np.asarray(t_mid, np.float32)
        enforce_pose_span(self._traj_times_host, t_mid,
                          self.pose_extrapolation, context="frame mid-times")
        t_mid_d = torch.from_numpy(t_mid).to(self.device)
        poses = pose_at_times(self.traj, t_mid_d)
        return EventFrames(
            xy=torch.from_numpy(xy.reshape(n_frames, e, 2)).to(self.device),
            valid=torch.from_numpy(valid.reshape(n_frames, e)).to(self.device),
            t_mid=t_mid_d,
            poses=poses,
        )


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
