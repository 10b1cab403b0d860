"""Per-camera session layer of the streaming EMVS engine, in PyTorch.

Counterpart of `repro.serving.stream_session`.

`StreamSession` owns everything that belongs to ONE event camera's
stream and nothing that is shared with its neighbors:

  * the `StreamingAggregator` (partial-frame remainder, pose-stall queue,
    pose-lag watermark) and its `TrajectoryBuffer` / `Trajectory` oracle;
  * the `SegmentPlanner` applying the K criterion frame-by-frame;
  * the `_FrameStore` host retention window (with live/peak byte
    accounting — the hook for per-session memory caps);
  * per-session stats and the harvested-result store.

Everything shared — the tagged coalescing queue, dispatch policy, the
in-flight slots and the sweep — lives in
`repro_torch.serving.sweep_dispatcher.SweepDispatcher`. A session hands
closed segments to its dispatcher tagged with itself and gets
`SegmentResult`s routed back into `_fresh` / `_done` when the card
finishes; `repro_torch.serving.emvs_stream.EMVSStreamEngine` is the N=1
composition of the two layers, `MultiStreamEngine` the N-camera one.

Everything a session holds lives on the host: chunks (numpy arrays or
tensors on any device) are copied to the host once per push, the
aggregator runs on the CPU (so frame poses are the ones a host-aggregated
offline run gives, bit for bit), and the frame store is numpy. Only the
padded batch of a dispatch crosses to the card.
"""
from __future__ import annotations

from collections import deque

import numpy as np
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import EMVSResult, SegmentPlanner, SegmentResult
from repro_torch.core.pointcloud import PointCloud
from repro_torch.device import to_host
from repro_torch.events.aggregation import EventFrames, StreamingAggregator
from repro_torch.events.simulator import EventStream, Trajectory
from repro_torch.events.stream_hygiene import HygieneConfig, StreamHygiene
from repro_torch.events.trajectory_stream import PoseStallError, TrajectoryBuffer

# How StreamConfig(frame_store_budget_bytes=...) responds when admitting
# the next aggregated frame would put _FrameStore.live_bytes over budget:
#   * "stall"  — back-pressure, like max_stalled_frames on the pose side:
#     the push blocks while the dispatcher makes room (dispatching this
#     session's queued segments raises its eviction floor; completed
#     sweeps are block-harvested to free dispatch slots). Only when no
#     progress is possible — the *open segment's* working set alone
#     exceeds the budget, and open-segment frames can never be evicted —
#     does the push raise `MemoryBudgetError` (a configuration error:
#     raise the budget or close segments sooner).
#   * "reject" — never block: the push raises `MemoryBudgetError` as soon
#     as non-blocking room-making (harvest-ready + evict + dispatch into
#     free slots) cannot fit the frame. The frames are buffered in the
#     admission backlog FIRST, so nothing is lost — a later `poll()`
#     retries admission quietly as results harvest, and `flush()` drains
#     everything (blocking is inherent to a drain).
BUDGET_POLICIES = ("stall", "reject")


class MemoryBudgetError(RuntimeError):
    """A session's frame-store byte budget cannot admit the next frame.

    Raised per `StreamConfig(budget_policy=...)` — see `BUDGET_POLICIES`.
    The offending frames are buffered in the session's admission backlog
    before the raise, so no events are lost: `poll()` retries admission
    non-blocking, `flush()` drains fully."""


def _host_rotations(frames: EventFrames):
    """The frames' rotations on the host, or one None a frame where the
    aggregator left them for the frame store to pose."""
    if frames.poses.R is None:
        return [None] * int(frames.xy.shape[0])
    return to_host(frames.poses.R)


def _events(field) -> int:
    """Leading length of a chunk field (numpy array, tensor or sequence)."""
    return int(field.shape[0] if hasattr(field, "shape") else np.asarray(field).shape[0])


# bytes of one frame's float32 (3, 3) rotation, counted while it is unposed
_R_BYTES = 9 * 4


class _FrameStore:
    """Host-side retention window of aggregated frames, globally indexed.

    Frames are appended as they are emitted and evicted once the planner's
    open segment has moved past them, so memory tracks the open-segment
    length, not the stream length. `live_bytes` / `peak_bytes` account the
    retained payload (event coords, validity, mid-times, poses) — the
    number a per-session memory cap would enforce against. Frames are
    host numpy (xy float32, valid bool, t_mid float32, R and t float32),
    so the bytes equal the reference store's frame for frame.

    With `rotations` (host mid-times -> (n, 3, 3) float32), a frame may
    arrive with its rotation None: `window` poses every such frame it
    covers in one call and keeps the result. Its bytes count the rotation
    from the start.
    """

    def __init__(self, rotations=None):
        self._rotations = rotations
        self.base = 0  # global index of the oldest retained frame
        self.live_bytes = 0
        self.peak_bytes = 0
        self._xy: deque[np.ndarray] = deque()
        self._valid: deque[np.ndarray] = deque()
        self._t_mid: deque[np.float32] = deque()
        self._R: deque[np.ndarray] = deque()
        self._t: deque[np.ndarray] = deque()

    @property
    def end(self) -> int:
        """One past the newest retained global frame index."""
        return self.base + len(self._xy)

    @staticmethod
    def _frame_bytes(xy: np.ndarray, valid: np.ndarray, t_mid: np.ndarray,
                     r: np.ndarray, t: np.ndarray) -> int:
        return (xy.nbytes + valid.nbytes + t_mid.nbytes
                + (_R_BYTES if r is None else r.nbytes) + t.nbytes)

    def append_frame(self, xy: np.ndarray, valid: np.ndarray,
                     t_mid: np.ndarray, r: np.ndarray,
                     t: np.ndarray) -> None:
        self._xy.append(xy)
        self._valid.append(valid)
        self._t_mid.append(t_mid)
        self._R.append(r)
        self._t.append(t)
        self.live_bytes += self._frame_bytes(xy, valid, t_mid, r, t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def extend(self, frames: EventFrames) -> None:
        xy = to_host(frames.xy)
        valid = to_host(frames.valid)
        t_mid = to_host(frames.t_mid)
        r = _host_rotations(frames)
        t = to_host(frames.poses.t)
        for k in range(xy.shape[0]):
            self.append_frame(xy[k], valid[k], t_mid[k], r[k], t[k])

    def window(self, lo: int, hi: int) -> EventFrames:
        """Host EventFrames covering global frames [lo, hi)."""
        if not self.base <= lo < hi <= self.end:
            raise IndexError(
                f"window [{lo}, {hi}) outside retained [{self.base}, {self.end})")
        sel = range(lo - self.base, hi - self.base)
        unposed = [k for k in sel if self._R[k] is None]
        if unposed:
            posed = self._rotations(np.asarray([self._t_mid[k] for k in unposed], np.float32))
            for k, r in zip(unposed, posed):
                self._R[k] = r
        return EventFrames(
            xy=np.stack([self._xy[k] for k in sel]),
            valid=np.stack([self._valid[k] for k in sel]),
            t_mid=np.asarray([self._t_mid[k] for k in sel], np.float32),
            poses=SE3(np.stack([self._R[k] for k in sel]),
                      np.stack([self._t[k] for k in sel])),
        )

    def evict_before(self, i: int) -> None:
        while self.base < i and self._xy:
            self.live_bytes -= self._frame_bytes(
                self._xy.popleft(), self._valid.popleft(),
                self._t_mid.popleft(), self._R.popleft(), self._t.popleft())
            self.base += 1


class StreamSession:
    """One camera's streaming state, multiplexed onto a shared dispatcher.

    Construct via `MultiStreamEngine.add_session` (or implicitly through
    the N=1 `EMVSStreamEngine`); the session registers itself with the
    dispatcher. The push/poll/flush lifecycle and error contract are the
    single-stream engine's, per session:

      * `push` / `push_poses` / `finalize_poses` feed this camera only;
        closed segments enter the dispatcher's shared tagged queue, where
        shape-compatible segments from OTHER sessions may share the same
        device sweep (cross-stream coalescing) — grouping never changes
        this session's numbers, so results stay bit-identical to a
        dedicated single-stream engine.
      * `poll` pumps the shared dispatcher (harvest + policy drain) and
        returns THIS session's newly ready results, in segment-close
        order.
      * `flush` drains this session only: its queued segments dispatch
        (same-capacity neighbors may ride along), its in-flight sweeps
        complete, other sessions keep streaming undisturbed.
    """

    def __init__(self, session_id: str,
                 dispatcher,
                 traj: Trajectory | TrajectoryBuffer | None = None):
        cfg = dispatcher.stream_cfg
        self.session_id = session_id
        self.dispatcher = dispatcher
        # traj=None: pose-gated mode with a fresh buffer the caller feeds
        # via push_poses; an existing TrajectoryBuffer (possibly pre-filled)
        # is used as-is; a Trajectory is the offline oracle.
        if traj is None:
            traj = TrajectoryBuffer()
        self.pose_gated = isinstance(traj, TrajectoryBuffer)
        if cfg.max_stalled_frames is not None and not self.pose_gated:
            raise ValueError(
                "max_stalled_frames is only meaningful in pose-gated mode "
                "(traj=None or a TrajectoryBuffer): a fully-known "
                "Trajectory oracle never stalls frames, so the bound "
                "would silently do nothing")
        # on the host whatever the dispatcher's device: poses interpolated
        # by the CPU's sin and cos, as a host-aggregated offline run has
        # them; the oracle's rotations wait for the frame store's windows,
        # one call a dispatch instead of one a frame
        self.aggregator = StreamingAggregator(
            dispatcher.cam, traj, cfg.events_per_frame,
            pose_extrapolation=cfg.pose_extrapolation,
            max_stalled=cfg.max_stalled_frames, device="cpu",
            defer_rotations=not self.pose_gated)
        mean_depth = 0.5 * (dispatcher.dsi_cfg.z_min + dispatcher.dsi_cfg.z_max)
        # min_frames=2 is plan_segments' parallax filter, applied online.
        self.planner = SegmentPlanner(
            mean_depth * dispatcher.opts.keyframe_dist_frac, min_frames=2)
        self._store = _FrameStore(
            None if self.pose_gated else self.aggregator.rotations)
        # Ingest hygiene: every event chunk is scrubbed against the
        # stream watermark before it reaches the aggregator (policy per
        # StreamConfig.hygiene; the camera model supplies the sensor
        # bounds for the out-of-bounds check).
        hyg = cfg.hygiene
        if not isinstance(hyg, HygieneConfig):
            hyg = HygieneConfig(policy=hyg)
        self.hygiene = StreamHygiene(hyg, width=dispatcher.cam.width,
                                     height=dispatcher.cam.height)
        # Memory budget: frames emitted by the aggregator pass through an
        # admission backlog before entering the frame store, so
        # live_bytes NEVER exceeds the budget (checked before append,
        # see _drain_backlog / BUDGET_POLICIES).
        self._budget = cfg.frame_store_budget_bytes
        self._budget_policy = cfg.budget_policy
        self._backlog: deque[tuple] = deque()  # per-frame (xy,valid,t_mid,R,t)
        self._fresh: list[SegmentResult] = []  # harvested, not yet polled
        self._done: dict[tuple[int, int], tuple[SegmentResult, PointCloud]] = {}
        self._flushed = False
        self._tail_flushed = False  # aggregator tail emitted (flush began)
        # Ingestion-side counters; the dispatcher owns the shared dispatch
        # counters and attributes "segments" (dispatched, owned by this
        # session) back here. Same identities as the single-stream engine.
        # "hygiene" aliases the guard's live stats dict; "budget_stalls" /
        # "budget_rejects" / "backlog_frames" track the admission policy.
        # "dsi_saturation_peak" is the largest per-segment fraction of DSI
        # voxels at the int16 store limits seen on this stream (inclusive
        # boundary — see core.dsi.store_saturation_fraction): the live
        # monitor for the paper's "16 bits never saturate" claim. Updated
        # by the dispatcher on harvest; stays 0.0 on healthy streams.
        self.stats = {"chunks": 0, "empty_chunks": 0, "frames": 0,
                      "segments": 0, "pose_chunks": 0, "stalled_frames": 0,
                      "max_stalled": 0,
                      "pose_watermark": self.aggregator.pose_watermark,
                      "frame_store_bytes": 0, "frame_store_peak_bytes": 0,
                      "budget_stalls": 0, "budget_rejects": 0,
                      "backlog_frames": 0, "dsi_saturation_peak": 0.0,
                      "hygiene": self.hygiene.stats}
        dispatcher.register(self)

    # --- ingest -----------------------------------------------------------

    @staticmethod
    def _validate_chunk(chunk: EventStream) -> int:
        """Reject inconsistently shaped chunks before they corrupt the
        aggregator's remainder; returns the event count."""
        n = _events(chunk.t)
        fields = {"xy": _events(chunk.xy), "polarity": _events(chunk.polarity),
                  "valid": _events(chunk.valid)}
        bad = {name: cnt for name, cnt in fields.items() if cnt != n}
        if bad:
            raise ValueError(
                f"inconsistent event chunk: t has {n} event(s) but "
                + ", ".join(f"{k} has {v}" for k, v in sorted(bad.items())))
        return n

    def push(self, chunk: EventStream) -> list[SegmentResult]:
        """Feed one event chunk; returns this session's segment results
        that became ready (without blocking — completed sweeps only). In
        pose-gated mode, frames whose mid-time lies past the pose
        watermark stall inside the aggregator and surface on a later
        `push_poses`.

        The chunk passes through this session's `StreamHygiene` guard
        first (`StreamConfig.hygiene`): an adversarial chunk raises a
        typed `StreamHygieneError` subclass / sheds offenders / waits in
        the reorder buffer per the policy, BEFORE any session state is
        touched — a hygiene raise leaves the session exactly as it was."""
        if self._flushed or self._tail_flushed:
            # once flush() has consumed the aggregator's tail remainder —
            # including a flush that then raised PoseStallError — more
            # events would land AFTER a padded mid-stream tail frame and
            # silently shift every later frame boundary
            raise RuntimeError(
                "push after flush: the event tail was already emitted "
                "(only push_poses / finalize_poses / flush may follow)")
        n = self._validate_chunk(chunk)
        chunk = self.hygiene.scrub(chunk)
        self.stats["chunks"] += 1
        if n == 0:
            # a legal no-op (e.g. a quiet sensor interval), but an easy
            # symptom of a broken feed — counted so callers can notice
            self.stats["empty_chunks"] += 1
        try:
            self._ingest(self.aggregator.push(chunk))
        finally:
            # runs on the PoseStallError (max-stall bound) path too, so
            # max_stalled records the true peak, not the last quiet push
            self._track_stall()
        return self.poll()

    def push_poses(self, chunk: Trajectory) -> list[SegmentResult]:
        """Feed one pose chunk from the tracker; stalled frames the
        advanced watermark now covers are released (bitwise-identically
        posed), planned, and dispatched. Returns results that became
        ready, exactly like `push`."""
        if self._flushed:
            raise RuntimeError("push_poses after flush: the engine is drained")
        if not self.pose_gated:
            raise RuntimeError(
                "push_poses requires a pose-gated engine: construct with "
                "traj=None (or a TrajectoryBuffer), not a Trajectory oracle")
        self.stats["pose_chunks"] += 1
        self._ingest(self.aggregator.push_poses(chunk))
        self._track_stall()
        return self.poll()

    def finalize_poses(self) -> list[SegmentResult]:
        """Declare the pose stream complete: every still-stalled frame is
        released through `StreamConfig.pose_extrapolation` (its pose can
        no longer gain a bracketing sample). Call before `flush` when the
        tracker ends behind the event front."""
        if self._flushed:
            raise RuntimeError(
                "finalize_poses after flush: the engine is drained")
        if not self.pose_gated:
            raise RuntimeError(
                "finalize_poses requires a pose-gated engine: construct "
                "with traj=None (or a TrajectoryBuffer)")
        self._ingest(self.aggregator.finalize_poses())
        self._track_stall()
        return self.poll()

    def _track_stall(self) -> None:
        n = self.aggregator.stalled_frames
        self.stats["stalled_frames"] = n
        self.stats["max_stalled"] = max(self.stats["max_stalled"], n)
        self.stats["pose_watermark"] = self.aggregator.pose_watermark

    def _sync_store_stats(self) -> None:
        self.stats["frame_store_bytes"] = self._store.live_bytes
        self.stats["frame_store_peak_bytes"] = self._store.peak_bytes

    def _ingest(self, frames: EventFrames, *,
                blocking: bool | None = None) -> None:
        n = int(frames.xy.shape[0])
        if n == 0:
            return
        self.stats["frames"] += n
        if self._budget is None:
            self._store.extend(frames)
            self._sync_store_stats()
            closed: list[tuple[int, int]] = []
            t_host = to_host(frames.poses.t)
            for k in range(n):
                seg = self.planner.push(t_host[k])
                if seg is not None:
                    closed.append(seg)
            if closed:
                self.dispatcher.enqueue(self, closed)
            self.dispatcher.pump()
            return
        # budgeted admission: frames queue in the backlog and enter the
        # store one at a time, each admitted only once it fits under the
        # budget — live_bytes can never exceed it
        xy = to_host(frames.xy)
        valid = to_host(frames.valid)
        t_mid = to_host(frames.t_mid)
        r = _host_rotations(frames)
        t = to_host(frames.poses.t)
        for k in range(n):
            self._backlog.append((xy[k], valid[k], t_mid[k], r[k], t[k]))
        if blocking is None:
            blocking = self._budget_policy == "stall"
        self._drain_backlog(blocking=blocking, raise_on_full=True)

    def _drain_backlog(self, *, blocking: bool, raise_on_full: bool) -> None:
        """Admit backlogged frames into the store under the byte budget.

        Each frame is admitted only when `live_bytes + frame` fits; when
        it does not, the dispatcher is asked to make room (harvest
        completed sweeps, evict behind the retention floor, dispatch this
        session's queued segments to RAISE that floor — never below it:
        queued segments and the planner's open segment stay resident).
        With `blocking` the room-making may block on in-flight sweeps
        (the "stall" policy's back-pressure); without it the first
        no-progress answer stops the drain — raising `MemoryBudgetError`
        when `raise_on_full` (the "reject" policy's push path) or
        returning quietly (poll's retry path). Admitted frames run the
        planner and enqueue their closed segments immediately, so a
        closed segment can free its own frames for the next admission."""
        budget = self._budget
        while self._backlog:
            fb = self._backlog[0]
            nbytes = _FrameStore._frame_bytes(*fb)
            while self._store.live_bytes + nbytes > budget:
                if self.dispatcher.make_room(self, blocking=blocking):
                    self.stats["budget_stalls"] += 1
                    continue
                self.stats["backlog_frames"] = len(self._backlog)
                if not raise_on_full:
                    return
                live = self._store.live_bytes
                if not blocking:
                    self.stats["budget_rejects"] += 1
                    raise MemoryBudgetError(
                        f"session {self.session_id!r}: admitting the next "
                        f"{nbytes}-byte frame would put the frame store at "
                        f"{live + nbytes} bytes, over the "
                        f"{budget}-byte budget (policy 'reject'; "
                        f"{len(self._backlog)} frame(s) held in the "
                        f"admission backlog — nothing is lost: poll() "
                        f"retries as sweeps complete, flush() drains)")
                raise MemoryBudgetError(
                    f"session {self.session_id!r}: frame-store budget "
                    f"{budget} bytes cannot hold the open segment's "
                    f"working set — {live} bytes are pinned by frames "
                    f"that may not be evicted (the planner's open "
                    f"segment / queued dispatches) and the next frame "
                    f"needs {nbytes} more, with nothing left to dispatch "
                    f"or harvest; raise the budget or close segments "
                    f"sooner (larger keyframe_dist_frac means longer "
                    f"segments)")
            self._backlog.popleft()
            self._store.append_frame(*fb)
            self._sync_store_stats()
            seg = self.planner.push(fb[4])
            if seg is not None:
                self.dispatcher.enqueue(self, [seg])
        self.stats["backlog_frames"] = 0
        self.dispatcher.pump()

    # --- harvest ----------------------------------------------------------

    def _take_fresh(self) -> list[SegmentResult]:
        out, self._fresh = self._fresh, []
        return out

    def poll(self) -> list[SegmentResult]:
        """This session's results that became ready since the last poll:
        back-pressure harvests plus every in-flight sweep the device has
        finished. Freed in-flight slots let the shared coalescing queue
        drain, so a poll can also dispatch segments (of any session) the
        adaptive policy was holding. Under a memory budget, frames a
        rejected push left in the admission backlog retry admission here
        (non-blocking, never raising) as completed sweeps free bytes."""
        if self._backlog:
            self._drain_backlog(blocking=False, raise_on_full=False)
        self.dispatcher.pump()
        return self._take_fresh()

    def flush(self) -> EMVSResult:
        """End of this session's stream: flush the partial frame and the
        open segment, drain this session's queued and in-flight work, and
        return its accumulated result (same ordering and types as offline
        `run_emvs`). Other sessions on the shared dispatcher keep
        streaming — though their same-capacity segments may ride along in
        this session's final dispatches.

        In pose-gated mode, flushing while frames still await their pose
        chunks raises `PoseStallError` (naming the stalled frame count
        and the watermark) — either push the missing chunks or call
        `finalize_poses` first. The session stays usable after the error
        for the pose side only: frames released by later pose chunks are
        not lost, but `push` is rejected from the first flush attempt on
        (the event tail was already emitted as a padded frame)."""
        if not self._flushed:
            try:
                if not self._tail_flushed:
                    self._tail_flushed = True
                    # end of stream for the hygiene guard too: the
                    # reorder buffer's held events precede the tail
                    held = self.hygiene.flush()
                    if held.t.shape[0]:
                        self._ingest(self.aggregator.push(held),
                                     blocking=True)
                    self._ingest(self.aggregator.flush(), blocking=True)
                if self._backlog:
                    # frames a rejected push left behind: a drain is
                    # inherently blocking under either budget policy
                    self._drain_backlog(blocking=True, raise_on_full=True)
            finally:
                # runs when the tail frame trips the max-stall bound too,
                # so max_stalled records the true peak on the raise path
                self._track_stall()
            stalled = self.aggregator.stalled_frames
            if stalled:
                raise PoseStallError(
                    f"flush with {stalled} frame(s) stalled awaiting poses: "
                    f"pose watermark t={self.aggregator.pose_watermark:.6g}, "
                    f"oldest stalled frame t_mid="
                    f"{self.aggregator.oldest_stalled_t:.6g}; push the "
                    f"missing pose chunks or call finalize_poses() first")
            tail = self.planner.flush()
            if tail is not None:
                self.dispatcher.enqueue(self, [tail])
            self._flushed = True
        # end of stream for this session: its share of the coalescing
        # queue drains fully under every policy
        self.dispatcher.drain_session(self)
        self._fresh.clear()  # flush reports everything via result()
        return self.result()

    def result(self) -> EMVSResult:
        """Results harvested so far, in frame order (complete after flush)."""
        keys = sorted(self._done)
        return EMVSResult(segments=[self._done[k][0] for k in keys],
                          clouds=[self._done[k][1] for k in keys])
