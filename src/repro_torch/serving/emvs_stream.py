"""Streaming EMVS engine, in PyTorch: segments vote while the trajectory
still arrives.

Counterpart of `repro.serving.emvs_stream`. The offline `run_emvs` needs
the whole aggregated sequence before it can plan and bucket key-frame
segments. This engine removes that barrier:

  * events arrive in chunks of any size; `StreamingAggregator` carries the
    partial-frame remainder and emits completed frames with interpolated
    poses;
  * `SegmentPlanner` applies the K criterion frame by frame and closes a
    segment the moment the translation threshold trips — the boundaries of
    offline `segment_keyframes`;
  * closed segments are padded into `run_emvs`'s multiple-of-four frame
    capacities, and the segment axis S to a small fixed set of sizes
    (`StreamConfig.segment_buckets`), so the dispatch shapes stay bounded
    at |segment_buckets| x |capacities| over an unbounded stream;
  * closed segments pass through a coalescing queue whose
    `StreamConfig.dispatch_policy` decides how it drains ("latency": every
    segment as its own sweep; "throughput": fill the largest S bucket;
    "adaptive", the default: dispatch at once while the in-flight queue is
    shallow, coalesce once the card falls behind);
  * at most `max_inflight` sweeps run ahead before the engine waits on the
    oldest (back-pressure); the host stages segment k+1 while segment k
    votes on the card, and frames behind the open segment are evicted from
    the host window once dispatched.

The engine is split into two layers:

  * `repro_torch.serving.stream_session.StreamSession` — everything ONE
    camera's stream owns: ingest hygiene, aggregator, pose watermark,
    planner, host frame store (with live/peak byte accounting and an
    optional byte budget), per-session stats and result stores;
  * `repro_torch.serving.sweep_dispatcher.SweepDispatcher` — everything N
    sessions share: the `(session, segment)`-tagged coalescing queue,
    dispatch policy + fairness, the in-flight slots and the sweep.

`EMVSStreamEngine` is the N=1 composition, `MultiStreamEngine` serves N
cameras over ONE dispatcher, so shape-compatible segments from different
sessions coalesce into one S bucket.

Poses arrive from a fully-known `Trajectory` oracle or, streamed, as
chunks via `push_poses`. In the streamed mode a completed frame whose
mid-time is not yet strictly below the pose-lag watermark stalls until
its bracketing pose chunk lands, so any interleaving of event and pose
chunks reproduces the offline result; `finalize_poses` declares the
tracker done and `flush` with poses still missing raises
`PoseStallError`.

Per-segment results are bit-identical to `run_emvs` on frames aggregated
on the host, on the integer/nearest datapaths, for every chunking,
dispatch policy, pose interleaving and session schedule
(tests/test_torch_streaming.py). The engines run on the card unless the
caller passes `device="cpu"`; each dispatch there runs the sweep kernel
B1 and the depth max/argmax kernel B2 on the kernel formulation.
`StreamConfig(sweep="sharded")` splits each dispatch's segment axis over
the ranks of a `torch.distributed` mesh (`mesh=`, default every rank of the
initialized default process group); every rank runs the same engine on the
same stream. The reference's `kernel_interpret` knob has no counterpart
(the tensor's device picks a kernel or its plain version).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import (
    EMVSOptions,
    EMVSResult,
    FAIRNESS_POLICIES,
    SegmentResult,
)
from repro_torch.events.aggregation import EVENTS_PER_FRAME
from repro_torch.events.simulator import EventStream, Trajectory
from repro_torch.events.stream_hygiene import (
    HYGIENE_POLICIES,
    HygieneConfig,
    StreamHygieneError,
)
from repro_torch.events.trajectory_stream import (
    POSE_EXTRAPOLATION_POLICIES,
    TrajectoryBuffer,
)
from repro_torch.serving.stream_session import (
    BUDGET_POLICIES,
    MemoryBudgetError,
    StreamSession,
    _FrameStore,
)
from repro_torch.serving.sweep_dispatcher import SweepDispatcher, _InFlight

__all__ = [
    "BUDGET_POLICIES",
    "DISPATCH_POLICIES",
    "EMVSStreamEngine",
    "HYGIENE_POLICIES",
    "HygieneConfig",
    "MemoryBudgetError",
    "MultiStreamEngine",
    "StreamConfig",
    "StreamHygieneError",
    "StreamSession",
    "SweepDispatcher",
    "iter_event_chunks",
]

# Dispatch policies for the closed-segment coalescing queue:
#   * "latency"    — every closed segment dispatches immediately as its own
#     sweep (smallest fitting S bucket). Lowest time-to-depth-map per
#     segment; the per-segment baseline the other policies are measured
#     against.
#   * "throughput" — closed segments coalesce until the head group fills
#     the largest S bucket (or can no longer grow: a different-capacity
#     segment queued behind it, or end of stream). Fewest dispatches and
#     the biggest batches — the offline sweep's schedule, reconstructed
#     online at the cost of first-depth latency.
#   * "adaptive"   — never waits while the in-flight queue is shallow:
#     whatever is queued dispatches at once (a lone closed segment goes
#     solo, exactly like "latency" on a quiet stream; a backlog that
#     piled up in one push coalesces into the largest fitting S bucket).
#     Once the device saturates it holds segments like "throughput",
#     coalescing them as soon as an in-flight slot frees. Burst-tolerant
#     without giving up the quiet-stream latency profile; the default.
DISPATCH_POLICIES = ("latency", "throughput", "adaptive")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Knobs of the streaming engine.

    Shape stability: `events_per_frame` and `segment_buckets` bound the
    number of distinct dispatch shapes over an unbounded stream. Scheduling: `dispatch_policy` picks how closed segments leave
    the coalescing queue ("latency" = one sweep per segment, lowest
    first-depth latency; "throughput" = fill the largest S bucket before
    dispatching, highest sustained segments/s; "adaptive" = never wait
    while the device keeps up — a lone closed segment dispatches solo, a
    queued backlog coalesces — and hold-to-coalesce once the in-flight
    queue saturates; pick it unless you need one extreme). With a cost
    model attached and `target_latency_s` set, "adaptive" schedules
    against a predicted drain-time deadline instead of queue depth.
    Back-pressure:
    `max_inflight` bounds device-side work in flight, and
    `max_stalled_frames` bounds the pose-stall queue — with a stalled
    tracker the event front would otherwise grow the stall queue (and the
    coalescing queue behind it) without limit; exceeding the bound raises
    `PoseStallError` after buffering the offending frames, so pushing the
    missing pose chunks recovers without losing events. Every policy
    produces bit-identical results on the nearest/integer datapaths —
    these knobs trade latency for throughput, never numerics.

    Ingest hygiene: `hygiene` guards every pushed event chunk against
    the adversarial stream modes production ingest sees (non-monotone
    timestamps, overlap/regression vs prior pushes, exact-duplicate
    chunks, out-of-bounds coordinates, hot-pixel storms — the
    event-vision survey's noise taxonomy). Pass a policy string —
    "raise" (default: typed `StreamHygieneError` subclasses naming the
    first offending index, the chunk rejected atomically), "drop" (warn
    + discard exactly the offenders, counted in
    `stats["hygiene"]`), "reorder" (bounded reorder buffer restoring
    sort order, bit-identical to a pre-sorted stream within the slack),
    or "off" (trust the feed) — or a full
    `repro_torch.events.stream_hygiene.HygieneConfig` to set the reorder
    slack, the per-pixel rate limit, or the duplicate-detection history.

    Memory budget: `frame_store_budget_bytes` caps each session's host
    frame-store `live_bytes` (None = uncapped). Admission happens
    BEFORE a frame enters the store, so the cap is never exceeded — not
    even transiently. When the next frame does not fit, `budget_policy`
    decides: "stall" (default) applies back-pressure like
    `max_stalled_frames` — the push blocks while the dispatcher makes
    room (harvest completed sweeps, dispatch this session's queued
    segments to raise its eviction floor, evict) and only raises
    `MemoryBudgetError` when the budget cannot hold even the open
    segment's working set (frames below the retention floor — queued
    dispatches and the planner's open segment — are NEVER evicted, the
    floor `SweepDispatcher._evict_all` enforces); "reject" never
    blocks — the push raises `MemoryBudgetError` once non-blocking
    room-making fails, with the frames buffered in an admission backlog
    FIRST (the `PoseStallError` recovery contract: nothing is lost,
    `poll()` retries admission as sweeps complete, `flush()` drains).
    The budget is per session; N sessions of a `MultiStreamEngine`
    each get the full value.

    Shared vs per-session: one `StreamConfig` (with the camera model,
    DSI config and `EMVSOptions`) is shared by every session of a
    `MultiStreamEngine` — that is what lets one sweep per (S bucket,
    capacity) shape serve all N cameras and lets their segments share
    device batches. Only the trajectory / pose source (and the
    event feed itself) is per-session, supplied to `add_session`.
    `fairness` only matters with N > 1 sessions: it picks how dispatch
    groups anchor on the shared tagged queue. "fifo" (default) keeps
    strict global arrival order — simplest to reason about, but one
    session's odd-capacity segment at the queue head delays everyone
    else's *anchors* (their shape-compatible segments still ride along
    as group members). "round_robin" rotates anchors over the sessions,
    bounding any session's wait to O(sessions) dispatches behind a
    chatty neighbor, at the cost of leaving global arrival order.
    Neither setting changes any session's numbers — per-session results
    stay bit-identical to a dedicated engine under both.
    """

    events_per_frame: int = EVENTS_PER_FRAME
    # Fixed segment-axis pad sizes (ascending). Groups larger than the top
    # bucket are split, so the dispatch-shape bound holds regardless of
    # how many segments a single push closes.
    segment_buckets: tuple[int, ...] = (1, 2, 4)
    # Double-buffer depth: sweeps allowed in flight before dispatch blocks
    # on the oldest. 2 = classic ping-pong (stage k+1 while k votes).
    # Doubles as the adaptive policy's depth threshold: a dispatch that
    # would exceed it switches the policy into coalescing mode.
    max_inflight: int = 2
    # How the closed-segment coalescing queue drains (DISPATCH_POLICIES).
    dispatch_policy: str = "adaptive"
    # Latency SLO for the adaptive policy, in seconds (None = off). With
    # a cost model attached to the engine/dispatcher, "adaptive" becomes
    # deadline-driven instead of depth-driven: it keeps coalescing while
    # the PREDICTED time to drain the queue (in-flight sweeps + the
    # planned partition of everything pending) still fits under this
    # deadline, and dispatches the moment the prediction exceeds it —
    # "dispatch now iff predicted queue-drain time exceeds the
    # deadline". Sealed groups (which can never grow) always dispatch.
    # Without a cost model, or when the model cannot predict the queue
    # (out-of-distribution variant), the policy falls back to the
    # depth-based rule, so schedules are bitwise-identical to the
    # SLO-free engine. Ignored by "latency"/"throughput".
    target_latency_s: float | None = None
    # How dispatch groups anchor on the shared multi-session queue
    # (repro_torch.core.pipeline.FAIRNESS_POLICIES): "fifo" = strict global
    # arrival order, "round_robin" = starvation-bounded rotation over
    # sessions. Irrelevant at N=1 (both reduce to the same schedule).
    fairness: str = "fifo"
    # Max-stall back-pressure bound (pose-gated mode): maximum frames the
    # aggregator may hold stalled past the pose watermark (unreleasable
    # by the poses received so far) before `push` raises `PoseStallError`
    # — frames are buffered first, so nothing is lost and pushing the
    # missing pose chunks recovers. None = unbounded (trusted tracker).
    max_stalled_frames: int | None = None
    # Segment-sweep backend: "batched" runs each dispatch as one bucket
    # sweep (`process_segments_batched`); "sharded" splits the segment
    # axis over the ranks of the engine's mesh
    # (`repro_torch.distributed.emvs.process_segments_sharded`), so
    # concurrent segments vote on different ranks. With "sharded" the
    # engine rounds every segment bucket up to a multiple of the mesh's
    # segment-axis size, keeping dispatch shapes shard-stable over an
    # unbounded stream.
    sweep: str = "batched"
    # Policy for frame mid-times outside the received trajectory span
    # (only reachable at the stream edges): "warn" clamps to the span
    # endpoint with PoseExtrapolationWarning, "raise" refuses with
    # PoseExtrapolationError, "clamp" is the seed's silent freeze (kept
    # for explicit opt-in only).
    pose_extrapolation: str = "warn"
    # Ingest-hygiene policy (HYGIENE_POLICIES) or a full HygieneConfig —
    # how adversarial event chunks are met (see the class docstring).
    hygiene: str | HygieneConfig = "raise"
    # Per-session cap on the host frame store's live_bytes (None =
    # uncapped); enforced BEFORE admission, so it is never exceeded.
    frame_store_budget_bytes: int | None = None
    # What a push does when the next frame does not fit under the budget
    # (BUDGET_POLICIES): "stall" = block while the dispatcher makes
    # room; "reject" = raise MemoryBudgetError with the frames buffered
    # first (recover via poll/flush).
    budget_policy: str = "stall"

    def __post_init__(self):
        if not self.segment_buckets:
            raise ValueError("segment_buckets must be non-empty")
        if list(self.segment_buckets) != sorted(set(self.segment_buckets)):
            raise ValueError(
                f"segment_buckets must be strictly ascending, got "
                f"{self.segment_buckets}")
        if self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.dispatch_policy not in DISPATCH_POLICIES:
            raise ValueError(
                f"unknown dispatch_policy {self.dispatch_policy!r}: "
                f"expected one of {DISPATCH_POLICIES}")
        if self.fairness not in FAIRNESS_POLICIES:
            raise ValueError(
                f"unknown fairness {self.fairness!r}: expected one of "
                f"{FAIRNESS_POLICIES}")
        if self.target_latency_s is not None and not self.target_latency_s > 0:
            raise ValueError(
                f"target_latency_s must be > 0 seconds (or None for no "
                f"SLO), got {self.target_latency_s}")
        if self.max_stalled_frames is not None and self.max_stalled_frames < 1:
            raise ValueError(
                f"max_stalled_frames must be >= 1 (or None for unbounded), "
                f"got {self.max_stalled_frames}")
        if self.sweep not in ("batched", "sharded"):
            raise ValueError(
                f"unknown sweep backend {self.sweep!r}: expected 'batched' "
                f"or 'sharded'")
        if self.pose_extrapolation not in POSE_EXTRAPOLATION_POLICIES:
            raise ValueError(
                f"unknown pose_extrapolation policy "
                f"{self.pose_extrapolation!r}: expected one of "
                f"{POSE_EXTRAPOLATION_POLICIES}")
        if isinstance(self.hygiene, str):
            if self.hygiene not in HYGIENE_POLICIES:
                raise ValueError(
                    f"unknown hygiene policy {self.hygiene!r}: expected "
                    f"one of {HYGIENE_POLICIES} or a HygieneConfig")
        elif not isinstance(self.hygiene, HygieneConfig):
            raise ValueError(
                f"hygiene must be a policy string ({HYGIENE_POLICIES}) or "
                f"a HygieneConfig, got {type(self.hygiene).__name__}")
        if (self.frame_store_budget_bytes is not None
                and self.frame_store_budget_bytes < 1):
            raise ValueError(
                f"frame_store_budget_bytes must be >= 1 (or None for "
                f"uncapped), got {self.frame_store_budget_bytes}")
        if self.budget_policy not in BUDGET_POLICIES:
            raise ValueError(
                f"unknown budget_policy {self.budget_policy!r}: expected "
                f"one of {BUDGET_POLICIES}")


def iter_event_chunks(stream: EventStream, chunk_events: int):
    """Split a stream into contiguous chunks of `chunk_events` events."""
    if isinstance(chunk_events, bool) or not isinstance(
            chunk_events, (int, np.integer)):
        raise ValueError(
            f"chunk_events must be an int, got "
            f"{type(chunk_events).__name__} ({chunk_events!r})")
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    n = stream.t.shape[0]
    for i in range(0, n, chunk_events):
        sl = slice(i, min(i + chunk_events, n))
        yield EventStream(xy=stream.xy[sl], t=stream.t[sl],
                          polarity=stream.polarity[sl], valid=stream.valid[sl])


class EMVSStreamEngine:
    """Online EMVS: push event chunks, harvest per-keyframe depth maps.

    One `StreamSession` composed over a private `SweepDispatcher` — the
    N=1 case of `MultiStreamEngine`, with the original single-stream API.

    Usage (pose oracle — offline replay with a fully-known trajectory):
        engine = EMVSStreamEngine(cam, dsi_cfg, traj, opts)
        for chunk in iter_event_chunks(stream, 4096):
            for seg in engine.push(chunk):   # results ready so far
                ...
        result = engine.flush()              # drain; same type as run_emvs

    Usage (streamed trajectory — poses arrive in chunks, like events):
        engine = EMVSStreamEngine(cam, dsi_cfg, None, opts)
        for ev_chunk, pose_chunk in tracker_feed():
            engine.push(ev_chunk)            # frames past the pose-lag
            engine.push_poses(pose_chunk)    # watermark stall until here
        engine.finalize_poses()              # tracker done
        result = engine.flush()
    """

    def __init__(self, cam: CameraModel, dsi_cfg: DSIConfig,
                 traj: Trajectory | TrajectoryBuffer | None,
                 opts: EMVSOptions = EMVSOptions(),
                 stream_cfg: StreamConfig = StreamConfig(), *,
                 mesh=None, cost_model=None, profiler=None, device=None):
        self.cam = cam
        self.dsi_cfg = dsi_cfg
        self.opts = opts
        self.stream_cfg = stream_cfg
        self._dispatcher = SweepDispatcher(cam, dsi_cfg, opts, stream_cfg,
                                           mesh=mesh, cost_model=cost_model,
                                           profiler=profiler, device=device)
        self._session = StreamSession("cam0", self._dispatcher, traj)

    # --- delegation to the session/dispatcher layers ----------------------

    @property
    def device(self):
        return self._dispatcher.device

    @property
    def mesh(self):
        return self._dispatcher.mesh

    @property
    def _segment_buckets(self) -> tuple[int, ...]:
        return self._dispatcher._segment_buckets

    @property
    def pose_gated(self) -> bool:
        return self._session.pose_gated

    @property
    def aggregator(self):
        return self._session.aggregator

    @property
    def planner(self):
        return self._session.planner

    @property
    def _store(self) -> _FrameStore:
        return self._session._store

    @property
    def _pending(self):
        return self._dispatcher._pending

    @property
    def _inflight(self):
        return self._dispatcher._inflight

    @property
    def _done(self):
        return self._session._done

    @property
    def stats(self) -> dict:
        """Merged per-session + dispatcher counters, the reference engine's
        keys ("cross_stream_dispatches" is always 0 at N=1)."""
        out = dict(self._session.stats)
        d = self._dispatcher.stats
        for key in ("dispatches", "padded_segments", "pending_segments",
                    "max_pending", "coalesced_dispatches",
                    "coalesced_segments", "cross_stream_dispatches",
                    "slo_dispatches", "slo_holds"):
            out[key] = d[key]
        # latency histograms are dicts: copy so callers can't mutate the
        # dispatcher's accumulators through the stats view
        out["queue_wait_s"] = dict(d["queue_wait_s"])
        out["sweep_time_s"] = dict(d["sweep_time_s"])
        return out

    def predict_drain_s(self) -> float | None:
        """Cost-model prediction of the time to drain everything queued
        and in flight, or None without a predicting cost model."""
        return self._dispatcher.predict_drain_s()

    # --- the single-stream API, unchanged ---------------------------------

    def push(self, chunk: EventStream) -> list[SegmentResult]:
        """Feed one event chunk; returns segment results that became ready
        (without blocking — completed sweeps only). In pose-gated mode,
        frames whose mid-time lies past the pose watermark stall inside
        the aggregator and surface on a later `push_poses`."""
        return self._session.push(chunk)

    def push_poses(self, chunk: Trajectory) -> list[SegmentResult]:
        """Feed one pose chunk from the tracker; stalled frames the
        advanced watermark now covers are released (bitwise-identically
        posed), planned, and dispatched."""
        return self._session.push_poses(chunk)

    def finalize_poses(self) -> list[SegmentResult]:
        """Declare the pose stream complete: every still-stalled frame is
        released through `StreamConfig.pose_extrapolation`."""
        return self._session.finalize_poses()

    def poll(self) -> list[SegmentResult]:
        """Results that became ready since the last poll: back-pressure
        harvests plus every in-flight sweep the device has finished."""
        return self._session.poll()

    def flush(self) -> EMVSResult:
        """End of stream: flush the partial frame and the open segment,
        drain all in-flight sweeps, and return the accumulated result
        (same ordering and types as offline `run_emvs`). See
        `StreamSession.flush` for the pose-gated error contract."""
        return self._session.flush()

    def result(self) -> EMVSResult:
        """Results harvested so far, in frame order (complete after flush)."""
        return self._session.result()

    # --- private shims over the dispatcher ---------------------------------

    def _dispatch(self, segs: list[tuple[int, int]], cap: int) -> None:
        assert segs, "_dispatch requires at least one closed segment"
        self._dispatcher._dispatch([(self._session, seg) for seg in segs],
                                   cap)

    def _dispatch_all(self, closed: list[tuple[int, int]]) -> None:
        if closed:
            self._dispatcher.enqueue(self._session, closed)
        self._dispatcher.pump()


class MultiStreamEngine:
    """N camera sessions multiplexed onto ONE shared sweep dispatcher.

    Why: a single event stream leaves the card idle whenever its camera
    goes quiet — single-stream dispatches under-fill the S buckets. With
    N sessions on one dispatcher, closed segments from different cameras
    coalesce into the same device batch whenever their frame capacities
    match (cross-stream coalescing), so concurrent trickle streams
    approach the batch efficiency of one dense stream: fewer dispatches,
    fuller buckets. Coalescing helps most when sessions are individually
    sparse but collectively busy; a single saturated stream gains
    nothing (it already fills its buckets) — use `EMVSStreamEngine`.

    Shared vs per-session: the camera model, DSI config, `EMVSOptions`
    and `StreamConfig` are fixed at construction and shared by every
    session — sharing them is what lets one sweep per (S bucket,
    capacity) shape serve all cameras. Per-session: the pose source
    (`add_session(traj=...)`: an oracle `Trajectory`, a pre-filled
    `TrajectoryBuffer`, or None for pose-gated streaming) and the event
    feed. Mixed rigs needing different camera models need separate
    engines — their sweeps could not share batches anyway.

    Fairness (`StreamConfig.fairness`): "fifo" anchors every dispatch
    group at the global arrival head — strict and predictable, but a
    chatty session can make a quiet one wait; "round_robin" rotates
    anchors over sessions, bounding any session's wait to O(sessions)
    dispatches. Neither changes results: every session's outputs are
    bit-identical to a dedicated `EMVSStreamEngine` on the
    integer/nearest datapaths, under every dispatch policy and session
    interleaving (tests/test_torch_streaming.py).

    Usage:
        engine = MultiStreamEngine(cam, dsi_cfg, opts, stream_cfg)
        left = engine.add_session("left", traj=traj_l)
        right = engine.add_session("right", traj=traj_r)
        for chunk_l, chunk_r in rig_feed():
            left.push(chunk_l)     # or engine.push("left", chunk_l)
            right.push(chunk_r)
        results = engine.flush()   # {"left": EMVSResult, "right": ...}

    Sessions are admitted up front or on the fly (`add_session` any time
    before that session's first push); each holds its own fixed slot in
    the dispatcher's fairness rotation, like the LM `serving/engine.py`'s
    fixed-slot admission. One session's `flush` drains only its own
    work — the rig keeps streaming.
    """

    def __init__(self, cam: CameraModel, dsi_cfg: DSIConfig,
                 opts: EMVSOptions = EMVSOptions(),
                 stream_cfg: StreamConfig = StreamConfig(), *,
                 mesh=None, cost_model=None, profiler=None, device=None):
        self.cam = cam
        self.dsi_cfg = dsi_cfg
        self.opts = opts
        self.stream_cfg = stream_cfg
        self.dispatcher = SweepDispatcher(cam, dsi_cfg, opts, stream_cfg,
                                          mesh=mesh, cost_model=cost_model,
                                          profiler=profiler, device=device)
        self._sessions: dict[str, StreamSession] = {}

    @property
    def device(self):
        return self.dispatcher.device

    @property
    def mesh(self):
        return self.dispatcher.mesh

    @property
    def sessions(self) -> dict[str, StreamSession]:
        """Admitted sessions by id (insertion = fairness rotation order)."""
        return dict(self._sessions)

    def add_session(self, session_id: str | None = None,
                    traj: Trajectory | TrajectoryBuffer | None = None
                    ) -> StreamSession:
        """Admit one camera stream; returns its `StreamSession` handle.

        `session_id` defaults to "cam<k>" in admission order. `traj` is
        the per-session pose source (None = pose-gated: feed via
        `push_poses`)."""
        if session_id is None:
            session_id = f"cam{len(self._sessions)}"
        if session_id in self._sessions:
            raise ValueError(
                f"duplicate session id {session_id!r}: already admitted "
                f"(have {sorted(self._sessions)})")
        session = StreamSession(session_id, self.dispatcher, traj)
        self._sessions[session_id] = session
        return session

    def session(self, session_id: str) -> StreamSession:
        try:
            return self._sessions[session_id]
        except KeyError:
            raise KeyError(
                f"unknown session {session_id!r}: admitted sessions are "
                f"{sorted(self._sessions)}") from None

    # id-addressed conveniences (the session handles carry the same API)

    def push(self, session_id: str, chunk: EventStream) -> list[SegmentResult]:
        return self.session(session_id).push(chunk)

    def push_poses(self, session_id: str,
                   chunk: Trajectory) -> list[SegmentResult]:
        return self.session(session_id).push_poses(chunk)

    def finalize_poses(self, session_id: str) -> list[SegmentResult]:
        return self.session(session_id).finalize_poses()

    def poll(self) -> dict[str, list[SegmentResult]]:
        """Pump the shared dispatcher once; returns each session's newly
        ready results keyed by session id (possibly empty lists)."""
        self.dispatcher.pump()
        return {sid: sess._take_fresh()
                for sid, sess in self._sessions.items()}

    def flush(self, session_id: str | None = None):
        """Flush one session (returns its `EMVSResult`) or, with no id,
        every admitted session in admission order (returns a dict keyed
        by session id). Flushing one session leaves the others
        streaming."""
        if session_id is not None:
            return self.session(session_id).flush()
        return {sid: sess.flush() for sid, sess in self._sessions.items()}

    def result(self, session_id: str) -> EMVSResult:
        return self.session(session_id).result()

    @property
    def stats(self) -> dict:
        """Dispatcher-level counters plus per-session counters:
        `{"dispatcher": {...}, "sessions": {sid: {...}}}`."""
        return {"dispatcher": dict(self.dispatcher.stats),
                "sessions": {sid: dict(sess.stats)
                             for sid, sess in self._sessions.items()}}
