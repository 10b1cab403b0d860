"""Shared dispatch layer of the streaming EMVS engine, in PyTorch.

Counterpart of `repro.serving.sweep_dispatcher`. `SweepDispatcher` owns
everything N camera sessions share on one card: the
`(session, segment)`-tagged coalescing queue, the dispatch policy
(latency / throughput / adaptive, SLO-aware with a cost model) and
fairness anchor rule (fifo / round_robin), the in-flight slots with
back-pressure, the fixed S buckets and frame-capacity buckets that bound
the dispatch shapes, and the batched sweep.

Sessions (`repro_torch.serving.stream_session.StreamSession`) `enqueue`
their closed segments tagged with themselves; the dispatcher forms head
groups with `repro_torch.core.pipeline.dispatch_group_head_tagged`, so
`pad_segments`-compatible segments from DIFFERENT sessions fill one S
bucket — the cross-stream coalescing that keeps the device saturated
when any single stream goes quiet. Grouping never changes a segment's
numbers (rows are gathered per session store by `pad_segment_rows` and
the per-segment sweep body is independent), so every session's results
stay bit-identical to a dedicated single-stream engine, under any
interleaving, policy, and fairness setting. Harvested rows are routed
back to their owning session's result stores; one session's `flush`
drains only its share of the queue (same-capacity neighbors may ride
along — legal for the same independence reason).

On the card the work the reference leaves to JAX's asynchronous dispatch
is explicit. A dispatch gathers its rows on the host (`pad_segment_rows`),
copies them to the card from pinned memory without blocking (the pinned
tensors stay referenced from the `_InFlight` until harvest), enqueues the
sweep (B1 and B2 on the kernel formulation), the point clouds and each
row's DSI saturation (copied back into pinned memory), and records a
`torch.cuda.Event`. Nothing in it waits for the card, so the host stages
segment k+1 while segment k votes. All sweeps share PyTorch's current
stream: one sweep at the main bucket already fills the card. A sweep is
ready when its event has completed (`event.query()`); a blocking harvest
waits on the event (`event.synchronize()`). On the CPU there is no event,
and a sweep is ready when it returns.
"""
from __future__ import annotations

from collections import deque
from time import perf_counter
from typing import NamedTuple

import torch

from repro_torch.core import dsi as dsi_lib
from repro_torch.core.camera import CameraModel
from repro_torch.core.detection import DepthMap
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import (
    DispatchPlanner,
    EMVSOptions,
    SegmentBatch,
    SegmentResult,
    pad_segment_rows,
    process_segments_batched,
)
from repro_torch.core.pointcloud import PointCloud, depth_maps_to_points
from repro_torch.device import resolve_device
from repro_torch.profiling.cost_table import VariantKey

Tensor = torch.Tensor

# Latency histogram bin edges (seconds): log-decade bins wide enough to
# cover a sub-millisecond warm sweep and a multi-second cold start.
_HIST_EDGES_S = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class _LatencyHist:
    """Fixed-log-bin latency histogram over (t_in, t_out) sample pairs.

    Beyond the usual count/total/max, it keeps the raw timestamp sums so
    consumers can verify the reconciliation identity
    ``total_s == t_out_sum - t_in_sum`` — the sum of waits IS the sum of
    dispatch timestamps minus the sum of enqueue timestamps (resp.
    harvest minus dispatch for sweep times), so a histogram that lost or
    double-counted a sample cannot satisfy it.
    """

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        self.t_in_sum = 0.0
        self.t_out_sum = 0.0
        self.bins = [0] * (len(_HIST_EDGES_S) + 1)

    def observe(self, t_in: float, t_out: float) -> None:
        dt = t_out - t_in  # perf_counter is monotonic: never negative
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)
        self.t_in_sum += t_in
        self.t_out_sum += t_out
        i = 0
        while i < len(_HIST_EDGES_S) and dt >= _HIST_EDGES_S[i]:
            i += 1
        self.bins[i] += 1

    def snapshot(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "max_s": self.max_s, "t_in_sum": self.t_in_sum,
                "t_out_sum": self.t_out_sum,
                "bin_edges_s": list(_HIST_EDGES_S), "bins": list(self.bins)}


def enumerate_variant_space(stream_cfg, max_segment_frames: int, *,
                            formulation: str = "matmul") -> dict:
    """Statically enumerate the dispatcher's variant space.

    Every sweep the dispatcher can stage has its shapes determined by
    exactly two numbers: the padded S bucket and the frame capacity. This
    reproduces the dispatcher's bucket arithmetic (`bucket_capacity`
    padding) as a pure function of config: the |S buckets| x |capacities|
    bound on distinct dispatch shapes. Returns `{"s_buckets",
    "capacities", "variants", "backend"}` with `variants` the full
    (s_bucket, capacity) product and `backend` the cost-table backend axis
    value (`cost_table.backend_name`) the dispatcher keys them under —
    "batched+kernel" etc. for the non-default formulations.
    """
    from repro_torch.core.pipeline import bucket_capacity
    from repro_torch.profiling.cost_table import backend_name

    if max_segment_frames <= 0:
        raise ValueError("max_segment_frames must be positive")
    s_buckets = tuple(stream_cfg.segment_buckets)
    capacities = tuple(sorted({bucket_capacity(f)
                               for f in range(1, max_segment_frames + 1)}))
    variants = tuple((s, c) for s in s_buckets for c in capacities)
    return {"s_buckets": s_buckets, "capacities": capacities,
            "variants": variants,
            "backend": backend_name(stream_cfg.sweep, formulation)}


class _InFlight(NamedTuple):
    """One dispatched sweep: real segments + results still being computed.

    `owners[k]` is the session that owns `segs[k]` (rows of one sweep may
    belong to different sessions). `owners=None` routes every row to the
    dispatcher's default (first-registered) session on harvest. `done` is
    the CUDA event recorded after the sweep's last operation and `started`
    the one recorded before its first (both None on the CPU, where a sweep
    is complete when it returns); `staging` keeps the pinned host tensors
    the batch was copied from alive until harvest; `saturation` holds each
    row's DSI store-saturation fraction on the host, written by the
    sweep's last copy.
    """

    segs: list[tuple[int, int]]  # real (unpadded) segments, global indices
    ref_R: Tensor  # (S, 3, 3) including padded rows
    ref_t: Tensor  # (S, 3)
    dsis: Tensor
    dms: DepthMap
    pcs: PointCloud
    owners: tuple | None = None  # per-row owning sessions
    key: VariantKey | None = None  # variant identity of the sweep
    dispatched_t: float = 0.0  # host perf_counter at dispatch
    unshadowed: bool = False  # dispatched onto an otherwise idle device
    done: torch.cuda.Event | None = None
    started: torch.cuda.Event | None = None
    staging: SegmentBatch | None = None
    saturation: Tensor | None = None  # (S,) float32 on the host


def _ready(inf: _InFlight) -> bool:
    """Has the card finished this sweep? (Never waits.)"""
    return inf.done is None or inf.done.query()


def _stage(batch: SegmentBatch, device: torch.device
           ) -> tuple[SegmentBatch, SegmentBatch | None]:
    """`batch` (CPU tensors) on `device`, and the pinned host tensors it
    was copied from (None off the card). To a CUDA card each field goes
    from pinned memory by a non-blocking copy on the current stream, so
    the host does not wait for the sweep still running there; the pinned
    batch must stay referenced until the copies have run."""
    if device.type != "cuda":
        return SegmentBatch(*(t.to(device) for t in batch)), None
    pinned = SegmentBatch(*(t.pin_memory() for t in batch))
    return SegmentBatch(*(t.to(device, non_blocking=True) for t in pinned)), pinned


class SweepDispatcher:
    """Shared segment-sweep scheduler for N streaming sessions.

    `cam`, `dsi_cfg`, `opts` and `stream_cfg` are shared by every session
    on the dispatcher — one sweep per (S bucket, capacity) shape serves
    them all, which is exactly what makes cross-stream coalescing
    possible. Sweeps run on `device`: the card unless the caller passes
    "cpu" (`repro_torch.device.resolve_device`).
    """

    def __init__(self, cam: CameraModel, dsi_cfg: DSIConfig,
                 opts: EMVSOptions = EMVSOptions(),
                 stream_cfg=None, *, cost_model=None, profiler=None,
                 device=None):
        if stream_cfg is None:
            from repro_torch.serving.emvs_stream import StreamConfig

            stream_cfg = StreamConfig()
        self.device = resolve_device(device)
        self.cam = cam
        self.dsi_cfg = dsi_cfg
        self.opts = opts
        self.stream_cfg = stream_cfg
        self._segment_buckets = stream_cfg.segment_buckets
        # Cost-aware planning: the planner owns the partition rules;
        # `cost_model` (duck-typed: predict_sweep_s(key) -> float | None)
        # lets the SLO-aware adaptive policy predict queue-drain time,
        # `profiler` (a repro_torch.profiling.SweepProfiler) opts into
        # online cost-table recording + dispatch-trace capture. Both
        # default off — the scheduler is then identical to the
        # cost-model-free engine.
        self.cost_model = cost_model
        self.profiler = profiler
        self.planner = DispatchPlanner(
            self._segment_buckets, cost_model=cost_model,
            variant_of=self._variant_key)
        self._sessions: list = []  # registration = round-robin order
        self._rr_cursor = 0
        self.default_owner = None  # harvest target for untagged in-flight
        # tagged coalescing queue: (session, (start, end)) in arrival order
        self._pending: list = []
        self._inflight: deque[_InFlight] = deque()
        # Counter invariants (held to the reference engine's counters by
        # tests/test_torch_streaming.py): segments == sum of dispatched group sizes;
        # coalesced_segments counts segments that left in a group of >= 2,
        # so segments == coalesced_segments + (dispatches -
        # coalesced_dispatches); pending_segments is the live tagged-queue
        # depth (0 after all sessions flush), max_pending its high-water
        # mark; cross_stream_dispatches counts groups whose rows span more
        # than one session.
        # slo_dispatches / slo_holds count the SLO-aware adaptive
        # policy's decisions (0 unless target_latency_s + a cost model
        # are both active); queue_wait_s / sweep_time_s are _LatencyHist
        # snapshots (enqueue->dispatch per segment, dispatch->harvest
        # per sweep) refreshed on every observation.
        self._queue_wait_hist = _LatencyHist()
        self._sweep_time_hist = _LatencyHist()
        # device seconds per sweep from its CUDA events, on the card only
        # (not a stats key: those stay the reference's)
        self.device_time_s = _LatencyHist()
        self._session_wait_hists: dict[int, _LatencyHist] = {}
        self._enqueued_t: dict[tuple[int, tuple[int, int]], float] = {}
        self.stats = {"segments": 0, "dispatches": 0, "padded_segments": 0,
                      "pending_segments": 0, "max_pending": 0,
                      "coalesced_dispatches": 0, "coalesced_segments": 0,
                      "cross_stream_dispatches": 0,
                      "slo_dispatches": 0, "slo_holds": 0,
                      "queue_wait_s": self._queue_wait_hist.snapshot(),
                      "sweep_time_s": self._sweep_time_hist.snapshot()}

    def _variant_key(self, s_bucket: int, capacity: int) -> VariantKey:
        """The variant identity of a padded dispatch shape — the cost
        table's key axes (repro_torch.profiling.cost_table).

        The backend axis folds in the voting formulation
        (`backend_name`): "batched" is the default matmul sweep,
        "batched+kernel" the CUDA kernels B1 and B2, etc. — with very
        different costs, so the DispatchPlanner must price them
        separately."""
        from repro_torch.profiling.cost_table import backend_name

        return VariantKey(
            s_bucket=s_bucket, capacity=capacity,
            backend=backend_name(self.stream_cfg.sweep,
                                 self.opts.formulation),
            interpolation=self.opts.voting,
            quantized=self.opts.quantized)

    # --- session plumbing -------------------------------------------------

    def register(self, session) -> None:
        self._sessions.append(session)
        if self.default_owner is None:
            self.default_owner = session
        # per-session queue-wait histogram, mirrored into session stats
        hist = _LatencyHist()
        self._session_wait_hists[id(session)] = hist
        session.stats["queue_wait_s"] = hist.snapshot()

    def enqueue(self, session, closed: list[tuple[int, int]]) -> None:
        """Append one session's newly closed segments to the tagged queue
        (arrival order; they dispatch on the next pump/drain)."""
        t = perf_counter()
        for seg in closed:
            self._enqueued_t[(id(session), seg)] = t
            if self.profiler is not None:
                self.profiler.note_enqueue(t, session, seg)
        self._pending.extend((session, seg) for seg in closed)
        self._note_queue_depth()

    def _note_queue_depth(self) -> None:
        d = len(self._pending)
        self.stats["pending_segments"] = d
        self.stats["max_pending"] = max(self.stats["max_pending"], d)

    def _oldest_pending_start(self, session) -> int | None:
        # per-session FIFO holds in the tagged queue, so a session's first
        # occurrence is its oldest queued segment
        for sess, (start, _) in self._pending:
            if sess is session:
                return start
        return None

    def _evict_all(self) -> None:
        # each session's retention window must cover its segments still
        # waiting in the shared queue, not just its planner's open
        # segment: a queued group references frames the planner already
        # moved past
        for sess in self._sessions:
            floor = self._oldest_pending_start(sess)
            if floor is None:
                floor = sess.planner.open_start
            sess._store.evict_before(floor)
            sess._sync_store_stats()

    def make_room(self, session, blocking: bool) -> bool:
        """Free retained frame-store bytes for `session`'s budget admission.

        Returns True when progress was made (bytes freed, or queued work
        dispatched so the next eviction can free them), False when no
        more room can be made — without blocking when `blocking` is
        False, or at all when True (everything dispatchable is
        dispatched and the store already sits at its retention floor:
        the planner's open segment, which may never be evicted: frames a
        queued segment still needs must survive eviction).

        Order of escalation: harvest device-completed sweeps and evict
        behind the floor (free); then dispatch the session's queued
        segments — dispatch stages its rows immediately, so each
        dispatched group RAISES the session's eviction floor past its
        segments; when the in-flight queue is full, dispatching means
        block-harvesting the oldest sweep first, which only the "stall"
        policy (blocking=True) may do."""
        before = session._store.live_bytes
        self._harvest_ready()
        self._evict_all()
        if session._store.live_bytes < before:
            return True
        while True:
            if len(self._inflight) >= self.stream_cfg.max_inflight:
                self._harvest_ready()  # a sweep may have completed by now
            if len(self._inflight) >= self.stream_cfg.max_inflight:
                # dispatching now would hit _dispatch's blocking
                # back-pressure on the oldest in-flight sweep
                if not blocking:
                    return False
                self._harvest(self._inflight.popleft(), block=True)
            group = self._pop_group(final=True, only=session)
            if group is None:
                return False
            self._dispatch(*group)
            self._note_queue_depth()
            self._evict_all()
            if session._store.live_bytes < before:
                return True
            # dispatched but nothing freed yet (the floor is still
            # pinned by further queued segments): keep dispatching

    # --- dispatch (double-buffered, policy- and fairness-scheduled) -------

    def pump(self) -> None:
        """One scheduler turn: harvest device-completed sweeps (routing
        results to their owning sessions), drain the tagged queue per the
        dispatch policy and fairness anchor rule, harvest again, evict."""
        self._harvest_ready()
        self._drain(final=False)
        self._harvest_ready()
        self._evict_all()

    def drain_session(self, session) -> None:
        """End of one session's stream: dispatch every queued segment of
        `session` (same-capacity segments of other sessions ride along),
        then block until all sweeps carrying its rows have harvested.
        Other sessions' queued work stays put."""
        while True:
            group = self._pop_group(final=True, only=session)
            if group is None:
                break
            self._dispatch(*group)
            self._note_queue_depth()
        self._evict_all()
        while any(inf.owners is None or session in inf.owners
                  for inf in self._inflight):
            self._harvest(self._inflight.popleft(), block=True)

    def _drain(self, final: bool) -> None:
        """Dispatch groups while the policy allows. With `final` every
        policy drains the whole queue — back-pressure blocking in
        `_dispatch` paces the device."""
        while self._pending:
            if not final:
                # harvest completed sweeps first: results surface sooner
                # and the freed slots un-deepen the in-flight queue the
                # adaptive policy reads
                self._harvest_ready()
            group = self._pop_group(final)
            if group is None:
                break
            self._dispatch(*group)
            self._note_queue_depth()
        self._evict_all()

    def _anchor_candidates(self, only) -> list:
        """Sessions eligible to anchor the next group, in try order."""
        if only is not None:
            return [only]
        if self.stream_cfg.fairness == "fifo" or len(self._sessions) == 1:
            # strict arrival order: only the global queue head ever anchors
            return [self._pending[0][0]]
        # round_robin: rotate over registered sessions, skipping those
        # with nothing queued; trying each once per turn means a session
        # whose anchored group is policy-held (unsealed throughput group)
        # does not head-of-line block a neighbor with a dispatchable one
        present = {id(sess) for sess, _ in self._pending}
        n = len(self._sessions)
        return [self._sessions[(self._rr_cursor + k) % n] for k in range(n)
                if id(self._sessions[(self._rr_cursor + k) % n]) in present]

    def _pop_group(self, final: bool, only=None):
        """Pop the next dispatchable group off the tagged queue, or None
        when the policy says to keep coalescing. Anchors follow the
        fairness rule; each anchored group obeys per-stream FIFO, so a
        session's results release in its segment-close order under every
        policy and fairness setting."""
        if not self._pending:
            return None
        policy = self.stream_cfg.dispatch_policy
        # SLO mode: with a deadline AND a
        # cost model that can price the whole queue, the adaptive policy
        # schedules against predicted drain time instead of in-flight
        # depth — dispatch now iff draining everything (in-flight sweeps
        # + the planned partition of the pending queue) is predicted to
        # blow the deadline, else keep coalescing. `slo_urgent is None`
        # means SLO inactive (no deadline, null model, or an
        # out-of-distribution variant): fall back to the depth rule, so
        # the schedule is identical to the SLO-free engine.
        slo_urgent = None
        if policy == "adaptive" and not final:
            if self.stream_cfg.target_latency_s is not None:
                drain = self.predict_drain_s()
                if drain is not None:
                    slo_urgent = drain > self.stream_cfg.target_latency_s
            if (slo_urgent is None
                    and len(self._inflight) >= self.stream_cfg.max_inflight):
                return None  # device saturated: coalesce until a slot frees
        for sess in self._anchor_candidates(only):
            if only is not None and self._oldest_pending_start(sess) is None:
                return None  # the drained session has nothing queued
            anchor = next(i for i, (s, _) in enumerate(self._pending)
                          if s is sess)
            idx, cap, sealed = self.planner.head_tagged(
                self._pending, anchor=anchor)
            if policy == "latency":
                idx = idx[:1]  # one sweep per segment — the baseline
            elif policy == "throughput" and not (final or sealed):
                continue  # this anchor's group can still grow: try the next
            elif slo_urgent is not None and not (slo_urgent or sealed):
                # SLO slack and the group can still grow: hold it (a
                # sealed group gains nothing by waiting, so it goes)
                continue
            group = [self._pending[i] for i in idx]
            for i in reversed(idx):
                self._pending.pop(i)
            if self._sessions:
                # fairness bookkeeping: the dispatched session goes to the
                # back of the rotation
                try:
                    self._rr_cursor = ((self._sessions.index(sess) + 1)
                                       % len(self._sessions))
                except ValueError:
                    pass
            if slo_urgent:
                self.stats["slo_dispatches"] += 1
            return group, cap
        if slo_urgent is False:
            self.stats["slo_holds"] += 1
        return None

    def predict_drain_s(self) -> float | None:
        """Predicted serial time to complete every in-flight sweep and
        drain the whole pending queue under the cost model. In-flight
        sweeps count at full predicted cost (their progress is not
        observable without a device sync — the estimate is deliberately
        conservative). None when any component is unpredictable."""
        if self.cost_model is None:
            return None
        total = 0.0
        for inf in self._inflight:
            if inf.key is None:
                return None
            cost = self.cost_model.predict_sweep_s(inf.key)
            if cost is None:
                return None
            total += cost
        pending = self.planner.predict_drain_s(
            self._pending, fairness=self.stream_cfg.fairness)
        if pending is None:
            return None
        return total + pending

    def _s_bucket(self, n: int) -> int:
        for b in self._segment_buckets:
            if b >= n:
                return b
        raise AssertionError(f"group of {n} exceeds top segment bucket")

    def variant_space(self, max_segment_frames: int) -> dict:
        """The live dispatcher's variant space (see
        `enumerate_variant_space`)."""
        return enumerate_variant_space(self.stream_cfg, max_segment_frames,
                                       formulation=self.opts.formulation)

    def _dispatch(self, group, cap: int) -> None:
        """Stage and dispatch one tagged group without waiting for the
        card: gather each row from its owning session's frame store, pad
        the segment axis to the smallest fitting S bucket, copy the batch
        to the card, enqueue the sweep and record its event. Only the
        back-pressure at the end may wait, on the oldest sweep's event."""
        # groups are only formed from non-empty closed-segment runs, so an
        # empty dispatch is a planner/grouping bug, not a stream condition
        # — and pad_segment_rows would reject it anyway.
        assert group, "_dispatch requires at least one closed segment"
        s_pad = self._s_bucket(len(group))
        # padded rows repeat the last real segment: the sweep body is
        # per-segment independent, so they are pure discarded work
        padded = list(group) + [group[-1]] * (s_pad - len(group))
        rows = [(sess._store.window(start, end), (0, end - start))
                for sess, (start, end) in padded]
        batch, staging = _stage(pad_segment_rows(rows, cap), self.device)
        # the calls below return with the sweep enqueued, so the caller
        # stages the next batch while this one votes
        unshadowed = not self._inflight  # nothing older occupies the device
        t_disp = perf_counter()
        key = self._variant_key(s_pad, cap)
        for sess, seg in group:
            t_enq = self._enqueued_t.pop((id(sess), seg), None)
            if t_enq is not None:
                self._queue_wait_hist.observe(t_enq, t_disp)
                sess_hist = self._session_wait_hists.get(id(sess))
                if sess_hist is not None:
                    sess_hist.observe(t_enq, t_disp)
                    sess.stats["queue_wait_s"] = sess_hist.snapshot()
        self.stats["queue_wait_s"] = self._queue_wait_hist.snapshot()
        if self.profiler is not None:
            self.profiler.note_dispatch(t_disp, group, key)
        on_card = self.device.type == "cuda"
        started = done = None
        if on_card:
            started = torch.cuda.Event(enable_timing=True)
            started.record()
        dsis, dms = process_segments_batched(self.cam, self.dsi_cfg, batch,
                                             self.opts)
        pcs = depth_maps_to_points(self.cam, dms, SE3(batch.ref_R, batch.ref_t))
        # each row's fraction of DSI voxels at the int16 store limits, for
        # the owning session's "dsi_saturation_peak" monitor (the live
        # check of the paper's "16 bits never saturate"), read at harvest
        saturation = dsi_lib.store_saturation_fractions(dsis)
        if on_card:
            saturation = torch.empty(saturation.shape, dtype=saturation.dtype,
                                     pin_memory=True).copy_(saturation, non_blocking=True)
            done = torch.cuda.Event(enable_timing=True)
            done.record()
        self._inflight.append(_InFlight(
            [seg for _, seg in group], batch.ref_R, batch.ref_t, dsis, dms,
            pcs, owners=tuple(sess for sess, _ in group), key=key,
            dispatched_t=t_disp, unshadowed=unshadowed, done=done,
            started=started, staging=staging, saturation=saturation))
        self.stats["segments"] += len(group)
        self.stats["dispatches"] += 1
        self.stats["padded_segments"] += s_pad - len(group)
        if len(group) > 1:
            self.stats["coalesced_dispatches"] += 1
            self.stats["coalesced_segments"] += len(group)
        if len({id(sess) for sess, _ in group}) > 1:
            self.stats["cross_stream_dispatches"] += 1
        for sess, _ in group:
            sess.stats["segments"] += 1
        while len(self._inflight) > self.stream_cfg.max_inflight:
            # back-pressure: block on the oldest sweep; its results are
            # routed for the owning sessions' next poll
            self._harvest(self._inflight.popleft(), block=True)

    # --- harvest ----------------------------------------------------------

    def _harvest_ready(self) -> None:
        """Pop and harvest every device-completed sweep at the head of the
        in-flight queue (non-blocking, dispatch order)."""
        while self._inflight and _ready(self._inflight[0]):
            self._harvest(self._inflight.popleft(), block=False)

    def _harvest(self, inf: _InFlight, block: bool) -> None:
        if block and inf.done is not None:
            inf.done.synchronize()
        t_harv = perf_counter()
        if inf.started is not None:
            self.device_time_s.observe(0.0, inf.started.elapsed_time(inf.done) / 1e3)
        if inf.key is not None:
            self._sweep_time_hist.observe(inf.dispatched_t, t_harv)
            self.stats["sweep_time_s"] = self._sweep_time_hist.snapshot()
            if self.profiler is not None:
                self.profiler.note_harvest(
                    inf.key, inf.dispatched_t, t_harv,
                    unshadowed=inf.unshadowed)
        owners = inf.owners
        if owners is None:
            owners = (self.default_owner,) * len(inf.segs)
        saturation = inf.saturation.tolist()
        for k, ((start, end), sess) in enumerate(zip(inf.segs, owners)):
            sat = saturation[k]
            sess.stats["dsi_saturation_peak"] = max(
                sess.stats.get("dsi_saturation_peak", 0.0), sat)
            dm = DepthMap(inf.dms.depth[k], inf.dms.mask[k],
                          inf.dms.confidence[k])
            res = SegmentResult(dm, inf.dsis[k],
                                SE3(inf.ref_R[k], inf.ref_t[k]), (start, end))
            pc = PointCloud(inf.pcs.points[k], inf.pcs.weights[k],
                            inf.pcs.valid[k])
            sess._done[(start, end)] = (res, pc)
            sess._fresh.append(res)
