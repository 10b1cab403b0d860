"""End-to-end EMVS pipeline, offline: A -> P -> R -> (K) -> D -> M, in PyTorch.

Counterpart of the offline part of `repro.core.pipeline`. Key-frame
segmentation depends only on the trajectory, so segment boundaries are
planned on the host. Segments are padded to multiple-of-four frame
capacities (`pad_segments`); each capacity bucket is swept in one call of
`sweep_segment_batch`, with the segment axis as a tensor batch dimension.
Padded frames repeat a real frame and vote with weight 0.

Three interchangeable voting formulations:
  * "kernel"  — the CUDA sweep kernel (vote + int16 store) and the depth
    max/argmax kernel, one launch each per bucket; on the CPU, their plain
    versions;
  * "scatter" — plain PyTorch scatter-add, frame by frame;
  * "matmul"  — plain PyTorch one-hot products, frame by frame.
All three agree bitwise on the nearest-voting datapaths (float and
quantized) and to float tolerance on bilinear.

The streaming engine (`repro_torch.serving.emvs_stream`) drives this
module online: `SegmentPlanner` applies the K criterion frame by frame,
and its coalescing dispatcher groups queued closed segments with
`dispatch_group_head[_tagged]` / `plan_dispatch_groups[_tagged]` under a
`FAIRNESS_POLICIES` anchor rule (`DispatchPlanner` adds cost-model
predictions), gathering each group's rows from per-session frame stores
with `pad_segment_rows`. Grouping never changes a segment's numbers.

`run_emvs(sweep="sharded")` splits each bucket's segment axis over the
ranks of a `torch.distributed` mesh (`repro_torch.distributed.emvs`). Not
ported: the static-analysis trace specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import dsi as dsi_lib
from repro_torch.core.backproject import FrameGeometry, frame_geometry
from repro_torch.core.camera import CameraModel
from repro_torch.core.detection import DepthMap, detect_and_filter, detect_and_filter_from
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3, PlaneSweepCoeffs, apply_homography, propagate_to_planes
from repro_torch.core.pointcloud import PointCloud, depth_map_to_points, depth_maps_to_points
from repro_torch.core.voting import vote_onehot_matmul, vote_scatter
from repro_torch.device import resolve_device, to_host
from repro_torch.events.aggregation import EventFrames
from repro_torch.kernels.backproject_vote.ops import backproject_vote_frames
from repro_torch.quant.policies import TABLE1, EMVSQuantPolicy

Tensor = torch.Tensor

# Smallest fixed segment capacity (frames per padded segment).
SEGMENT_BUCKET_MIN = 4

# Fairness policies for the TAGGED coalescing queue (multi-tenant serving):
#   * "fifo"        — every dispatch group anchors at the global queue head:
#     strict arrival order across streams;
#   * "round_robin" — group anchors rotate over the streams in first-seen
#     order, skipping streams with nothing queued, so a stream with queued
#     work is anchored again within at most (#streams) dispatches.
FAIRNESS_POLICIES = ("fifo", "round_robin")

FORMULATIONS = ("scatter", "matmul", "kernel")


@dataclasses.dataclass(frozen=True)
class EMVSOptions:
    voting: str = "nearest"  # nearest | bilinear       (paper: nearest)
    formulation: str = "matmul"  # scatter | matmul | kernel
    quantized: bool = False  # paper Table 1 hybrid quantization
    keyframe_dist_frac: float = 0.15  # threshold as fraction of mean scene depth
    detection_threshold_c: float = 6.0
    detection_min_votes: float = 3.0
    median_filter: bool = True
    policy: EMVSQuantPolicy = TABLE1


class SegmentResult(NamedTuple):
    depth_map: DepthMap
    dsi: Tensor
    T_w_ref: SE3
    frame_range: tuple[int, int]


class EMVSResult(NamedTuple):
    segments: list[SegmentResult]
    clouds: list[PointCloud]


class SegmentBatch(NamedTuple):
    """A bucket of key-frame segments padded to one frame capacity C.

    Padded frame slots repeat the segment's last real frame so their
    geometry stays finite; `frame_valid` zeroes their vote weight.

    `valid` and `frame_valid` are bool masks when every weight is 1 or 0
    (`pad_segments`, `process_segment`, and `interop.segment_batch_from_numpy`
    for 1/0 inputs). Float32 weights are voted as given by the scatter and
    matmul formulations, as the reference votes them; the kernel
    formulation counts each valid event as 1 and refuses them.
    """

    xy: Tensor  # (S, C, E, 2) rectified event coords
    valid: Tensor  # (S, C, E) bool mask, or float32 vote weights
    frame_valid: Tensor  # (S, C) bool: real frames True, padding False (or float32 1/0)
    poses_R: Tensor  # (S, C, 3, 3)
    poses_t: Tensor  # (S, C, 3)
    ref_R: Tensor  # (S, 3, 3) reference (key-frame) pose per segment
    ref_t: Tensor  # (S, 3)


# ---------------------------------------------------------------------------
# Key-frame segmentation (host-side, pose-only)
# ---------------------------------------------------------------------------


class SegmentPlanner:
    """Incremental key-frame segmentation: the K criterion, frame by frame.

    `push` one frame translation at a time; a segment closes the moment the
    translation from the reference view exceeds the threshold. `flush`
    closes the trailing segment. Segments shorter than `min_frames` are
    discarded on close.
    """

    def __init__(self, threshold: float, min_frames: int = 1):
        self.threshold = float(threshold)
        self.min_frames = int(min_frames)
        self._count = 0
        self._start = 0
        self._ref: np.ndarray | None = None

    @property
    def num_frames(self) -> int:
        """Frames pushed so far."""
        return self._count

    @property
    def open_start(self) -> int:
        """First frame index of the still-open segment (frames before it
        can be released by a streaming caller once dispatched)."""
        return self._start

    def _filtered(self, seg: tuple[int, int]) -> tuple[int, int] | None:
        return seg if seg[1] - seg[0] >= self.min_frames else None

    def push(self, t: np.ndarray) -> tuple[int, int] | None:
        """Feed the next frame's translation; returns a closed segment
        [start, end) the moment the K criterion trips, else None."""
        t = np.asarray(t)
        i = self._count
        self._count = i + 1
        if self._ref is None:
            self._ref = t
            return None
        if np.linalg.norm(t - self._ref) > self.threshold:
            closed = (self._start, i)
            self._start = i
            self._ref = t
            return self._filtered(closed)
        return None

    def flush(self) -> tuple[int, int] | None:
        """End of stream: close (and return) the trailing open segment."""
        if self._count == self._start:
            return None
        seg = (self._start, self._count)
        self._start = self._count
        self._ref = None
        return self._filtered(seg)


def segment_keyframes(poses: SE3, mean_depth: float, frac: float) -> list[tuple[int, int]]:
    """Split frame indices into key-frame segments [(start, end), ...): a new
    segment begins when translation from the reference exceeds
    frac * mean_depth (the paper's K criterion)."""
    t = torch.as_tensor(poses.t).detach().cpu().numpy()
    planner = SegmentPlanner(mean_depth * frac, min_frames=1)
    bounds: list[tuple[int, int]] = []
    for i in range(t.shape[0]):
        closed = planner.push(t[i])
        if closed is not None:
            bounds.append(closed)
    tail = planner.flush()
    if tail is not None:
        bounds.append(tail)
    return bounds


def plan_segments(frames: EventFrames, dsi_cfg: DSIConfig,
                  opts: EMVSOptions) -> list[tuple[int, int]]:
    """Key-frame segments that carry enough parallax for a meaningful DSI."""
    mean_depth = 0.5 * (dsi_cfg.z_min + dsi_cfg.z_max)
    segs = segment_keyframes(frames.poses, mean_depth, opts.keyframe_dist_frac)
    return [(a, b) for a, b in segs if b - a >= 2]


def bucket_capacity(num_frames: int, minimum: int = SEGMENT_BUCKET_MIN) -> int:
    """Fixed per-bucket frame capacity: next multiple of `minimum`."""
    if num_frames < 1:
        raise ValueError(f"segment must have at least one frame, got {num_frames}")
    return max(minimum, -(-num_frames // minimum) * minimum)


def dispatch_group_head(segs: Sequence[tuple[int, int]], max_group: int,
                        minimum: int = SEGMENT_BUCKET_MIN
                        ) -> tuple[int, int, bool]:
    """Head group of a FIFO queue of closed segments: `(n, capacity, sealed)`.

    The head group is the longest prefix of `segs` whose members share one
    `bucket_capacity`, capped at `max_group` segments (the largest S
    bucket a dispatch may carry). `sealed` means the group can never grow:
    either it already holds `max_group` segments, or the next queued
    segment needs a different frame capacity — a throughput-oriented
    coalescer may keep an unsealed group waiting for more segments, but a
    sealed one gains nothing by waiting.

    One SegmentBatch carries a single frame capacity, and a single
    stream's results must release in segment-close (FIFO) order, so only
    the head of the queue is ever eligible — a group never skips past a
    different-capacity segment queued ahead of it. (Implemented as the
    single-tag case of `dispatch_group_head_tagged`, where the group is
    always a queue prefix.)
    """
    indices, cap, sealed = dispatch_group_head_tagged(
        [(None, seg) for seg in segs], max_group, minimum)
    return len(indices), cap, sealed


def dispatch_group_head_tagged(queue: Sequence[tuple[Any, tuple[int, int]]],
                               max_group: int,
                               minimum: int = SEGMENT_BUCKET_MIN, *,
                               anchor: int = 0
                               ) -> tuple[list[int], int, bool]:
    """Head group of a TAGGED coalescing queue: `(indices, capacity, sealed)`.

    `queue` holds `(tag, (start, end))` work items in arrival order — the
    tag names the stream/session that closed the segment, so one queue can
    multiplex N cameras onto shared device sweeps. The group is anchored
    at `queue[anchor]` (which must be its own tag's oldest queued segment)
    and collects up to `max_group` members of the anchor's
    `bucket_capacity` by walking the queue forward under the per-stream
    FIFO rule: skipping an item blocks every later item of the same tag.
    A stream's results therefore always release in its own close order,
    while OTHER streams' shape-compatible segments may overtake a blocked
    neighbor and fill the S bucket — the cross-stream coalescing the
    multi-tenant engine is built on.

    Returns queue indices (ascending, starting at `anchor`), the shared
    frame capacity, and `sealed` with its `dispatch_group_head` meaning:
    the group can never grow (it is full, or some queued segment was left
    behind). With one tag and `anchor=0` this reduces exactly to the
    untagged head group.
    """
    if not queue:
        raise ValueError("dispatch_group_head needs a non-empty queue")
    if max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    if not 0 <= anchor < len(queue):
        raise ValueError(
            f"anchor {anchor} outside queue of {len(queue)} item(s)")
    tag0, (s0, e0) = queue[anchor]
    blocked = set()
    for j in range(anchor):
        tag, _ = queue[j]
        if tag == tag0:
            raise ValueError(
                "anchor must be its tag's oldest queued segment: anchoring "
                f"at index {anchor} would overtake an earlier segment of "
                "the same stream (per-stream FIFO)")
        blocked.add(tag)
    cap = bucket_capacity(e0 - s0, minimum)
    indices = [anchor]
    for i in range(anchor + 1, len(queue)):
        if len(indices) == max_group:
            break
        tag, (s, e) = queue[i]
        if tag in blocked or bucket_capacity(e - s, minimum) != cap:
            blocked.add(tag)
            continue
        indices.append(i)
    sealed = len(indices) == max_group or len(indices) < len(queue)
    return indices, cap, sealed


class DispatchPlanner:
    """Dispatch-group planning, optionally cost-aware.

    The partition rules are the streaming coalescer's, unchanged: head
    groups via `dispatch_group_head_tagged`, fairness anchoring via
    `FAIRNESS_POLICIES`. What the class adds over the module-level
    functions (which now delegate here) is *prediction*: given a
    duck-typed cost model — anything with
    ``predict_sweep_s(key) -> float | None`` — and a ``variant_of``
    factory mapping a padded ``(s_bucket, capacity)`` dispatch shape to
    the model's key type, the planner predicts what a group costs and
    how long draining a queue would take. That is the signal the
    SLO-aware adaptive policy (`StreamConfig(target_latency_s=)`) and
    the reference's deterministic replayer (`repro.serving.dispatch_replay`)
    schedule against.

    A cost model NEVER changes which groups form — only when a
    scheduler chooses to dispatch them. With ``cost_model=None`` (or
    one that predicts ``None``) every prediction is ``None`` and
    consumers fall back to the pre-cost-model heuristics, which is how
    the "latency"/"throughput" policies and the null-model adaptive
    policy keep bitwise-identical schedules
    (tests/test_torch_dispatch.py holds the partitions to the
    reference's). The reference's docs/dispatch_planning.md has the full
    decision table.

    `s_buckets` are the fixed segment-axis pad sizes (ascending; the
    last is the planning `max_group`): predictions must account for the
    PADDED rows a dispatch sweeps, not just the real ones, or the model
    would reward under-filled buckets.
    """

    def __init__(self, s_buckets: Sequence[int],
                 minimum: int = SEGMENT_BUCKET_MIN, *,
                 cost_model=None, variant_of=None):
        s_buckets = tuple(s_buckets)
        if not s_buckets:
            raise ValueError("s_buckets must be non-empty")
        if list(s_buckets) != sorted(set(s_buckets)) or s_buckets[0] < 1:
            raise ValueError(
                f"s_buckets must be strictly ascending positive ints, got "
                f"{s_buckets}")
        self.s_buckets = s_buckets
        self.max_group = s_buckets[-1]
        self.minimum = minimum
        self.cost_model = cost_model
        self.variant_of = variant_of

    # --- partitioning (the streaming coalescer's rules) -------------------

    def head(self, segs: Sequence[tuple[int, int]]) -> tuple[int, int, bool]:
        return dispatch_group_head(segs, self.max_group, self.minimum)

    def head_tagged(self, queue: Sequence[tuple[Any, tuple[int, int]]], *,
                    anchor: int = 0) -> tuple[list[int], int, bool]:
        return dispatch_group_head_tagged(queue, self.max_group,
                                          self.minimum, anchor=anchor)

    def plan(self, segs: Sequence[tuple[int, int]]
             ) -> list[tuple[list[tuple[int, int]], int]]:
        groups: list[tuple[list[tuple[int, int]], int]] = []
        i = 0
        while i < len(segs):
            n, cap, _ = self.head(segs[i:])
            groups.append((list(segs[i:i + n]), cap))
            i += n
        return groups

    def plan_tagged(self, items: Sequence[tuple[Any, tuple[int, int]]], *,
                    fairness: str = "fifo"
                    ) -> list[tuple[list[tuple[Any, tuple[int, int]]], int]]:
        if fairness not in FAIRNESS_POLICIES:
            raise ValueError(f"unknown fairness {fairness!r}: expected one "
                             f"of {FAIRNESS_POLICIES}")
        queue = list(items)
        order: list[Any] = []
        for tag, _ in queue:
            if tag not in order:
                order.append(tag)
        cursor = 0
        groups: list[tuple[list[tuple[Any, tuple[int, int]]], int]] = []
        while queue:
            anchor = 0
            if fairness == "round_robin" and len(order) > 1:
                present = {tag for tag, _ in queue}
                for k in range(len(order)):
                    tag = order[(cursor + k) % len(order)]
                    if tag in present:
                        cursor = (cursor + k + 1) % len(order)
                        anchor = next(i for i, (t, _) in enumerate(queue)
                                      if t == tag)
                        break
            idx, cap, _ = self.head_tagged(queue, anchor=anchor)
            groups.append(([queue[i] for i in idx], cap))
            for i in reversed(idx):
                queue.pop(i)
        return groups

    # --- prediction -------------------------------------------------------

    def s_bucket(self, n: int) -> int:
        """Smallest fixed S bucket a group of `n` segments pads to."""
        for b in self.s_buckets:
            if b >= n:
                return b
        raise ValueError(f"group of {n} exceeds top segment bucket "
                         f"{self.s_buckets[-1]}")

    def predict_group_s(self, n_segments: int, capacity: int) -> float | None:
        """Predicted wall time of one dispatched group, or None when the
        model (or the variant factory) has nothing to say."""
        if self.cost_model is None or self.variant_of is None:
            return None
        key = self.variant_of(self.s_bucket(n_segments), capacity)
        return self.cost_model.predict_sweep_s(key)

    def predict_drain_s(self, items: Sequence[tuple[Any, tuple[int, int]]],
                        *, fairness: str = "fifo") -> float | None:
        """Predicted serial time to sweep an entire tagged queue, planned
        exactly as a full drain would partition it. None unless EVERY
        group gets a prediction — a partially predictable drain is not a
        deadline anyone should schedule against."""
        total = 0.0
        for group, cap in self.plan_tagged(items, fairness=fairness):
            cost = self.predict_group_s(len(group), cap)
            if cost is None:
                return None
            total += cost
        return total


def plan_dispatch_groups(segs: Sequence[tuple[int, int]], max_group: int,
                         minimum: int = SEGMENT_BUCKET_MIN
                         ) -> list[tuple[list[tuple[int, int]], int]]:
    """Partition a FIFO list of closed segments into dispatch groups.

    Repeated `dispatch_group_head`, so the partition is exactly what a
    streaming coalescer draining the whole queue would dispatch: each
    group is `(segments, frame_capacity)`, groups concatenate back to
    `segs` in order (nothing dropped, duplicated, or reordered), every
    group holds 1..max_group segments of one shared capacity. This is
    the bucket planning `run_emvs`'s capacity map performs offline,
    restated under the streaming FIFO-release constraint — the
    coalescing-planner property test pins these invariants for any
    segment sequence. (Delegates to a cost-model-free `DispatchPlanner`;
    the partition is identical by construction.)
    """
    return DispatchPlanner(_planner_buckets(max_group), minimum).plan(segs)


def _planner_buckets(max_group: int) -> tuple[int, ...]:
    # module-level planners know only the cap, not the full bucket set —
    # partitioning needs nothing else (prediction, which does, goes
    # through a DispatchPlanner constructed with the real buckets)
    if max_group < 1:
        raise ValueError(f"max_group must be >= 1, got {max_group}")
    return (max_group,)


def plan_dispatch_groups_tagged(
    items: Sequence[tuple[Any, tuple[int, int]]], max_group: int,
    minimum: int = SEGMENT_BUCKET_MIN, *, fairness: str = "fifo"
) -> list[tuple[list[tuple[Any, tuple[int, int]]], int]]:
    """Partition a TAGGED arrival order into dispatch groups.

    Repeated `dispatch_group_head_tagged` over a draining queue — exactly
    what the multi-tenant `SweepDispatcher` dispatches when it drains N
    sessions' closed segments, restated as a pure function for the
    property tests. Each group is `(tagged_segments, frame_capacity)`.
    (Delegates to a cost-model-free `DispatchPlanner`; the partition is
    identical by construction.)

    `fairness` picks how successive groups anchor (FAIRNESS_POLICIES):

      * "fifo" — every group anchors at the current queue head: strict
        global arrival order. A stream whose head-of-queue segment needs
        an odd frame capacity delays the anchors of everyone behind it
        (their shape-compatible segments still ride along as group
        members).
      * "round_robin" — anchors rotate over the tags in first-appearance
        order, skipping tags with nothing queued: a tag with queued work
        is anchored again after at most (#distinct tags) groups, so no
        stream waits more than O(streams) dispatches behind a chatty
        neighbor — at the cost of leaving the global arrival order.

    Invariants under BOTH policies (property-tested in
    the reference's tests/test_multi_stream.py): per tag, its segments appear in arrival
    order across the groups (per-stream FIFO); nothing is dropped,
    duplicated, or cross-tagged; every group holds 1..max_group segments
    sharing one `bucket_capacity`. With a single tag both policies
    reduce to `plan_dispatch_groups`.
    """
    return DispatchPlanner(_planner_buckets(max_group),
                           minimum).plan_tagged(items, fairness=fairness)


def _weights(valid: Tensor) -> Tensor:
    """Event validity as `SegmentBatch` carries it: a bool mask stays one,
    any other dtype becomes float32 weights."""
    return valid if valid.dtype == torch.bool else valid.to(torch.float32)


def pad_segments(frames: EventFrames, segs: Sequence[tuple[int, int]],
                 capacity: int) -> SegmentBatch:
    """Gather same-bucket segments into one padded SegmentBatch, on the
    frames' device. Bool event masks stay bool; `frame_valid` is bool."""
    if not segs:
        raise ValueError(
            "pad_segments needs at least one segment: an empty segment "
            "list has no reference pose and nothing to sweep")
    idx_rows, fv_rows = [], []
    for start, end in segs:
        n = end - start
        if not 0 < n <= capacity:
            raise ValueError(f"segment {(start, end)} does not fit capacity {capacity}")
        idx_rows.append(np.minimum(np.arange(start, start + capacity), end - 1))
        fv_rows.append(np.arange(capacity) < n)
    dev = frames.xy.device
    idx = torch.from_numpy(np.stack(idx_rows)).to(dev)  # (S, C) clamped frame indices
    ref = torch.tensor([s for s, _ in segs], dtype=torch.int64, device=dev)
    return SegmentBatch(
        xy=frames.xy[idx],
        valid=_weights(frames.valid[idx]),
        frame_valid=torch.from_numpy(np.stack(fv_rows)).to(dev),
        poses_R=frames.poses.R[idx],
        poses_t=frames.poses.t[idx],
        ref_R=frames.poses.R[ref],
        ref_t=frames.poses.t[ref],
    )


def pad_segment_rows(rows: Sequence[tuple[EventFrames, tuple[int, int]]],
                     capacity: int) -> SegmentBatch:
    """`pad_segments` for segments that each bring their own frame window.

    The multi-tenant dispatcher coalesces shape-compatible segments from
    DIFFERENT sessions into one S bucket; their frames live in different
    per-session stores, so the batch is gathered row by row: `rows[k]` is
    `(frames_k, (start_k, end_k))` with indices relative to `frames_k`.
    Each row's gather is the same clamp-at-end indexing as `pad_segments`,
    so row k is bitwise what `pad_segments(frames_k, [seg_k], capacity)`
    gives, bool masks included.

    The gather runs on the host (numpy): the frames may be host arrays or
    tensors, and the batch comes back as CPU tensors, for the caller to
    stage onto the card (`serving.sweep_dispatcher` copies them from
    pinned memory without waiting).
    """
    if not rows:
        raise ValueError(
            "pad_segment_rows needs at least one segment row: an empty "
            "group has no reference pose and nothing to sweep (callers "
            "must skip dispatch for empty buckets)")
    xy_rows, valid_rows, fv_rows = [], [], []
    pr_rows, pt_rows, ref_r, ref_t = [], [], [], []
    for frames, (start, end) in rows:
        n = end - start
        xy = to_host(frames.xy, np.float32)
        if not 0 < n <= capacity:
            raise ValueError(
                f"segment {(start, end)} does not fit capacity {capacity}")
        if not 0 <= start < end <= xy.shape[0]:
            raise ValueError(f"segment {(start, end)} outside its window of "
                             f"{xy.shape[0]} frame(s)")
        idx = np.minimum(np.arange(start, start + capacity), end - 1)
        valid = to_host(frames.valid)
        poses_R = to_host(frames.poses.R, np.float32)
        poses_t = to_host(frames.poses.t, np.float32)
        xy_rows.append(xy[idx])
        valid_rows.append(valid[idx] if valid.dtype == bool
                          else valid[idx].astype(np.float32))
        fv_rows.append(np.arange(capacity) < n)
        pr_rows.append(poses_R[idx])
        pt_rows.append(poses_t[idx])
        ref_r.append(poses_R[start])
        ref_t.append(poses_t[start])
    return SegmentBatch(*(torch.from_numpy(np.stack(a)) for a in (
        xy_rows, valid_rows, fv_rows, pr_rows, pt_rows, ref_r, ref_t)))


# ---------------------------------------------------------------------------
# Per-frame projection and voting (the plain formulations)
# ---------------------------------------------------------------------------


def project_frame(
    cam: CameraModel,
    xy: Tensor,
    geom: FrameGeometry,
    opts: EMVSOptions,
) -> tuple[Tensor, Tensor]:
    """P for one frame (or a batch): (..., E, 2) -> ((..., Nz, E), (..., Nz, E))."""
    if opts.quantized:
        pol = opts.policy
        xy = pol.quantize_events(xy)
        H = pol.quantize_homography(geom.H)
        phi = pol.quantize_phi(geom.phi)
        xy0 = pol.quantize_canonical(apply_homography(H, xy))
        x_i, y_i = propagate_to_planes(cam, xy0, phi)
        if opts.voting == "nearest":
            x_i, y_i = pol.quantize_plane_coords(x_i, y_i)
        return x_i, y_i
    xy0 = apply_homography(geom.H, xy)
    return propagate_to_planes(cam, xy0, geom.phi)


def vote_frame(
    dsi: Tensor,
    x_i: Tensor,
    y_i: Tensor,
    valid: Tensor,
    cam: CameraModel,
    opts: EMVSOptions,
) -> Tensor:
    """R for one frame (or a batch). `valid` (..., E) weights each event."""
    w, h = cam.width, cam.height
    weights = valid.to(torch.float32)[..., None, :].expand(x_i.shape)
    if opts.formulation == "scatter":
        return vote_scatter(dsi, x_i, y_i, w=w, h=h, mode=opts.voting, weights=weights)
    if opts.formulation == "matmul":
        return vote_onehot_matmul(dsi, x_i, y_i, w=w, h=h, mode=opts.voting,
                                  weights=weights)
    if opts.formulation == "kernel":
        raise ValueError(
            "formulation='kernel' fuses projection and voting per segment; "
            "it is driven by sweep_segment_batch, not per frame")
    raise ValueError(f"unknown formulation {opts.formulation}")


# ---------------------------------------------------------------------------
# Segment processing: one sweep per capacity bucket
# ---------------------------------------------------------------------------


def _accum_dtype(opts: EMVSOptions) -> torch.dtype:
    if opts.voting == "bilinear":
        return torch.float32
    return dsi_lib.DSI_ACCUM_DTYPE


def precompute_batch_geometry(
    cam: CameraModel, poses_R: Tensor, poses_t: Tensor, T_w_ref: SE3,
    planes: Tensor, z0: Tensor
) -> FrameGeometry:
    """H/phi for a stack of frame poses (..., 3, 3); `T_w_ref` broadcasts
    against their leading dims."""
    return frame_geometry(cam, T_w_ref, SE3(poses_R, poses_t), z0, planes)


def precompute_segment_geometry(
    cam: CameraModel, frames: EventFrames, T_w_ref: SE3, planes: Tensor, z0: Tensor
) -> FrameGeometry:
    """H/phi for all frames of a segment (ARM-side work in the paper)."""
    return precompute_batch_geometry(cam, frames.poses.R, frames.poses.t,
                                     T_w_ref, planes, z0)


def sweep_segment_batch(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    batch: SegmentBatch,
    opts: EMVSOptions,
) -> tuple[Tensor, DepthMap]:
    """Vote, quantize-store, detect and filter a whole `SegmentBatch`:
    DSIs (S, Nz, h, w) and a DepthMap with (S, h, w) fields.

    DSI dtypes follow the reference: the kernel formulation stores float32
    (int32 when quantized); scatter/matmul accumulate int32 on nearest and
    float32 on bilinear (int32 when quantized).
    """
    if opts.formulation not in FORMULATIONS:
        raise ValueError(f"unknown formulation {opts.formulation}")
    planes = dsi_cfg.planes(device=batch.xy.device)
    z0 = planes[dsi_cfg.num_planes // 2]
    T_w_ref = SE3(batch.ref_R[:, None], batch.ref_t[:, None])
    geoms = precompute_batch_geometry(cam, batch.poses_R, batch.poses_t,
                                      T_w_ref, planes, z0)  # (S, C, ...)

    if opts.formulation == "kernel":
        phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y],
                          dim=-1)  # (S, C, Nz, 3)
        # the kernel counts each valid event as 1: `canonical_inputs`
        # refuses float weights, which may be fractional, by their dtype
        # (no host sync)
        dsi, conf, zf = backproject_vote_frames(
            batch.xy, batch.valid, geoms.H, phi, cam=cam, dsi_cfg=dsi_cfg,
            mode=opts.voting, quantized=opts.quantized, frame_valid=batch.frame_valid)
        if opts.quantized:
            dsi = dsi_lib.from_storage(dsi)
        dm = detect_and_filter_from(
            conf, zf, planes,
            threshold_c=opts.detection_threshold_c,
            min_votes=opts.detection_min_votes,
            median_filter=opts.median_filter,
        )
        return dsi, dm

    s = batch.xy.shape[0]
    dsi = torch.zeros((s, *dsi_cfg.shape), dtype=_accum_dtype(opts),
                      device=batch.xy.device)
    for c in range(batch.xy.shape[1]):
        geom = FrameGeometry(geoms.H[:, c], PlaneSweepCoeffs(
            geoms.phi.alpha[:, c], geoms.phi.beta_x[:, c], geoms.phi.beta_y[:, c]))
        x_i, y_i = project_frame(cam, batch.xy[:, c], geom, opts)
        dsi = vote_frame(dsi, x_i, y_i,
                         batch.valid[:, c] * batch.frame_valid[:, c, None], cam, opts)
    if opts.quantized:
        dsi = dsi_lib.storage_roundtrip(dsi)  # int16 store semantics
    dm = detect_and_filter(
        dsi, planes,
        threshold_c=opts.detection_threshold_c,
        min_votes=opts.detection_min_votes,
        median_filter=opts.median_filter,
    )
    return dsi, dm


def process_segments_batched(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    batch: SegmentBatch,
    opts: EMVSOptions,
) -> tuple[Tensor, DepthMap]:
    """The batched sweep backend of `run_emvs` (eager; one call per bucket)."""
    return sweep_segment_batch(cam, dsi_cfg, batch, opts)


def process_segment(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    frames: EventFrames,
    T_w_ref: SE3,
    opts: EMVSOptions,
) -> tuple[Tensor, DepthMap]:
    """Vote all frames of one key-frame segment into a fresh DSI; detect."""
    num_frames = frames.xy.shape[0]
    batch = SegmentBatch(
        xy=frames.xy[None],
        valid=_weights(frames.valid)[None],
        frame_valid=torch.ones((1, num_frames), dtype=torch.bool, device=frames.xy.device),
        poses_R=frames.poses.R[None],
        poses_t=frames.poses.t[None],
        ref_R=T_w_ref.R[None],
        ref_t=T_w_ref.t[None],
    )
    dsis, dms = process_segments_batched(cam, dsi_cfg, batch, opts)
    return dsis[0], DepthMap(dms.depth[0], dms.mask[0], dms.confidence[0])


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def _frames_on(frames: EventFrames, device: torch.device) -> EventFrames:
    """EventFrames (tensors or numpy arrays) as tensors on `device`."""
    return EventFrames(
        xy=torch.as_tensor(frames.xy, dtype=torch.float32, device=device),
        valid=torch.as_tensor(frames.valid, device=device),
        t_mid=torch.as_tensor(frames.t_mid, dtype=torch.float32, device=device),
        poses=SE3(torch.as_tensor(frames.poses.R, dtype=torch.float32, device=device),
                  torch.as_tensor(frames.poses.t, dtype=torch.float32, device=device)),
    )


def run_emvs(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    frames: EventFrames,
    opts: EMVSOptions = EMVSOptions(),
    *,
    sweep: str = "batched",
    mesh: Any | None = None,
    device=None,
) -> EMVSResult:
    """Process an aggregated event-frame sequence end to end.

    Segments are grouped into fixed frame-capacity buckets; each bucket is
    one sweep call plus one batched depth-map -> point-cloud conversion.
    Runs on the CUDA card unless `device="cpu"`.

    sweep: which segment-sweep backend runs each bucket.
      * "batched" — `process_segments_batched`, the bucket's segments as a
        tensor batch dimension of one sweep;
      * "sharded" — `repro_torch.distributed.emvs.process_segments_sharded`:
        the bucket's segment axis is split over the ranks of `mesh` (default
        `make_segment_mesh()`, every rank of the initialized default process
        group), so concurrent segments vote on different cards. Every rank
        calls `run_emvs` on the same frames and gets the whole result. The
        segment list is padded to a multiple of the mesh's segment-axis
        size by repeating the last segment; padded rows are discarded, and
        real rows equal the batched backend's bitwise.
    """
    if sweep not in ("batched", "sharded"):
        raise ValueError(
            f"unknown sweep backend {sweep!r}: expected 'batched' or 'sharded'")
    if mesh is not None and sweep != "sharded":
        raise ValueError(
            "mesh= is only meaningful with sweep='sharded'; the batched "
            "sweep would silently ignore it")
    n_shard = 1
    if sweep == "sharded":
        from repro_torch.distributed.emvs import (
            make_segment_mesh,
            process_segments_sharded,
            segment_axis_size,
        )

        if mesh is None:
            mesh = make_segment_mesh()
        n_shard = segment_axis_size(mesh)
    frames = _frames_on(frames, resolve_device(device))
    segs = plan_segments(frames, dsi_cfg, opts)
    if not segs:
        return EMVSResult(segments=[], clouds=[])

    by_cap: dict[int, list[tuple[int, int]]] = {}
    for seg in segs:
        by_cap.setdefault(bucket_capacity(seg[1] - seg[0]), []).append(seg)

    out: dict[tuple[int, int], tuple[SegmentResult, PointCloud]] = {}
    for cap in sorted(by_cap):
        seg_list = by_cap[cap]
        # a sharded sweep needs S divisible by the mesh's segment axis:
        # repeat the last segment (independent rows, discarded below)
        run_list = seg_list + [seg_list[-1]] * (-len(seg_list) % n_shard)
        batch = pad_segments(frames, run_list, cap)
        if sweep == "sharded":
            dsis, dms = process_segments_sharded(cam, dsi_cfg, batch, opts, mesh=mesh)
        else:
            dsis, dms = process_segments_batched(cam, dsi_cfg, batch, opts)
        pcs = depth_maps_to_points(cam, dms, SE3(batch.ref_R, batch.ref_t))
        for k, (start, end) in enumerate(seg_list):
            dm = DepthMap(dms.depth[k], dms.mask[k], dms.confidence[k])
            T_w_ref = SE3(batch.ref_R[k], batch.ref_t[k])
            out[(start, end)] = (
                SegmentResult(dm, dsis[k], T_w_ref, (start, end)),
                PointCloud(pcs.points[k], pcs.weights[k], pcs.valid[k]),
            )

    ordered = [out[seg] for seg in segs]
    return EMVSResult(segments=[r for r, _ in ordered],
                      clouds=[c for _, c in ordered])


def run_emvs_looped(
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    frames: EventFrames,
    opts: EMVSOptions = EMVSOptions(),
    *,
    device=None,
) -> EMVSResult:
    """Per-segment loop over `process_segment` (the numerical baseline)."""
    frames = _frames_on(frames, resolve_device(device))
    results: list[SegmentResult] = []
    clouds: list[PointCloud] = []
    for start, end in plan_segments(frames, dsi_cfg, opts):
        sl = EventFrames(frames.xy[start:end], frames.valid[start:end],
                         frames.t_mid[start:end],
                         SE3(frames.poses.R[start:end], frames.poses.t[start:end]))
        T_w_ref = SE3(frames.poses.R[start], frames.poses.t[start])
        dsi, dm = process_segment(cam, dsi_cfg, sl, T_w_ref, opts)
        results.append(SegmentResult(dm, dsi, T_w_ref, (start, end)))
        clouds.append(depth_map_to_points(cam, dm, T_w_ref))
    return EMVSResult(segments=results, clouds=clouds)
