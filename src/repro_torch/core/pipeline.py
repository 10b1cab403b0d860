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

Not ported yet: the dispatch planners, `pad_segment_rows`, the sharded
backend and the static-analysis trace specs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

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
from repro_torch.device import resolve_device
from repro_torch.events.aggregation import EventFrames
from repro_torch.kernels.backproject_vote.ops import backproject_vote_frames
from repro_torch.quant.policies import TABLE1, EMVSQuantPolicy

Tensor = torch.Tensor

# Smallest fixed segment capacity (frames per padded segment).
SEGMENT_BUCKET_MIN = 4

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
    device=None,
) -> EMVSResult:
    """Process an aggregated event-frame sequence end to end.

    Segments are grouped into fixed frame-capacity buckets; each bucket is
    one sweep call plus one batched depth-map -> point-cloud conversion.
    Runs on the CUDA card unless `device="cpu"`. Only the "batched" sweep
    backend is ported.
    """
    if sweep != "batched":
        raise ValueError(f"unknown sweep backend {sweep!r}: only 'batched' is ported")
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
        batch = pad_segments(frames, seg_list, cap)
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
