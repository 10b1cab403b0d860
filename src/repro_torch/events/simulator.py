"""Synthetic event-camera simulator with ground-truth depth, in PyTorch.

Counterpart of `repro.events.simulator`: the DAVIS 240x180 camera moving
along a known trajectory through structured scenes. Scene points lie on
edge segments; each visible point emits one event per trajectory step at
its (integer) pixel. Random draws come from `numpy.random.default_rng`
seeded and ordered exactly as the reference draws them; the projection
runs in PyTorch on the requested device.

For the streaming engine: `slice_trajectory` and `iter_trajectory_chunks`
replay a tracker that delivers poses in chunks, and `corrupt_stream`
injects the adversarial ingest faults (`EVENT_CORRUPTIONS`) that
`events.stream_hygiene` guards against, on the host with the reference's
seeded numpy draws.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.camera import CameraModel, distort_normalized, project
from repro_torch.core.geometry import SE3, so3_exp
from repro_torch.device import resolve_device, to_host

Tensor = torch.Tensor


class EventStream(NamedTuple):
    xy: Tensor  # (N, 2) float32 raw pixel coords
    t: Tensor  # (N,) float32 timestamps, sorted
    polarity: Tensor  # (N,) int8 in {-1, +1}
    valid: Tensor  # (N,) bool


class Trajectory(NamedTuple):
    times: Tensor  # (F,)
    poses: SE3  # batched (F, 3, 3), (F, 3): T_w_cam


def slice_trajectory(traj: Trajectory, lo: int, hi: int) -> Trajectory:
    """Samples [lo, hi) of a trajectory, poses included.

    The building block for replaying a tracker feed: pair it with a cursor
    over `traj.times` to push exactly the poses a lagging tracker would
    have delivered by now.
    """
    return Trajectory(times=traj.times[lo:hi],
                      poses=SE3(traj.poses.R[lo:hi], traj.poses.t[lo:hi]))


def iter_trajectory_chunks(traj: Trajectory, chunk_poses: int):
    """Split a trajectory into contiguous chunks of `chunk_poses` samples;
    pushed in order to a `TrajectoryBuffer` they rebuild it exactly."""
    if chunk_poses < 1:
        raise ValueError(f"chunk_poses must be >= 1, got {chunk_poses}")
    n = int(traj.times.shape[0])
    for i in range(0, n, chunk_poses):
        yield slice_trajectory(traj, i, min(i + chunk_poses, n))


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    name: str = "simulation_3planes"
    points_per_plane: int = 600
    edge_segments_per_plane: int = 12
    noise_fraction: float = 0.02  # spurious events (sensor noise)
    seed: int = 0


def _sample_edge_points(rng: np.random.Generator, n_segments: int, n_points: int,
                        extent: float) -> np.ndarray:
    """Sample points along random line segments in a plane's local (u,v)."""
    seg_ends = rng.uniform(-extent, extent, size=(n_segments, 2, 2))
    pts = []
    per_seg = max(n_points // n_segments, 2)
    for a, b in seg_ends:
        s = np.linspace(0.0, 1.0, per_seg)[:, None]
        pts.append(a[None, :] * (1 - s) + b[None, :] * s)
    uv = np.concatenate(pts, axis=0)[:n_points]
    if uv.shape[0] < n_points:  # pad by repeating
        reps = int(np.ceil(n_points / uv.shape[0]))
        uv = np.tile(uv, (reps, 1))[:n_points]
    return uv


def make_scene(cfg: SceneConfig) -> np.ndarray:
    """(P, 3) float32 world-frame scene points for the named scene."""
    rng = np.random.default_rng(cfg.seed)
    n, k = cfg.points_per_plane, cfg.edge_segments_per_plane
    planes: list[np.ndarray] = []
    if cfg.name == "simulation_3planes":
        for depth, extent in ((1.0, 0.5), (2.0, 0.9), (3.5, 1.4)):
            uv = _sample_edge_points(rng, k, n, extent)
            planes.append(np.stack([uv[:, 0], uv[:, 1], np.full(n, depth)], axis=1))
    elif cfg.name == "simulation_3walls":
        uv = _sample_edge_points(rng, k, n, 1.2)
        planes.append(np.stack([uv[:, 0], uv[:, 1], np.full(n, 3.0)], axis=1))
        uv = _sample_edge_points(rng, k, n, 1.2)
        planes.append(np.stack([np.full(n, -1.4), uv[:, 0], 1.8 + 0.9 * uv[:, 1]], axis=1))
        uv = _sample_edge_points(rng, k, n, 1.2)
        planes.append(np.stack([np.full(n, 1.4), uv[:, 0], 1.8 + 0.9 * uv[:, 1]], axis=1))
    elif cfg.name in ("slider_close", "slider_far"):
        depth = 0.8 if cfg.name == "slider_close" else 2.8
        for dz, extent in ((0.0, 0.7), (0.35, 0.9), (0.8, 1.1)):
            uv = _sample_edge_points(rng, k, n, extent)
            planes.append(np.stack([uv[:, 0], uv[:, 1], np.full(n, depth + dz)], axis=1))
    else:
        raise ValueError(f"unknown scene {cfg.name}")
    return np.concatenate(planes, axis=0).astype(np.float32)


def make_trajectory(name: str, num_steps: int, seed: int = 0, *, device=None
                    ) -> Trajectory:
    """Camera trajectory T_w_cam(t). Slider: pure x-translation; sim: 6-DOF arc.

    The arc's rotations come from this package's `so3_exp`, whose sin/cos
    may differ from the reference's in the last bits.
    """
    dev = resolve_device(device)
    ts = np.linspace(0.0, 1.0, num_steps).astype(np.float32)
    if name.startswith("slider"):
        t = np.stack([0.25 * ts - 0.125, np.zeros_like(ts), np.zeros_like(ts)], axis=1)
        R = torch.from_numpy(np.tile(np.eye(3, dtype=np.float32), (num_steps, 1, 1)))
    else:
        t = np.stack(
            [0.30 * np.sin(np.pi * ts) - 0.15,
             0.10 * np.sin(2 * np.pi * ts),
             0.06 * (1 - np.cos(np.pi * ts))], axis=1).astype(np.float32)
        w = np.stack(
            [0.05 * np.sin(np.pi * ts), 0.12 * ts, 0.04 * np.sin(2 * np.pi * ts)],
            axis=1).astype(np.float32)
        R = so3_exp(torch.from_numpy(w).to(dev))
    return Trajectory(times=torch.from_numpy(ts).to(dev),
                      poses=SE3(R.to(dev), torch.from_numpy(t).to(dev)))


def simulate_events(
    cam: CameraModel,
    scene_points: np.ndarray,
    traj: Trajectory,
    noise_fraction: float = 0.02,
    seed: int = 0,
    integer_pixels: bool = True,
    *,
    device=None,
) -> EventStream:
    """Generate the event stream for a scene + trajectory (~steps * P
    events, fixed size, invalid ones masked and parked at -1e4)."""
    dev = resolve_device(device)
    pts = torch.as_tensor(np.asarray(scene_points, np.float32), device=dev)
    R = torch.as_tensor(traj.poses.R, device=dev)
    t = torch.as_tensor(traj.poses.t, device=dev)
    times0 = torch.as_tensor(traj.times, device=dev)
    T_cw = SE3(R, t).inverse()
    pc = T_cw.apply(pts)  # (F, P, 3) camera frame
    infront = pc[..., 2] > 0.05
    xy = project(cam, pc)
    if cam.has_distortion():
        xn = (xy[..., 0] - cam.cx) / cam.fx
        yn = (xy[..., 1] - cam.cy) / cam.fy
        xd, yd = distort_normalized(cam, xn, yn)
        xy = torch.stack([xd * cam.fx + cam.cx, yd * cam.fy + cam.cy], dim=-1)
    inb = ((xy[..., 0] >= 0) & (xy[..., 0] <= cam.width - 1)
           & (xy[..., 1] >= 0) & (xy[..., 1] <= cam.height - 1))
    valid = infront & inb
    if integer_pixels:
        xy = torch.round(xy)  # half to even, as jnp.round
    F, P = valid.shape

    rng = np.random.default_rng(seed)
    jitter = rng.uniform(0, 1.0 / max(F - 1, 1) * 0.45, size=(F, P)).astype(np.float32)
    times = times0[:, None] + torch.from_numpy(jitter).to(dev)
    pol = torch.from_numpy(rng.choice(np.array([-1, 1], dtype=np.int8), size=(F, P))).to(dev)

    xy = xy.reshape(-1, 2)
    tt = times.reshape(-1)
    vv = valid.reshape(-1)
    pp = pol.reshape(-1)

    n_total = xy.shape[0]
    n_noise = int(noise_fraction * n_total)
    if n_noise > 0:
        noise_idx = torch.from_numpy(rng.choice(n_total, size=n_noise, replace=False)).to(dev)
        noise_xy = torch.from_numpy(
            np.stack([rng.uniform(0, cam.width - 1, n_noise),
                      rng.uniform(0, cam.height - 1, n_noise)], axis=1)
            .astype(np.float32)).to(dev)
        if integer_pixels:
            noise_xy = torch.round(noise_xy)
        xy = xy.index_put((noise_idx,), noise_xy)
        vv = vv.index_put((noise_idx,), torch.ones_like(noise_idx, dtype=torch.bool))

    order = torch.argsort(tt, stable=True)
    xy, tt, vv, pp = xy[order], tt[order], vv[order], pp[order]
    xy = torch.where(vv[:, None], xy, torch.full_like(xy, -1e4))
    return EventStream(xy=xy.to(torch.float32), t=tt, polarity=pp, valid=vv)


EVENT_CORRUPTIONS = ("shuffle_events", "swap_chunks", "duplicate_chunk",
                     "out_of_bounds", "hot_pixel")


def _as_stream(xy, t, polarity, valid) -> EventStream:
    return EventStream(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (xy, t, polarity, valid)))


def corrupt_stream(stream: EventStream, mode: str, chunk_events: int, *,
                   seed: int = 0, width: int | None = None,
                   height: int | None = None,
                   burst: int = 32) -> list[EventStream]:
    """Fault injection: chunk a clean stream, then break one thing.

    Returns the stream split into host (CPU tensor) chunks of
    `chunk_events` with exactly one adversarial corruption applied, the
    same events the reference's `corrupt_stream` returns for the same
    seed:

      * `"shuffle_events"` — one mid-stream chunk's events permuted (tied
        timestamps keep their relative order, so a stable re-sort restores
        the chunk exactly);
      * `"swap_chunks"` — two adjacent chunks delivered in the wrong order;
      * `"duplicate_chunk"` — one chunk replayed byte-identically right
        after itself;
      * `"out_of_bounds"` — a few spurious valid events at off-sensor
        coordinates (needs `width`/`height`), at timestamps tied to their
        insertion point so ordering stays legal;
      * `"hot_pixel"` — a `burst` of events at one in-bounds pixel and one
        timestamp spliced into a mid-stream chunk (needs `width`/`height`).

    Injection sites are drawn from `numpy.random.default_rng(seed)`.
    """
    if mode not in EVENT_CORRUPTIONS:
        raise ValueError(f"unknown corruption mode {mode!r}: expected one "
                         f"of {EVENT_CORRUPTIONS}")
    if chunk_events < 1:
        raise ValueError(f"chunk_events must be >= 1, got {chunk_events}")
    if mode in ("out_of_bounds", "hot_pixel") and (width is None
                                                   or height is None):
        raise ValueError(f"mode {mode!r} needs the sensor size: pass "
                         f"width= and height=")
    xy = to_host(stream.xy, np.float32)
    t = to_host(stream.t, np.float32)
    pol = to_host(stream.polarity, np.int8)
    val = to_host(stream.valid, bool)
    chunks = [(xy[i:i + chunk_events], t[i:i + chunk_events],
               pol[i:i + chunk_events], val[i:i + chunk_events])
              for i in range(0, t.shape[0], chunk_events)]
    if not chunks:
        raise ValueError("cannot corrupt an empty stream")
    rng = np.random.default_rng(seed)
    k = len(chunks) // 2  # a mid-stream site: past warm-up, before flush
    c_xy, c_t, c_pol, c_val = chunks[k]
    nc = int(c_t.shape[0])
    if mode == "shuffle_events":
        if nc < 2 or np.unique(c_t).size < 2:
            raise ValueError("shuffle_events needs a chunk with >= 2 "
                             "distinct timestamps")
        while True:
            perm = rng.permutation(nc)
            _, inv = np.unique(c_t[perm], return_inverse=True)
            for g in range(int(inv.max()) + 1):
                pos = np.flatnonzero(inv == g)
                if pos.size > 1:
                    perm[pos] = np.sort(perm[pos])
            if not np.array_equal(perm, np.arange(nc)):  # reject no-ops
                break
        chunks[k] = (c_xy[perm], c_t[perm], c_pol[perm], c_val[perm])
    elif mode == "swap_chunks":
        if len(chunks) < 2:
            raise ValueError("swap_chunks needs >= 2 chunks")
        j = min(k, len(chunks) - 2)
        chunks[j], chunks[j + 1] = chunks[j + 1], chunks[j]
    elif mode == "duplicate_chunk":
        chunks.insert(k + 1, tuple(a.copy() for a in chunks[k]))
    elif mode == "out_of_bounds":
        m = min(4, nc)
        pos = np.sort(rng.integers(1, nc + 1, size=m))
        off_x = np.where(rng.random(m) < 0.5, -7.0, float(width) + 3.0)
        inj_xy = np.stack(
            [off_x, rng.uniform(0, height - 1, m)], axis=1).astype(np.float32)
        chunks[k] = (np.insert(c_xy, pos, inj_xy, axis=0),
                     np.insert(c_t, pos, c_t[pos - 1]),
                     np.insert(c_pol, pos, np.ones(m, np.int8)),
                     np.insert(c_val, pos, np.ones(m, bool)))
    elif mode == "hot_pixel":
        p = max(1, nc // 2)
        px = np.asarray([rng.integers(0, width), rng.integers(0, height)],
                        np.float32)
        chunks[k] = (np.insert(c_xy, p, np.tile(px, (burst, 1)), axis=0),
                     np.insert(c_t, p, np.full(burst, c_t[p - 1], np.float32)),
                     np.insert(c_pol, p, np.ones(burst, np.int8)),
                     np.insert(c_val, p, np.ones(burst, bool)))
    return [_as_stream(*c) for c in chunks]


def ground_truth_depth(cam: CameraModel, scene_points: np.ndarray, T_w_ref: SE3
                       ) -> tuple[Tensor, Tensor]:
    """Z-buffer the scene points into the reference view (on T_w_ref's
    device): (depth (h, w), valid (h, w)); pixels with no point invalid."""
    dev = T_w_ref.t.device
    pts = torch.as_tensor(np.asarray(scene_points, np.float32), device=dev)
    pc = T_w_ref.inverse().apply(pts)
    z = pc[:, 2]
    xy = project(cam, pc)
    xi = torch.round(xy[:, 0]).to(torch.int64)
    yi = torch.round(xy[:, 1]).to(torch.int64)
    ok = (z > 0.05) & (xi >= 0) & (xi < cam.width) & (yi >= 0) & (yi < cam.height)
    xi = torch.clamp(xi, 0, cam.width - 1)
    yi = torch.clamp(yi, 0, cam.height - 1)
    zbuf = torch.full((cam.height * cam.width,), float("inf"), dtype=torch.float32,
                      device=dev)
    zbuf = zbuf.scatter_reduce(0, yi * cam.width + xi,
                               torch.where(ok, z, torch.full_like(z, float("inf"))),
                               reduce="amin")
    zbuf = zbuf.reshape(cam.height, cam.width)
    valid = torch.isfinite(zbuf)
    return torch.where(valid, zbuf, torch.zeros_like(zbuf)), valid


def absrel(depth_est: Tensor, mask_est: Tensor, depth_gt: Tensor, mask_gt: Tensor
           ) -> Tensor:
    """Absolute relative depth error over jointly-valid pixels (paper metric)."""
    m = mask_est & mask_gt
    err = torch.abs(depth_est - depth_gt) / torch.clamp(depth_gt, min=1e-6)
    return torch.sum(torch.where(m, err, torch.zeros_like(err))) / torch.clamp(
        torch.sum(m), min=1)
