"""Seeded scenes, camera trajectories and event streams, in plain NumPy.

A frozen copy of the port's synthetic event camera (the `simulation_3planes`
scene of `repro_torch.events.simulator`), kept here so that later changes
to the program cannot move the benchmark's inputs:

  * the scene: points sampled along random edge segments on fronto-parallel
    planes (the configuration's `scene.planes`, `[depth, extent]` each);
  * the trajectory: the 6-DOF arc of the port's simulator, as a function of
    an arc parameter `s` in [0, 1], sampled once per simulator step;
  * the events: each scene point that projects into the sensor emits one
    event per step at its integer pixel, at a time drawn uniformly in the
    first 45% of the step; a share `noise_fraction` of the events is
    replaced by valid events at uniform random pixels; events that fall
    outside the sensor stay in the stream, marked invalid and parked at
    -1e4 (the simulator's fixed-size streams).

Every array is float32 (times, coordinates, poses), bool (validity) or
int8 (polarity). The same seed gives the same arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

F32 = np.float32
PARKED = F32(-1e4)
JITTER_SHARE = 0.45  # events of a step arrive in its first 45%


class Camera(NamedTuple):
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


class Stream(NamedTuple):
    """One camera's events and the trajectory that produced them."""

    xy: np.ndarray  # (N, 2) float32 pixel coords (parked where invalid)
    t: np.ndarray  # (N,) float32 seconds, non-decreasing
    polarity: np.ndarray  # (N,) int8 in {-1, +1}
    valid: np.ndarray  # (N,) bool
    pose_t: np.ndarray  # (K,) float32 sample times, increasing
    pose_R: np.ndarray  # (K, 3, 3) float32 T_w_cam rotation
    pose_p: np.ndarray  # (K, 3) float32 T_w_cam translation


def camera(cfg: dict) -> Camera:
    c = cfg["camera"]
    return Camera(int(c["width"]), int(c["height"]), float(c["fx"]), float(c["fy"]),
                  float(c["cx"]), float(c["cy"]))


def scene_points(cfg: dict, seed: int) -> np.ndarray:
    """(P, 3) float32 world points: per plane, `points_per_plane` points
    spread over `edge_segments_per_plane` random segments in its extent."""
    sc = cfg["scene"]
    rng = np.random.default_rng(seed)
    n, k = int(sc["points_per_plane"]), int(sc["edge_segments_per_plane"])
    per_seg = max(n // k, 2)
    s = np.linspace(0.0, 1.0, per_seg)[:, None]
    planes = []
    for depth, extent in sc["planes"]:
        ends = rng.uniform(-extent, extent, size=(k, 2, 2))
        uv = np.concatenate([a[None] * (1 - s) + b[None] * s for a, b in ends])
        uv = np.resize(uv, (n, 2))  # cut, or repeat, to n points
        planes.append(np.stack([uv[:, 0], uv[:, 1], np.full(n, depth)], axis=1))
    return np.concatenate(planes).astype(F32)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3), in float64."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w, axis=-1)[..., None, None]
    safe = np.where(theta < 1e-12, 1.0, theta)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = np.zeros_like(wx)
    K = np.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], -1).reshape(*w.shape[:-1], 3, 3)
    K = K / safe
    eye = np.broadcast_to(np.eye(3), K.shape)
    return eye + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def arc(s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """T_w_cam along the simulator's 6-DOF arc at arc parameters `s`:
    (R (n, 3, 3), p (n, 3)), float32."""
    s = np.asarray(s, np.float64)
    p = np.stack([0.30 * np.sin(np.pi * s) - 0.15,
                  0.10 * np.sin(2 * np.pi * s),
                  0.06 * (1 - np.cos(np.pi * s))], axis=1)
    w = np.stack([0.05 * np.sin(np.pi * s), 0.12 * s, 0.04 * np.sin(2 * np.pi * s)],
                 axis=1)
    return so3_exp(w).astype(F32), p.astype(F32)


def sweep_parameter(steps: np.ndarray, steps_per_pass: int, phase: float = 0.0
                    ) -> np.ndarray:
    """The arc parameter of a camera that sweeps the arc forward and back
    (a triangle wave): one pass is `steps_per_pass` samples from s = 0 to
    s = 1; `phase` shifts the start, in passes."""
    u = np.asarray(steps, np.float64) / (steps_per_pass - 1) + phase
    u = np.mod(u, 2.0)
    return np.where(u <= 1.0, u, 2.0 - u)


def project_steps(cam: Camera, pts: np.ndarray, R: np.ndarray, p: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Integer pixels (n, P, 2) float32 and in-sensor mask (n, P) of every
    point at every pose."""
    rel = pts[None, :, :] - p[:, None, :]  # (n, P, 3)
    pc = np.einsum("nji,npj->npi", R, rel, dtype=F32)  # R^T (X - p)
    z = pc[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        x = F32(cam.fx) * pc[..., 0] / z + F32(cam.cx)
        y = F32(cam.fy) * pc[..., 1] / z + F32(cam.cy)
    ok = ((z > 0.05) & (x >= 0) & (x <= cam.width - 1)
          & (y >= 0) & (y <= cam.height - 1))
    xy = np.round(np.stack([x, y], axis=-1)).astype(F32)
    return np.where(ok[..., None], xy, PARKED), ok


def make_stream(cam: Camera, pts: np.ndarray, arc_s: np.ndarray,
                step_s: float, noise_fraction: float, seed: int) -> Stream:
    """Events of `len(arc_s) - 1` steps; the trajectory has one sample more,
    so every event lies inside the sampled span.

    Step k starts at k * step_s. Its events, one per scene point, carry
    sorted times in [k, k + 0.45) * step_s, the points in a random order.
    """
    rng = np.random.default_rng(seed)
    n_steps = len(arc_s) - 1
    n_pts = pts.shape[0]
    R, p = arc(arc_s)
    # the pose of a step depends only on its arc parameter: project each
    # distinct parameter once (a sweeping camera revisits them every pass)
    uniq, inv = np.unique(arc_s[:n_steps], return_inverse=True)
    Ru, pu = arc(uniq)
    xy_u, ok_u = project_steps(cam, pts, Ru, pu)
    order = rng.permuted(np.broadcast_to(np.arange(n_pts), (n_steps, n_pts)), axis=1)
    xy = xy_u[inv[:, None], order]  # (n_steps, P, 2)
    ok = ok_u[inv[:, None], order]
    # sorted uniform arrival times per step: normalised exponential spacings
    gaps = rng.standard_exponential((n_steps, n_pts + 1), dtype=F32)
    frac = np.cumsum(gaps, axis=1, dtype=F32)
    frac = frac[:, :n_pts] / frac[:, n_pts:]
    t = (np.arange(n_steps, dtype=np.float64)[:, None] + JITTER_SHARE * frac) * step_s
    pol = np.where(rng.random((n_steps, n_pts), dtype=F32) < 0.5, -1, 1).astype(np.int8)
    noise = rng.random((n_steps, n_pts), dtype=F32) < noise_fraction
    n_noise = int(noise.sum())
    noise_xy = np.round(np.stack([rng.uniform(0, cam.width - 1, n_noise),
                                  rng.uniform(0, cam.height - 1, n_noise)],
                                 axis=1)).astype(F32)
    xy[noise] = noise_xy
    ok = ok | noise
    t = t.astype(F32).reshape(-1)
    # float32 rounding may tie neighbouring steps' times, never reorder
    # them; keep the stream sorted all the same
    t = np.maximum.accumulate(t)
    times = (np.arange(n_steps + 1, dtype=np.float64) * step_s).astype(F32)
    return Stream(xy=xy.reshape(-1, 2), t=t, polarity=pol.reshape(-1),
                  valid=ok.reshape(-1), pose_t=times, pose_R=R, pose_p=p)


def offline_sequence(cfg: dict, traffic: dict, seed: int) -> Stream:
    """One recorded sequence: the arc once, `steps` simulator steps over
    one second, on a scene of its own."""
    cam = camera(cfg)
    steps = int(traffic["steps"])
    arc_s = np.arange(steps + 1, dtype=np.float64) / (steps - 1)
    return make_stream(cam, scene_points(cfg, seed), arc_s, 1.0 / (steps - 1),
                       float(cfg["scene"]["noise_fraction"]), seed)


def live_stream(cfg: dict, traffic: dict, seed: int, camera_index: int,
                duration_s: float) -> Stream:
    """One camera of a live rig, with a scene of its own: it sweeps the arc
    forward and back for `duration_s` seconds at `rate_events_per_s /
    cameras` events a second, starting `camera_index / cameras` of a pass
    along it."""
    cam = camera(cfg)
    n_cams = int(traffic["cameras"])
    n_pts = len(cfg["scene"]["planes"]) * int(cfg["scene"]["points_per_plane"])
    step_s = n_pts / (float(traffic["rate_events_per_s"]) / n_cams)
    n_steps = int(np.ceil(duration_s / step_s)) + 1
    s = sweep_parameter(np.arange(n_steps + 1), int(traffic["steps_per_pass"]),
                        phase=camera_index / n_cams)
    own = seed * n_cams + camera_index
    return make_stream(cam, scene_points(cfg, own), s, step_s,
                       float(cfg["scene"]["noise_fraction"]), own)
