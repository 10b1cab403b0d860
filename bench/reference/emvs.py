"""Plain EMVS, written out from the paper's equations and Table 1.

The benchmark's reference: from a generated event stream and trajectory it
works out again everything the port derives (event frames and their poses,
the key-frame segment plan, each segment's plane-sweep geometry, votes,
stored DSI, depth map and point cloud), with plain PyTorch operations on
any device. It imports nothing of the program.

`dtype` sets the precision of every floating-point step that is not fixed
by Table 1 (pose interpolation, geometry, projection, detection). The
configuration states float32; the benchmark's control runs this module in
bfloat16, the next precision below.

Stages (Rebecq et al., IJCV 2018; the Eventor paper's Table 1):
  A  frames of `events_per_frame` consecutive events, the trailing partial
     frame padded with parked invalid events; each frame's time is the
     median of its real events, its pose interpolated there (translation
     linearly, rotation along the geodesic);
  K  a segment closes when the camera has moved more than
     `keyframe_dist_frac * (z_min + z_max) / 2` from the segment's first
     frame; segments of fewer than two frames are dropped;
  P  per frame, the homography H through the middle plane Z0 and the
     per-plane coefficients (alpha, beta_x, beta_y):
       x_i = alpha_i (x0 - cx) + beta_x_i + cx;
     quantized: events, canonical coordinates in Q9.7, H and phi in
     Q11.21 (round half away from zero, saturating), plane coordinates to
     an unsigned 8-bit pixel index (outside [-0.5, 255.5] parked at 255);
  R  one vote per valid event and plane at the nearest voxel (round half
     up) inside the sensor; int32 counts, stored as int16 (saturating);
  D  confidence = max over planes, the first argmax refined by a parabola
     (offset clipped to 0.5), kept where the confidence exceeds its
     Gaussian-blurred neighbourhood (sigma 2.5, radius 5, edge padding) by
     `detection_threshold_c` and reaches `detection_min_votes`; depth
     interpolated between planes; a 3x3 median over kept neighbours
     (wrapping at the borders);
  M  each kept pixel unprojected at its depth and moved to the world frame
     by the segment's reference pose.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

PARKED = -1e4


class Frames(NamedTuple):
    xy: Tensor  # (F, E, 2) float32
    valid: Tensor  # (F, E) bool
    t_mid: Tensor  # (F,) float32
    R: Tensor  # (F, 3, 3) `dtype`
    p: Tensor  # (F, 3) `dtype`


class SegmentOut(NamedTuple):
    dsi: Tensor  # (Nz, h, w) int32 (stored values)
    depth: Tensor  # (h, w)
    mask: Tensor  # (h, w) bool
    confidence: Tensor  # (h, w)
    R_ref: Tensor  # (3, 3)
    p_ref: Tensor  # (3,)
    points: Tensor  # (h*w, 3) world frame
    weights: Tensor  # (h*w,)
    point_valid: Tensor  # (h*w,) bool


# ---------------------------------------------------------------------------
# A: frames and their poses
# ---------------------------------------------------------------------------


def make_frames(xy: np.ndarray, t: np.ndarray, valid: np.ndarray,
                pose_t: np.ndarray, pose_R: np.ndarray, pose_p: np.ndarray, *,
                events_per_frame: int, keep_tail: bool, device,
                dtype=torch.float32) -> Frames:
    """Frames of consecutive events; with `keep_tail` the trailing partial
    frame too, padded with parked invalid events."""
    e = events_per_frame
    n = t.shape[0]
    n_full = n // e
    xy_d = torch.as_tensor(xy, device=device)
    t_d = torch.as_tensor(t, device=device)
    v_d = torch.as_tensor(valid, device=device)
    fx = xy_d[:n_full * e].reshape(n_full, e, 2)
    fv = v_d[:n_full * e].reshape(n_full, e)
    ts = torch.sort(t_d[:n_full * e].reshape(n_full, e), dim=1).values
    t_mid = (ts[:, e // 2 - 1] + ts[:, e // 2]) / 2 if e % 2 == 0 else ts[:, e // 2]
    if keep_tail and n > n_full * e:
        rest = n - n_full * e
        pad = e - rest
        tx = torch.cat([xy_d[n_full * e:],
                        torch.full((pad, 2), PARKED, dtype=torch.float32, device=device)])
        tv = torch.cat([v_d[n_full * e:], torch.zeros(pad, dtype=torch.bool, device=device)])
        tt = torch.sort(t_d[n_full * e:]).values
        tm = (tt[(rest - 1) // 2] + tt[rest // 2]) / 2 if rest % 2 == 0 else tt[rest // 2]
        fx = torch.cat([fx, tx[None]])
        fv = torch.cat([fv, tv[None]])
        t_mid = torch.cat([t_mid, tm.reshape(1)])
    R, p = interpolate_poses(pose_t, pose_R, pose_p, t_mid, dtype=dtype)
    return Frames(fx, fv, t_mid, R, p)


def so3_log(R: Tensor) -> Tensor:
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    s = torch.sin(theta)
    small = torch.abs(s) < 1e-8
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / (2 * torch.where(small, torch.ones_like(s), s)))
    return v * scale[..., None]


def so3_exp(w: Tensor) -> Tensor:
    theta = torch.sqrt((w * w).sum(-1))[..., None, None]
    small = theta < 1e-8
    safe = torch.where(small, torch.ones_like(theta), theta)
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([z, -w[..., 2], w[..., 1], w[..., 2], z, -w[..., 0],
                     -w[..., 1], w[..., 0], z], -1).reshape(*w.shape[:-1], 3, 3) / safe
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1 - torch.cos(theta)) * mm(K, K)
    return torch.where(small, eye, R)


def mm(A: Tensor, B: Tensor) -> Tensor:
    """3x3 matrix product as sums of elementwise products (no TF32, no
    reduced-precision matmul unit)."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def mv(A: Tensor, v: Tensor) -> Tensor:
    return (A * v[..., None, :]).sum(-1)


def interpolate_poses(pose_t, pose_R, pose_p, tq: Tensor, *, dtype=torch.float32
                      ) -> tuple[Tensor, Tensor]:
    """Poses at query times: the bracketing samples (clamped to the span),
    translation lerp, rotation R0 exp(frac log(R0^T R1)) written as
    exp(frac log(R1 R0^T)) R0."""
    dev = tq.device
    times = torch.as_tensor(pose_t, device=dev)
    Rs = torch.as_tensor(pose_R, device=dev).to(dtype)
    ps = torch.as_tensor(pose_p, device=dev).to(dtype)
    n = times.shape[0]
    i = torch.clamp(torch.searchsorted(times, tq, right=True) - 1, 0, n - 2)
    t0, t1 = times[i], times[i + 1]
    frac = torch.clamp((tq - t0) / torch.clamp(t1 - t0, min=1e-9), 0, 1).to(dtype)
    p = ps[i] + frac[:, None] * (ps[i + 1] - ps[i])
    w = so3_log(mm(Rs[i + 1], Rs[i].transpose(-1, -2)))
    R = mm(so3_exp(w * frac[:, None]), Rs[i])
    return R, p


# ---------------------------------------------------------------------------
# K: the key-frame plan
# ---------------------------------------------------------------------------


def plan_segments(p: Tensor, threshold: float) -> list[tuple[int, int]]:
    """Segments [start, end) of at least two frames."""
    pos = p.detach().to("cpu", torch.float64).numpy()
    bounds, start = [], 0
    for i in range(1, pos.shape[0]):
        if np.linalg.norm(pos[i] - pos[start]) > threshold:
            bounds.append((start, i))
            start = i
    bounds.append((start, pos.shape[0]))
    return [(a, b) for a, b in bounds if b - a >= 2]


# ---------------------------------------------------------------------------
# Table 1
# ---------------------------------------------------------------------------


def fixed_point(x: Tensor, total_bits: int, frac_bits: int) -> Tensor:
    """Signed Q(total-frac).frac: round half away from zero, saturate, back
    to the value it stands for (float32)."""
    scale = float(2 ** frac_bits)
    q = torch.sign(x) * torch.floor(torch.abs(x).to(torch.float32) * scale + 0.5)
    lo, hi = -(2 ** (total_bits - 1)), 2 ** (total_bits - 1) - 1
    q = torch.clamp(q.to(torch.float64), lo, hi)
    q = torch.nan_to_num(q, nan=0.0)
    return (q / scale).to(torch.float32)


def pixel_index_u8(c: Tensor) -> Tensor:
    """Table 1's unsigned 8-bit plane coordinate: outside [-0.5, 255.5]
    (NaN excepted) it parks at 255; inside, round half away from zero and
    clamp to [0, 255]; NaN gives 0."""
    inside = torch.where(c >= 0, torch.floor(c + 0.5), torch.zeros_like(c))
    inside = torch.clamp(torch.nan_to_num(inside, nan=0.0), 0, 255)
    return torch.where((c < -0.5) | (c > 255.5), torch.full_like(c, 255.0), inside)


# ---------------------------------------------------------------------------
# P, R, D, M for one segment
# ---------------------------------------------------------------------------


def depth_planes(z_min: float, z_max: float, n: int, device, dtype) -> Tensor:
    """Planes uniform in inverse depth, ascending in depth."""
    inv = torch.linspace(1.0 / z_max, 1.0 / z_min, n, dtype=torch.float64)
    return torch.flip(1.0 / inv, [0]).to(dtype).to(device)


def segment(fr: Frames, seg: tuple[int, int], cfg: dict, *, dtype=torch.float32
            ) -> SegmentOut:
    """Everything one key-frame segment yields."""
    cam, em = cfg["camera"], cfg["emvs"]
    w, h = int(cam["width"]), int(cam["height"])
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    nz = int(em["num_planes"])
    quant = bool(em["quantized"])
    a, b = seg
    dev = fr.xy.device
    planes = depth_planes(float(em["z_min"]), float(em["z_max"]), nz, dev, dtype)
    z0 = planes[nz // 2]
    R_ref, p_ref = fr.R[a], fr.p[a]
    R_f, p_f = fr.R[a:b], fr.p[a:b]

    # P: relative pose, homography through Z0, per-plane coefficients
    Rt = R_ref.transpose(-1, -2)
    R_rc = mm(Rt.expand(R_f.shape), R_f)
    t_rc = mv(Rt.expand(R_f.shape), p_f - p_ref)
    n_c = R_rc[:, 2, :]
    d_c = z0 - t_rc[:, 2]
    H_m = R_rc + t_rc[:, :, None] * n_c[:, None, :] / d_c[:, None, None]
    K = torch.tensor([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], dtype=torch.float32)
    K_inv = torch.tensor([[1 / fx, 0, -cx / fx], [0, 1 / fy, -cy / fy], [0, 0, 1]],
                         dtype=torch.float32)
    K, K_inv = K.to(dev, dtype), K_inv.to(dev, dtype)
    H = mm(mm(K.expand(H_m.shape), H_m), K_inv.expand(H_m.shape))
    H = H / H[:, 2:3, 2:3]
    cz = t_rc[:, 2:3]
    s = (planes[None] - cz) / (z0 - cz)
    alpha = s * z0 / planes
    beta_x = fx * t_rc[:, 0:1] * (1 - s) / planes
    beta_y = fy * t_rc[:, 1:2] * (1 - s) / planes

    xy = fr.xy[a:b].to(dtype)
    if quant:
        xy = fixed_point(xy, 16, 7).to(dtype)
        H = fixed_point(H, 32, 21).to(dtype)
        alpha, beta_x, beta_y = (fixed_point(v, 32, 21).to(dtype)
                                 for v in (alpha, beta_x, beta_y))
    x, y = xy[..., 0], xy[..., 1]

    def row(i):
        return (H[:, i, 0:1] * x + H[:, i, 1:2] * y) + H[:, i, 2:3]

    den = row(2)
    x0, y0 = row(0) / den, row(1) / den
    if quant:
        x0, y0 = fixed_point(x0, 16, 7).to(dtype), fixed_point(y0, 16, 7).to(dtype)
    xi = alpha[:, :, None] * (x0 - cx)[:, None, :] + beta_x[:, :, None] + cx
    yi = alpha[:, :, None] * (y0 - cy)[:, None, :] + beta_y[:, :, None] + cy
    if quant:
        xi, yi = pixel_index_u8(xi.float()), pixel_index_u8(yi.float())

    # R: nearest votes of valid events, int32 counts, int16 store
    xr = torch.floor(torch.nan_to_num(xi.float(), nan=-1e6) + 0.5)
    yr = torch.floor(torch.nan_to_num(yi.float(), nan=-1e6) + 0.5)
    ok = ((xr >= 0) & (xr <= w - 1) & (yr >= 0) & (yr <= h - 1)
          & fr.valid[a:b][:, None, :])
    zz = torch.arange(nz, device=dev)[None, :, None].expand(ok.shape)
    flat = (zz * h + yr.long().clamp(0, h - 1)) * w + xr.long().clamp(0, w - 1)
    counts = torch.bincount(flat[ok], minlength=nz * h * w)
    dsi = torch.clamp(counts, -32768, 32767).to(torch.int32).reshape(nz, h, w)

    # D: max, refined argmax, adaptive threshold, depth, median
    d = dsi.to(dtype)
    conf = d.max(0).values
    z = torch.argmax((d == conf[None]).to(torch.int8), dim=0)
    zm, zp = (z - 1).clamp(0, nz - 1), (z + 1).clamp(0, nz - 1)
    cm = d.gather(0, zm[None])[0]
    cp = d.gather(0, zp[None])[0]
    den2 = cm - 2 * conf + cp
    off = torch.where(torch.abs(den2) > 1e-6,
                      0.5 * (cm - cp) / torch.where(den2 == 0, torch.ones_like(den2), den2),
                      torch.zeros_like(den2))
    zf = z.to(dtype) + torch.clamp(off, -0.5, 0.5)
    local = blur(conf, float(em["adaptive_sigma"]), int(em["adaptive_radius"]))
    mask = (conf > local + float(em["detection_threshold_c"])) & (
        conf >= float(em["detection_min_votes"]))
    lo = torch.floor(zf).long().clamp(0, nz - 1)
    hi = (lo + 1).clamp(0, nz - 1)
    fr_z = zf - lo.to(dtype)
    depth = planes[lo] * (1 - fr_z) + planes[hi] * fr_z
    if em["median_filter"]:
        depth = median3(depth, mask)

    # M: unproject kept pixels at their depth, into the world frame
    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=dtype),
                            torch.arange(w, device=dev, dtype=dtype), indexing="ij")
    pc = torch.stack([(xs - cx) / fx * depth, (ys - cy) / fy * depth, depth], -1)
    pts = mv(R_ref.expand(h * w, 3, 3), pc.reshape(-1, 3)) + p_ref
    return SegmentOut(dsi, depth, mask, conf, R_ref, p_ref, pts, conf.reshape(-1),
                      mask.reshape(-1))


def blur(img: Tensor, sigma: float, radius: int) -> Tensor:
    """Separable Gaussian (normalised taps), edges padded with the border."""
    x = torch.arange(-radius, radius + 1, dtype=img.dtype, device=img.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()
    for dim in (0, 1):
        n = img.shape[dim]
        idx = torch.arange(-radius, n + radius, device=img.device).clamp(0, n - 1)
        padded = img.index_select(dim, idx)
        img = sum(k[j] * padded.narrow(dim, j, n) for j in range(2 * radius + 1))
    return img


def median3(depth: Tensor, mask: Tensor) -> Tensor:
    """3x3 median of the kept neighbours (lower median of an even count);
    pixels not kept keep their value."""
    inf = torch.full_like(depth, float("inf"))
    stack = torch.stack([torch.where(torch.roll(mask, (dy, dx), (0, 1)),
                                     torch.roll(depth, (dy, dx), (0, 1)), inf)
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    count = torch.isfinite(stack).sum(0)
    srt = torch.sort(stack, dim=0).values
    mid = torch.clamp((count - 1) // 2, min=0)
    med = srt.gather(0, mid[None])[0]
    return torch.where(mask & (count > 0), med, depth)
