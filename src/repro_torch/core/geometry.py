"""SE(3) poses and plane-sweep geometry, in PyTorch.

Counterpart of `repro.core.geometry`: the canonical-plane homography H_Z0
and the proportional back-projection coefficients phi = {alpha_i, beta_i}
that the paper computes once per event frame, with

    x_i = alpha_i * (x0 - cx) + beta_x_i + cx,
    y_i = alpha_i * (y0 - cy) + beta_y_i + cy.

Constants are made on the tensors' device (fills, `torch.eye`), never
copied from the host, so no function here makes the host wait on the
card. Rounding follows the reference as XLA compiles it for the CPU, where it
contracts a multiply feeding an add into one fused multiply-add (FMA).
Wherever the reference rounds once, this module calls `torch.addcmul`,
which PyTorch evaluates as an FMA; elsewhere every operation rounds on its
own. In particular:

  * a 3x3 matrix product is the chain fma(a2, b2, fma(a1, b1, a0 * b0))
    (`matmul3`, `matvec3`);
  * `alpha * (x - cx) + beta` is fma(alpha, x - cx, beta), then + cx;
  * the homography's rows are fma(h0, x, h1 * y) + h2.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.core.camera import CameraModel

Tensor = torch.Tensor


def _dot3(a0: Tensor, b0: Tensor, a1: Tensor, b1: Tensor, a2: Tensor, b2: Tensor
          ) -> Tensor:
    """a0*b0 + a1*b1 + a2*b2 rounded as XLA:CPU's three-term dot."""
    return torch.addcmul(torch.addcmul(a0 * b0, a1, b1), a2, b2)


def matmul3(A: Tensor, B: Tensor) -> Tensor:
    """(..., 3, 3) @ (..., 3, 3) with the reference's rounding."""
    return _dot3(A[..., :, 0, None], B[..., None, 0, :],
                 A[..., :, 1, None], B[..., None, 1, :],
                 A[..., :, 2, None], B[..., None, 2, :])


def matvec3(A: Tensor, v: Tensor) -> Tensor:
    """(..., 3, 3) @ (..., 3) with the reference's rounding."""
    return _dot3(A[..., :, 0], v[..., None, 0],
                 A[..., :, 1], v[..., None, 1],
                 A[..., :, 2], v[..., None, 2])


class SE3(NamedTuple):
    """Rigid transform X_out = R @ X_in + t. Batched via leading dims."""

    R: Tensor  # (..., 3, 3)
    t: Tensor  # (..., 3)

    def compose(self, other: "SE3") -> "SE3":
        """self ∘ other: apply `other` first, then `self`."""
        return SE3(matmul3(self.R, other.R), matvec3(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -matvec3(Rt, self.t))

    def apply(self, points: Tensor) -> Tensor:
        """points: (..., N, 3) -> transformed (..., N, 3)."""
        return matvec3(self.R[..., None, :, :], points) + self.t[..., None, :]


def so3_exp(w: Tensor) -> Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.linalg.vector_norm(w, dim=-1)[..., None, None]  # (..., 1, 1)
    safe = torch.where(theta < 1e-8, torch.ones_like(theta), theta)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )
    K = K / safe
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    R = eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * matmul3(K, K)
    return torch.where(theta < 1e-8, eye, R)


def so3_log(R: Tensor) -> Tensor:
    """Rotation matrix -> axis-angle (..., 3)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sin(theta)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    scale = torch.where(torch.abs(sin_theta) < 1e-8, torch.full_like(theta, 0.5),
                        theta / (2.0 * sin_theta + 1e-30))
    return v * scale[..., None]


def interpolate_pose(p0: SE3, p1: SE3, frac: Tensor) -> SE3:
    """Linear pose interpolation (translation lerp; rotation via axis-angle).

    `frac` broadcasts against the translation's leading dims: pass
    (..., 1) for batched poses.
    """
    t = p0.t + frac * (p1.t - p0.t)
    dR = matmul3(p1.R, p0.R.transpose(-1, -2))
    w = so3_log(dR)
    R = matmul3(so3_exp(w * frac), p0.R)
    return SE3(R, t)


# ---------------------------------------------------------------------------
# Plane sweep: depth planes, canonical homography, proportional coefficients
# ---------------------------------------------------------------------------


def _linspace(start: float, stop: float, num: int, device=None) -> Tensor:
    """`jnp.linspace(start, stop, num, dtype=float32)` as the sweep program
    computes it: XLA rewrites `iota / div` to `iota * f32(1 / div)` and
    `stop * step` to `iota * (stop * c)`, and evaluates
    `start * (1 - step) + iota * (stop * c)` with every product rounded;
    the last entry is `stop` itself."""
    f32 = torch.float32
    start_t = torch.full((), start, dtype=f32, device=device)
    stop_t = torch.full((), stop, dtype=f32, device=device)
    if num <= 1:
        return start_t.reshape(1)[:num]
    div = num - 1
    c = torch.full((), float(torch.tensor(1.0, dtype=f32) / torch.tensor(float(div), dtype=f32)),
                   dtype=f32, device=device)
    iota = torch.arange(div, dtype=f32, device=device)
    out = start_t * (1.0 - iota * c) + iota * (stop_t * c)
    return torch.cat([out, stop_t.reshape(1)])


def depth_planes(z_min: float, z_max: float, num: int, inverse_depth: bool = True,
                 device=None) -> Tensor:
    """Depth plane placement; EMVS samples uniformly in inverse depth.

    Bitwise equal to the planes the reference's jitted sweep uses for
    `num <= 256` (`torch.linspace` differs from them in the last bit).
    """
    if inverse_depth:
        inv = _linspace(1.0 / z_max, 1.0 / z_min, num, device)
        return torch.flip(1.0 / inv, [0])  # ascending depth
    return _linspace(z_min, z_max, num, device)


def relative_pose_ref_from_cam(T_w_ref: SE3, T_w_cam: SE3) -> SE3:
    """T_ref_cam: maps points in the current camera's frame to the
    reference frame."""
    return T_w_ref.inverse().compose(T_w_cam)


@functools.lru_cache(maxsize=16)
def _intrinsics(cam: CameraModel, device: torch.device) -> tuple[Tensor, Tensor]:
    """`cam.K` and `cam.K_inv` on `device`, each entry filled in from the
    host matrix's float32 value: fills, not a copy from the host, so
    nothing waits for the card. Shared read-only by every caller."""
    out = []
    for host in (cam.K, cam.K_inv):
        m = torch.empty((3, 3), dtype=torch.float32, device=device)
        for i, row in enumerate(host.tolist()):
            for j, v in enumerate(row):
                m[i, j].fill_(v)
        out.append(m)
    return out[0], out[1]


def canonical_homography(cam: CameraModel, T_ref_cam: SE3, z0: Tensor) -> Tensor:
    """H_Z0 (..., 3, 3): current-camera pixels -> reference pixels via z = Z0.

        H = K (R_rc + t_rc n_c^T / d_c) K^{-1},  n_c = R_rc^T e_z,
        d_c = Z0 - e_z . t_rc,  normalized so H[2, 2] = 1.
    """
    R_rc, t_rc = T_ref_cam.R, T_ref_cam.t
    dev = R_rc.device
    e_z = torch.eye(3, dtype=torch.float32, device=dev)[2]
    n_c = matvec3(R_rc.transpose(-1, -2), e_z.expand(t_rc.shape))
    d_c = z0 - matvec3(t_rc[..., None, :], e_z.expand(t_rc.shape))[..., 0]
    H_metric = R_rc + (t_rc[..., :, None] * n_c[..., None, :]) / d_c[..., None, None]
    K, K_inv = _intrinsics(cam, dev)
    K, K_inv = K.expand(H_metric.shape), K_inv.expand(H_metric.shape)
    H = matmul3(matmul3(K, H_metric), K_inv)
    return H / H[..., 2:3, 2:3]


class PlaneSweepCoeffs(NamedTuple):
    """phi: the proportional back-projection coefficients, each (..., Nz)."""

    alpha: Tensor
    beta_x: Tensor
    beta_y: Tensor


def proportional_coeffs(
    cam: CameraModel, T_ref_cam: SE3, z0: Tensor, planes: Tensor
) -> PlaneSweepCoeffs:
    """phi = {alpha_i, beta_i} for all depth planes (once per frame)."""
    c_ref = T_ref_cam.t[..., None, :]  # current camera centre in the reference frame
    cz = c_ref[..., 2]
    s = (planes - cz) / (z0 - cz)
    alpha = s * z0 / planes
    beta_x = cam.fx * c_ref[..., 0] * (1.0 - s) / planes
    beta_y = cam.fy * c_ref[..., 1] * (1.0 - s) / planes
    return PlaneSweepCoeffs(alpha, beta_x, beta_y)


def apply_homography(H: Tensor, xy: Tensor) -> Tensor:
    """P(Z0): homography (..., 3, 3) applied to pixel coords (..., E, 2)."""
    x, y = xy[..., 0], xy[..., 1]

    def h(i: int, j: int) -> Tensor:
        return H[..., i, j, None]

    denom = torch.addcmul(h(2, 1) * y, h(2, 0), x) + h(2, 2)
    u = (torch.addcmul(h(0, 1) * y, h(0, 0), x) + h(0, 2)) / denom
    v = (torch.addcmul(h(1, 1) * y, h(1, 0), x) + h(1, 2)) / denom
    return torch.stack([u, v], dim=-1)


def propagate_to_planes(
    cam: CameraModel, xy0: Tensor, phi: PlaneSweepCoeffs
) -> tuple[Tensor, Tensor]:
    """P(Z0 -> Zi): xy0 (..., E, 2) -> (x_i, y_i), each (..., Nz, E)."""
    xc = (xy0[..., 0] - cam.cx)[..., None, :]
    yc = (xy0[..., 1] - cam.cy)[..., None, :]
    alpha = phi.alpha[..., :, None]
    x_i = torch.addcmul(phi.beta_x[..., :, None], alpha, xc) + cam.cx
    y_i = torch.addcmul(phi.beta_y[..., :, None], alpha, yc) + cam.cy
    return x_i, y_i



def pose_distance(a: SE3, b: SE3) -> Tensor:
    """Translation distance between two poses (the key-frame criterion):
    the norm of a.t - b.t, its squares summed as XLA:CPU's reduction sums
    them (x * x, then fused multiply-adds of y and z)."""
    d = a.t - b.t
    return torch.sqrt(_dot3(d[..., 0], d[..., 0], d[..., 1], d[..., 1], d[..., 2], d[..., 2]))
