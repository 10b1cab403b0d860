"""Parity of the PyTorch port's numeric foundations with the JAX reference.

Same numpy inputs through both packages, on the CPU. Everything here is
held bitwise: the port reproduces where XLA:CPU rounds (its fused
multiply-adds, its linspace, its saturating float->int32 conversion).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import geometry as jgeo
from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.pipeline import precompute_batch_geometry as j_batch_geometry
from repro.quant import fixed_point as jfp
from repro.quant.policies import TABLE1 as J_TABLE1
from repro_torch import interop
from repro_torch.core import geometry as tgeo
from repro_torch.core.pipeline import precompute_batch_geometry as t_batch_geometry
from repro_torch.quant import fixed_point as tfp
from repro_torch.quant.policies import TABLE1 as T_TABLE1

FORMATS = ["Q9_7", "Q11_21", "INT8", "INT16"]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(a, b, what: str = "") -> None:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _rotations(rng, n: int) -> np.ndarray:
    w = (rng.normal(size=(n, 3)) * 0.15).astype(np.float32)
    return np.asarray(jgeo.so3_exp(jnp.asarray(w)))


def test_round_half_away_bitwise():
    x = np.concatenate([
        np.arange(-8, 8, 0.5, dtype=np.float32),
        np.random.default_rng(0).normal(size=4096).astype(np.float32) * 300,
        np.array([0.0, -0.0, np.nan, np.inf, -np.inf], np.float32),
    ])
    _same(jfp.round_half_away(jnp.asarray(x)), tfp.round_half_away(_t(x)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_bitwise(fmt):
    """Includes the Q11.21 saturation at ±2000 (2^31 - 1 rounds to 2^31 in
    float32), NaN (-> 0) and ±inf."""
    rng = np.random.default_rng(1)
    x = np.concatenate([
        rng.normal(size=4096).astype(np.float32) * 500,
        np.arange(-3, 3, 1 / 256, dtype=np.float32),
        np.array([2000.0, -2000.0, 1024.0, -1024.0, 1023.9999, np.nan, np.inf,
                  -np.inf, 255.5, -0.5, 70000.0, -70000.0], np.float32),
    ])
    jf, tf = getattr(jfp, fmt), getattr(tfp, fmt)
    q_j = jax.jit(lambda v: jfp.quantize(v, jf))(jnp.asarray(x))
    q_t = tfp.quantize(_t(x), tf)
    _same(q_j, q_t, f"quantize {fmt}")
    _same(jfp.quantize_roundtrip(jnp.asarray(x), jf), tfp.quantize_roundtrip(_t(x), tf))


def test_quantize_plane_coords_park_at_max_bitwise():
    c = np.concatenate([
        np.arange(-2, 258, 0.25, dtype=np.float32),
        np.array([np.nan, np.inf, -np.inf, -0.5, -0.51, 255.5, 255.51], np.float32),
    ])
    _same(J_TABLE1.quantize_plane_coord_values(jnp.asarray(c)),
          T_TABLE1.quantize_plane_coord_values(_t(c)))


@pytest.mark.parametrize("z_min,z_max,num", [
    (0.5, 5.0, 128), (0.6, 4.5, 128), (0.6, 4.5, 16), (0.6, 4.5, 32),
    (0.5, 5.0, 8), (0.3, 7.0, 64), (0.2, 9.0, 256), (1.0, 2.0, 3),
])
def test_depth_planes_bitwise(z_min, z_max, num):
    """Against the planes the reference's jitted sweep computes (eager
    `depth_planes` differs from its own jitted value in the last bit)."""
    ref = jax.jit(lambda: jgeo.depth_planes(z_min, z_max, num))()
    _same(ref, tgeo.depth_planes(z_min, z_max, num))


def test_depth_planes_past_256_within_two_ulps():
    """ROADMAP C3: at 512 planes XLA:CPU compiles the fused linspace
    another way. Of the 512 inverse depths 108 differ from the reference's
    jitted ones, each by 1 ulp; the reciprocal turns that into 96 planes
    that differ, by at most 2 ulps. (The reference's eager planes differ
    from its jitted ones too: 6 planes, by up to 2 ulps.)"""
    z_min, z_max, num = 0.6, 4.5, 512

    def ulps(a, b) -> np.ndarray:
        a = np.asarray(a).view(np.int32).astype(np.int64)
        return np.abs(a - b.numpy().view(np.int32).astype(np.int64))

    inv_ref = jax.jit(lambda: jnp.linspace(1.0 / z_max, 1.0 / z_min, num,
                                           dtype=jnp.float32))()
    inv = ulps(inv_ref, tgeo._linspace(1.0 / z_max, 1.0 / z_min, num))
    assert int((inv != 0).sum()) == 108 and int(inv.max()) == 1
    planes = ulps(jax.jit(lambda: jgeo.depth_planes(z_min, z_max, num))(),
                  tgeo.depth_planes(z_min, z_max, num))
    assert int((planes != 0).sum()) == 96 and int(planes.max()) == 2


def test_apply_homography_bitwise():
    rng = np.random.default_rng(2)
    H = np.eye(3, dtype=np.float32) + rng.normal(size=(6, 3, 3)).astype(np.float32) * 0.05
    H[:, 0, 2] += 4.0
    xy = rng.uniform(-10, 250, (6, 512, 2)).astype(np.float32)
    ref = jax.jit(jax.vmap(jgeo.apply_homography))(jnp.asarray(H), jnp.asarray(xy))
    _same(ref, tgeo.apply_homography(_t(H), _t(xy)))


def test_propagate_to_planes_bitwise():
    rng = np.random.default_rng(3)
    cam = JCamera()
    xy0 = rng.uniform(-10, 250, (512, 2)).astype(np.float32)
    phi = [rng.uniform(0.7, 1.3, 16).astype(np.float32),
           rng.uniform(-6, 6, 16).astype(np.float32),
           rng.uniform(-6, 6, 16).astype(np.float32)]
    xj, yj = jax.jit(lambda a, b, c, d: jgeo.propagate_to_planes(
        cam, a, jgeo.PlaneSweepCoeffs(b, c, d)))(xy0, *phi)
    xt, yt = tgeo.propagate_to_planes(
        interop.camera_from_dict(dataclasses.asdict(cam)), _t(xy0),
        tgeo.PlaneSweepCoeffs(*map(_t, phi)))
    _same(xj, xt)
    _same(yj, yt)


@pytest.mark.parametrize("num_planes", [16, 128])
def test_frame_geometry_bitwise(num_planes):
    """H and phi for a stack of poses, as the reference's jitted sweep
    computes them (planes and z0 derived inside the program)."""
    rng = np.random.default_rng(4)
    cam = JCamera()
    cfg = JDSIConfig.for_camera(cam, num_planes=num_planes, z_min=0.6, z_max=4.5)
    S, C = 3, 8
    R = _rotations(rng, S * C).reshape(S, C, 3, 3)
    t = (rng.normal(size=(S, C, 3)) * 0.2).astype(np.float32)
    ref_R, ref_t = R[:, 0], t[:, 0]

    def jax_geom(R, t, rR, rt):
        planes = cfg.planes()
        z0 = planes[cfg.num_planes // 2]
        return jax.vmap(lambda r, tt, a, b: j_batch_geometry(
            cam, r, tt, jgeo.SE3(a, b), planes, z0))(R, t, rR, rt)

    gj = jax.jit(jax_geom)(R, t, ref_R, ref_t)
    tcfg = interop.dsi_config_from_dict(dataclasses.asdict(cfg))
    tcam = interop.camera_from_dict(dataclasses.asdict(cam))
    planes = tcfg.planes()
    gt = t_batch_geometry(tcam, _t(R), _t(t),
                          tgeo.SE3(_t(ref_R)[:, None], _t(ref_t)[:, None]),
                          planes, planes[num_planes // 2])
    _same(gj.H, gt.H, "H")
    _same(gj.phi.alpha, gt.phi.alpha, "alpha")
    _same(gj.phi.beta_x, gt.phi.beta_x, "beta_x")
    _same(gj.phi.beta_y, gt.phi.beta_y, "beta_y")


def test_se3_compose_inverse_bitwise():
    rng = np.random.default_rng(5)
    Ra, Rb = _rotations(rng, 64), _rotations(rng, 64)
    ta, tb = (rng.normal(size=(2, 64, 3)) * 0.3).astype(np.float32)

    def jax_rel(Ra, ta, Rb, tb):
        T = jgeo.SE3(Ra, ta).inverse().compose(jgeo.SE3(Rb, tb))
        return T.R, T.t

    Rj, tj = jax.jit(jax.vmap(jax_rel))(Ra, ta, Rb, tb)
    T = tgeo.SE3(_t(Ra), _t(ta)).inverse().compose(tgeo.SE3(_t(Rb), _t(tb)))
    _same(Rj, T.R)
    _same(tj, T.t)
