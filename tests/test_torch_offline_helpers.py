"""The offline path's smaller modules against the reference, on the CPU.

Point-cloud merge and outlier filter, key-frame selection, the pose
helpers, the DSI saturation monitors, storage bytes and the memory
report, and per-segment geometry. The same numpy inputs go to both
packages. Integers, masks and dicts must be equal; float results are
bitwise (tolerance 0) except rotation entries that pass through the
trajectory's sin/cos, held to POSE_ATOL = 2.5e-7 as in
tests/test_torch_events.py, and `pose_distance`, held to one float32 ulp
of the reference and of the float64 norm: its float32 square root is
correctly rounded in XLA but not in PyTorch's CPU build (1 ulp off for
about a fifth of random float32 inputs on an AVX-512 AMD host), and
XLA:CPU sums the squares with fused multiply-adds only where the host has
FMA (`XLA_FLAGS=--xla_cpu_max_isa=AVX` moves 2 of these 20 distances by
1 ulp; tests/test_torch_pipeline.py::
test_host_rounding_cases_hold_without_fma reruns this case without FMA).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dsi as j_dsi
from repro.core import keyframe as j_kf
from repro.core import pointcloud as j_pc
from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.geometry import SE3 as JSE3
from repro.core.geometry import pose_distance as j_pose_distance
from repro.core.geometry import relative_pose_ref_from_cam as j_relative_pose
from repro.core.pipeline import precompute_segment_geometry as j_segment_geometry
from repro.events.aggregation import EventFrames as JEventFrames
from repro.quant import fixed_point as j_fp
from repro.quant.policies import memory_report as j_memory_report
from repro_torch import interop
from repro_torch.core import dsi as t_dsi
from repro_torch.core import keyframe as t_kf
from repro_torch.core import pointcloud as t_pc
from repro_torch.core import pipeline as tp
from repro_torch.core.camera import CAMERAS
from repro_torch.core.geometry import SE3, pose_distance, relative_pose_ref_from_cam
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.quant import fixed_point as t_fp
from repro_torch.quant.policies import memory_report

POSE_ATOL = 2.5e-7


@pytest.fixture(scope="module")
def poses():
    """A 20-step simulated arc's poses as numpy (R, t)."""
    traj = t_sim.make_trajectory("simulation_3planes", 20, device="cpu")
    return traj.poses.R.numpy(), traj.poses.t.numpy()


@pytest.fixture(scope="module")
def emvs_cloud():
    """The merged cloud of a small port `run_emvs` on the CPU, as numpy."""
    cam = CAMERAS["davis240"]
    traj = t_sim.make_trajectory("simulation_3planes", 32, device="cpu")
    ev = t_sim.simulate_events(cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=300)),
                               traj, device="cpu")
    frames = t_agg.aggregate(cam, ev, traj, events_per_frame=1024,
                             pose_extrapolation="clamp", device="cpu")
    cfg = tp.DSIConfig.for_camera(cam, num_planes=32, z_min=0.6, z_max=4.5)
    res = tp.run_emvs(cam, cfg, frames, tp.EMVSOptions(formulation="kernel"), device="cpu")
    cloud = t_pc.concatenate(res.clouds)
    assert int(cloud.valid.sum()) > 100
    return cloud.points.numpy(), cloud.weights.numpy(), cloud.valid.numpy()


def _both_filters(points, weights, valid, **kw):
    want = j_pc.radius_outlier_filter(
        j_pc.PointCloud(jnp.asarray(points), jnp.asarray(weights), jnp.asarray(valid)), **kw)
    got = t_pc.radius_outlier_filter(
        t_pc.PointCloud(*(torch.from_numpy(a) for a in (points, weights, valid))), **kw)
    return np.asarray(want.valid), got


@pytest.mark.parametrize("kw", [dict(radius=0.08, min_neighbors=2),
                                dict(radius=0.05, min_neighbors=1, max_points=700),
                                dict(radius=0.02, min_neighbors=4)])
def test_radius_outlier_filter_on_an_emvs_cloud(emvs_cloud, kw):
    keep, got = _both_filters(*emvs_cloud, **kw)
    np.testing.assert_array_equal(got.valid.numpy(), keep)
    assert 0 < keep.sum() < emvs_cloud[2].sum()
    np.testing.assert_array_equal(got.points.numpy(), emvs_cloud[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_radius_outlier_filter_at_exactly_the_radius(seed):
    """Points on a grid whose spacing is the radius, plus random points:
    distances at and next to the threshold keep the reference's
    float32 decisions, over more than one 1,024-row chunk."""
    rng = np.random.default_rng(seed)
    r = 0.05
    g = np.arange(11, dtype=np.float32) * np.float32(r)
    grid = np.stack(np.meshgrid(g, g, g[:10], indexing="ij"), -1).reshape(-1, 3)
    pts = np.concatenate([grid, rng.uniform(0, 0.5, (300, 3)).astype(np.float32)])
    valid = rng.random(pts.shape[0]) > 0.1
    weights = rng.random(pts.shape[0]).astype(np.float32)
    assert pts.shape[0] > 1024
    for min_neighbors in (1, 3, 6):
        keep, got = _both_filters(pts, weights, valid, radius=r, min_neighbors=min_neighbors)
        np.testing.assert_array_equal(got.valid.numpy(), keep)
    keep, got = _both_filters(pts, weights, np.zeros_like(valid), radius=r)
    assert not got.valid.any() and not keep.any()


def test_concatenate_and_merge():
    rng = np.random.default_rng(2)
    blocks = [(rng.random((n, 3), np.float32), rng.random(n, np.float32), rng.random(n) > 0.5)
              for n in (5, 0, 7)]
    j_map, t_map = [], []
    for b in blocks:
        j_map = j_pc.merge(j_map, j_pc.PointCloud(*(jnp.asarray(a) for a in b)))
        t_map = t_pc.merge(t_map, t_pc.PointCloud(*(torch.from_numpy(a) for a in b)))
    assert len(t_map) == len(j_map) == 3
    want, got = j_pc.concatenate(j_map), t_pc.concatenate(t_map)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_keyframe_selection(poses):
    """Walking the arc frame by frame, both packages declare the same key
    frames, count them the same and keep the same reference pose."""
    R, t = poses
    j_state = j_kf.init_keyframe_state(JSE3(jnp.asarray(R[0]), jnp.asarray(t[0])), 2.5, 0.03)
    t_state = t_kf.init_keyframe_state(SE3(torch.from_numpy(R[0]), torch.from_numpy(t[0])),
                                       2.5, 0.03)
    assert t_state.keyframe_id.dtype == torch.int32
    assert t_state.dist_threshold.item() == float(j_state.dist_threshold)
    flags = []
    for i in range(1, R.shape[0]):
        jc = JSE3(jnp.asarray(R[i]), jnp.asarray(t[i]))
        tc = SE3(torch.from_numpy(R[i]), torch.from_numpy(t[i]))
        j_new, t_new = j_kf.is_new_keyframe(j_state, jc), t_kf.is_new_keyframe(t_state, tc)
        assert bool(j_new) == bool(t_new)
        flags.append(bool(t_new))
        j_state = j_kf.advance_keyframe(j_state, jc, j_new)
        t_state = t_kf.advance_keyframe(t_state, tc, t_new)
        assert int(j_state.keyframe_id) == int(t_state.keyframe_id)
        np.testing.assert_array_equal(np.asarray(j_state.T_w_ref.R), t_state.T_w_ref.R.numpy())
        np.testing.assert_array_equal(np.asarray(j_state.T_w_ref.t), t_state.T_w_ref.t.numpy())
    assert 1 < sum(flags) < len(flags)


def test_pose_helpers(poses):
    R, t = poses
    j_a, j_b = JSE3(jnp.asarray(R[0]), jnp.asarray(t[0])), JSE3(jnp.asarray(R), jnp.asarray(t))
    t_a, t_b = SE3(torch.from_numpy(R[0]), torch.from_numpy(t[0])), SE3(torch.from_numpy(R),
                                                                         torch.from_numpy(t))
    for i in range(R.shape[0]):
        jb = JSE3(j_b.R[i], j_b.t[i])
        tb = SE3(t_b.R[i], t_b.t[i])
        want, got = np.float32(j_pose_distance(jb, j_a)), pose_distance(tb, t_a)
        assert got.dtype == torch.float32
        got = np.float32(got.item())
        d64 = t[i].astype(np.float64) - t[0].astype(np.float64)
        exact = np.sqrt(np.sum(d64 * d64))
        ulp = np.spacing(np.float32(exact))
        assert abs(float(got) - float(want)) <= np.spacing(want), (i, got, want)
        assert abs(float(got) - exact) <= ulp, (i, got, exact)
        want, got = j_relative_pose(j_a, jb), relative_pose_ref_from_cam(t_a, tb)
        np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=POSE_ATOL)
        np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_dsi_saturation_monitors(dtype):
    rng = np.random.default_rng(4)
    dsi = rng.integers(-40000, 40000, (6, 13, 17)).astype(dtype)
    dsi.flat[:40] = 32767
    dsi.flat[40:60] = -32768
    for name in ("saturation_fraction", "store_saturation_fraction"):
        want = np.asarray(getattr(j_dsi, name)(jnp.asarray(dsi)))
        got = getattr(t_dsi, name)(torch.from_numpy(dsi))
        assert got.dtype == torch.float32 and got.item() == float(want), name
    stored = t_dsi.storage_roundtrip(torch.from_numpy(dsi))
    assert t_dsi.saturation_fraction(stored).item() == 0.0
    cfg = JDSIConfig(width=17, height=13, num_planes=6)
    port_cfg = interop.dsi_config_from_dict(dataclasses.asdict(cfg))
    z = t_dsi.zeros(port_cfg)
    assert z.dtype == torch.int32 and tuple(z.shape) == j_dsi.zeros(cfg).shape
    assert not z.any() and t_dsi.zeros(port_cfg, torch.float32).dtype == torch.float32


def test_storage_bytes_and_memory_report():
    for name in ("Q9_7", "Q11_21", "INT8", "INT16"):
        for n in (0, 1, 1000, 5_529_600):
            want = j_fp.storage_bytes(n, getattr(j_fp, name))
            assert t_fp.storage_bytes(n, getattr(t_fp, name)) == want
    for cam_name, cam in CAMERAS.items():
        jcam = JCamera(**dataclasses.asdict(cam))
        for nz, e in ((128, 1024), (64, 512)):
            assert memory_report(cam, nz, e) == j_memory_report(jcam, nz, e), cam_name


def test_precompute_segment_geometry(poses):
    R, t = poses
    cam = JCamera()
    cfg = JDSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    n = R.shape[0]
    xy = np.zeros((n, 8, 2), np.float32)
    valid = np.ones((n, 8), bool)
    t_mid = np.linspace(0, 1, n).astype(np.float32)
    j_frames = JEventFrames(jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(t_mid),
                            JSE3(jnp.asarray(R), jnp.asarray(t)))

    def geometry(fr, T_w_ref):
        planes = cfg.planes()
        return j_segment_geometry(cam, fr, T_w_ref, planes, planes[8])

    # jitted, planes included, as the reference's sweep runs it (XLA then
    # forms the multiply-adds the port reproduces)
    want = jax.jit(geometry)(j_frames, JSE3(j_frames.poses.R[3], j_frames.poses.t[3]))
    frames = interop.event_frames_from_numpy(xy, valid, t_mid, R, t, device="cpu")
    port_cfg = interop.dsi_config_from_dict(dataclasses.asdict(cfg))
    tplanes = port_cfg.planes()
    got = tp.precompute_segment_geometry(
        interop.camera_from_dict(dataclasses.asdict(cam)), frames,
        SE3(frames.poses.R[3], frames.poses.t[3]), tplanes, tplanes[8])
    np.testing.assert_array_equal(got.H.numpy(), np.asarray(want.H))
    for a, b in zip(got.phi, want.phi):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
