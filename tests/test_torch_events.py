"""The port's simulator and aggregation against the JAX reference.

Random draws use the same seeded numpy generator in the same order, so the
scene, timestamps, polarities, noise and validity match exactly, and with
the reference's poses every event coordinate matches too. The two packages'
sin/cos/arccos differ in the last bits, so rotations built from them (the
trajectory, interpolated frame poses) are held to POSE_ATOL: two float32
ulps at 1 (2 * 1.19e-7), for entries in [-1, 1].
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.events import aggregation as j_agg
from repro.events import simulator as j_sim
from repro.events.trajectory_stream import pose_at_times as j_pose_at_times
from repro_torch import interop
from repro_torch.core.geometry import SE3
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.events.stream_hygiene import NonMonotoneEventError, StreamOverlapError
from repro_torch.events.trajectory_stream import (
    PoseExtrapolationError,
    PoseExtrapolationWarning,
    pose_at_times,
)

POSE_ATOL = 2.5e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast and leaves the other
    cores to the test workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traj_from_reference(traj) -> t_sim.Trajectory:
    return t_sim.Trajectory(torch.from_numpy(np.array(traj.times)),
                            SE3(torch.from_numpy(np.array(traj.poses.R)),
                                torch.from_numpy(np.array(traj.poses.t))))


@pytest.fixture(scope="module")
def scene():
    cam = JCamera()
    cfg = dict(name="simulation_3planes", points_per_plane=60)
    points = j_sim.make_scene(j_sim.SceneConfig(**cfg))
    traj = j_sim.make_trajectory("simulation_3planes", 20)
    events = j_sim.simulate_events(cam, points, traj)
    return {"cam": cam, "cfg": cfg, "points": points, "traj": traj, "events": events,
            "port_cam": interop.camera_from_dict(dataclasses.asdict(cam))}


@pytest.mark.parametrize("name", ["simulation_3planes", "simulation_3walls",
                                  "slider_close", "slider_far"])
def test_make_scene_bitwise(name):
    cfg = dict(name=name, points_per_plane=50, seed=3)
    np.testing.assert_array_equal(j_sim.make_scene(j_sim.SceneConfig(**cfg)),
                                  t_sim.make_scene(t_sim.SceneConfig(**cfg)))


@pytest.mark.parametrize("name", ["simulation_3planes", "slider_far"])
def test_make_trajectory_close(name):
    ref = j_sim.make_trajectory(name, 33)
    got = t_sim.make_trajectory(name, 33, device="cpu")
    np.testing.assert_array_equal(np.asarray(ref.times), got.times.numpy())
    np.testing.assert_array_equal(np.asarray(ref.poses.t), got.poses.t.numpy())
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(ref.poses.R),
                               rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("own_trajectory", [False, True])
def test_simulate_events_matches(scene, own_trajectory):
    """Every event matches, with the reference's poses and with the port's
    own trajectory (its last-bit rotation differences round away)."""
    traj = (t_sim.make_trajectory("simulation_3planes", 20, device="cpu")
            if own_trajectory else _traj_from_reference(scene["traj"]))
    got = t_sim.simulate_events(scene["port_cam"], scene["points"], traj, device="cpu")
    ref = scene["events"]
    np.testing.assert_array_equal(np.asarray(ref.xy), got.xy.numpy())
    np.testing.assert_array_equal(np.asarray(ref.t), got.t.numpy())
    np.testing.assert_array_equal(np.asarray(ref.polarity), got.polarity.numpy())
    np.testing.assert_array_equal(np.asarray(ref.valid), got.valid.numpy())


def test_pose_at_times_close(scene):
    tq = np.sort(np.random.default_rng(0).uniform(-0.05, 1.05, 500)).astype(np.float32)
    ref = j_pose_at_times(scene["traj"], jnp.asarray(tq))
    got = pose_at_times(_traj_from_reference(scene["traj"]), torch.from_numpy(tq))
    np.testing.assert_array_equal(np.asarray(ref.t), got.t.numpy())
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("events_per_frame,keep_tail", [(256, True), (300, False)])
def test_aggregate_matches(scene, events_per_frame, keep_tail):
    ref = j_agg.aggregate(scene["cam"], scene["events"], scene["traj"],
                          events_per_frame=events_per_frame, keep_tail=keep_tail,
                          pose_extrapolation="clamp")
    ev = t_sim.EventStream(*(torch.from_numpy(np.array(a)) for a in scene["events"]))
    got = t_agg.aggregate(scene["port_cam"], ev, _traj_from_reference(scene["traj"]),
                          events_per_frame=events_per_frame, keep_tail=keep_tail,
                          pose_extrapolation="clamp", device="cpu")
    np.testing.assert_array_equal(ref.xy, got.xy.numpy())
    np.testing.assert_array_equal(ref.valid, got.valid.numpy())
    np.testing.assert_array_equal(ref.t_mid, got.t_mid.numpy())
    np.testing.assert_array_equal(ref.poses.t, got.poses.t.numpy())
    np.testing.assert_allclose(got.poses.R.numpy(), ref.poses.R, rtol=0, atol=POSE_ATOL)


def test_streaming_chunks_equal_offline(scene):
    """Any chunking of the stream gives the offline frames, bitwise."""
    ev = t_sim.EventStream(*(torch.from_numpy(np.array(a)) for a in scene["events"]))
    traj = _traj_from_reference(scene["traj"])
    offline = t_agg.aggregate(scene["port_cam"], ev, traj, events_per_frame=256,
                              pose_extrapolation="clamp", device="cpu")
    agg = t_agg.StreamingAggregator(scene["port_cam"], traj, 256,
                                    pose_extrapolation="clamp", device="cpu")
    parts, n = [], ev.t.shape[0]
    for lo in range(0, n, 777):
        parts.append(agg.push(t_sim.EventStream(*(a[lo:lo + 777] for a in ev))))
    parts.append(agg.flush())
    streamed = t_agg.concat_event_frames(parts)
    for a, b in zip((offline.xy, offline.valid, offline.t_mid, *offline.poses),
                    (streamed.xy, streamed.valid, streamed.t_mid, *streamed.poses)):
        assert torch.equal(a, b)


def test_aggregator_rejects_misordered_chunks(scene):
    traj = _traj_from_reference(scene["traj"])
    agg = t_agg.StreamingAggregator(scene["port_cam"], traj, 64, device="cpu")
    t = torch.tensor([0.5, 0.4], dtype=torch.float32)
    xy = torch.zeros((2, 2))
    chunk = t_sim.EventStream(xy, t, torch.ones(2, dtype=torch.int8), torch.ones(2, dtype=torch.bool))
    with pytest.raises(NonMonotoneEventError):
        agg.push(chunk)
    agg.push(chunk._replace(t=torch.tensor([0.5, 0.6])))
    with pytest.raises(StreamOverlapError):
        agg.push(chunk._replace(t=torch.tensor([0.1, 0.2])))


def test_pose_span_policies(scene):
    traj = _traj_from_reference(scene["traj"])
    ev = t_sim.EventStream(*(torch.from_numpy(np.array(a)) for a in scene["events"]))
    with pytest.warns(PoseExtrapolationWarning):
        t_agg.aggregate(scene["port_cam"], ev, traj, events_per_frame=256, device="cpu")
    with pytest.raises(PoseExtrapolationError):
        t_agg.aggregate(scene["port_cam"], ev, traj, events_per_frame=256,
                        pose_extrapolation="raise", device="cpu")
    with pytest.raises(PoseExtrapolationError):
        pose_at_times(traj, torch.tensor([2.0]), strict=True)


def test_ground_truth_and_absrel_match(scene):
    from repro.core.geometry import SE3 as JSE3

    traj = scene["traj"]
    T_ref = JSE3(traj.poses.R[3], traj.poses.t[3])
    gt_j, m_j = j_sim.ground_truth_depth(scene["cam"], scene["points"], T_ref)
    T_t = SE3(torch.from_numpy(np.array(traj.poses.R[3])),
              torch.from_numpy(np.array(traj.poses.t[3])))
    gt_t, m_t = t_sim.ground_truth_depth(scene["port_cam"], scene["points"], T_t)
    np.testing.assert_array_equal(np.asarray(m_j), m_t.numpy())
    np.testing.assert_array_equal(np.asarray(gt_j), gt_t.numpy())
    est = np.asarray(gt_j) * 1.1
    mask = np.asarray(m_j)
    a_j = float(j_sim.absrel(jnp.asarray(est), jnp.asarray(mask), gt_j, m_j))
    a_t = float(t_sim.absrel(torch.from_numpy(est), torch.from_numpy(np.array(mask)), gt_t, m_t))
    assert abs(a_j - a_t) < 1e-6
