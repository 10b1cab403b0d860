"""The frame-pose kernel (`kernels/frame_poses`) and `aggregate`'s staged card
path, off the card.

The kernel itself runs only on the card (`tests/test_torch_cuda.py` holds it
bitwise to the eager `pose_at_times` there, and `aggregate` to the streaming
aggregator). Here: the wrapper's routes (CPU: the plain version, bitwise
`pose_at_times`; meta: the outputs' shapes and dtypes, nothing launched; any
other device raises) and the launcher's refusals; the staged path's host half
on the CPU: each frame's mid-time bitwise `np.median`, the staged fields
(unstaged on the CPU) bitwise the aggregator's frames, the out-of-span
policies and the monotone check as before, and, traced on meta tensors, one
copy and one `frame_poses` operation as the only device work. The streaming
aggregator poses through the wrapper too: on the CPU bitwise `pose_at_times`
(pose-gated), off it by one `frame_poses` operation.
"""
from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.camera import CameraModel
from repro_torch.core.geometry import SE3, so3_exp
from repro_torch.events import aggregation as t_agg
from repro_torch.events.simulator import (
    EventStream,
    SceneConfig,
    Trajectory,
    make_scene,
    make_trajectory,
    simulate_events,
)
from repro_torch.events.stream_hygiene import NonMonotoneEventError
from repro_torch.events.trajectory_stream import (
    PoseExtrapolationError,
    PoseExtrapolationWarning,
    pose_at_times,
)
from repro_torch.kernels import cuda
from repro_torch.kernels.frame_poses.kernel import frame_poses_cuda
from repro_torch.kernels.frame_poses.ops import frame_poses


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _trajectory(seed: int, n: int, *, repeat: bool = False) -> Trajectory:
    """`n` samples over [0, 1): random rotations and translations; with
    `repeat`, some sample times repeated (zero-length intervals)."""
    rng = np.random.default_rng(seed)
    times = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
    if repeat:
        times[1::3] = times[0::3][:len(times[1::3])]
        times = np.sort(times)
    R = so3_exp(torch.from_numpy(rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)))
    t = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3)).astype(np.float32))
    return Trajectory(torch.from_numpy(times), SE3(R.contiguous(), t))


def _queries(seed: int, f: int) -> torch.Tensor:
    """Query times before, inside and past the span, sample times among them."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.uniform(-0.2, 1.2, f).astype(np.float32))


@pytest.mark.parametrize("n,repeat", [(2, False), (7, False), (96, False), (30, True)])
def test_the_wrapper_on_cpu_is_pose_at_times(n, repeat):
    """CPU tensors take the plain version: bitwise `pose_at_times`, queries
    before, inside and past the span, no launch counted."""
    traj = _trajectory(n, n, repeat=repeat)
    tq = torch.cat([_queries(n, 200), traj.times[:5]])
    before = dict(cuda.launch_counts)
    got = frame_poses(traj.times, traj.poses.R, traj.poses.t, tq)
    assert dict(cuda.launch_counts) == before
    want = pose_at_times(traj, tq)
    for a, b in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("n,f", [(2, 1), (96, 169), (5, 1000)])
def test_meta_path_gives_the_outputs_shapes(n, f):
    """On meta tensors the operation returns the kernel's output shapes and
    dtypes and launches nothing."""
    before = dict(cuda.launch_counts)
    R, t = frame_poses(torch.empty(n, device="meta"), torch.empty((n, 3, 3), device="meta"),
                       torch.empty((n, 3), device="meta"), torch.empty(f, device="meta"))
    assert (R.device.type, t.device.type) == ("meta", "meta")
    assert (tuple(R.shape), R.dtype, tuple(t.shape), t.dtype) == (
        (f, 3, 3), torch.float32, (f, 3), torch.float32)
    assert dict(cuda.launch_counts) == before


@pytest.mark.parametrize("dev", ["xpu", "mps"])
def test_other_devices_raise(dev):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.zeros(4, device=dev)
        with pytest.raises(ValueError, match="no path for device"):
            frame_poses(x, torch.zeros((4, 3, 3), device=dev), torch.zeros((4, 3), device=dev),
                        x)


def test_launcher_refuses():
    """The launcher raises rather than converting: host tensors, another
    dtype, a shape that does not match, one sample; nothing launches."""
    m = dict(device="meta")
    times, R, t, tq = (torch.empty(4, **m), torch.empty((4, 3, 3), **m),
                       torch.empty((4, 3), **m), torch.empty(9, **m))
    before = dict(cuda.launch_counts)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        frame_poses_cuda(times, R, t, torch.empty(9))
    with pytest.raises(TypeError, match="float32"):
        frame_poses_cuda(times, R.double(), t, tq)
    with pytest.raises(ValueError, match=r"must be \(4, 3\)"):
        frame_poses_cuda(times, R, torch.empty((5, 3), **m), tq)
    with pytest.raises(ValueError, match="contiguous"):
        frame_poses_cuda(times, R.transpose(1, 2), t, tq)
    with pytest.raises(ValueError, match="at least 2 trajectory samples"):
        frame_poses_cuda(times[:1], R[:1], t[:1], tq)
    assert dict(cuda.launch_counts) == before


def _sorted_rows(seed: int, f: int, k: int, ties: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = rng.uniform(-1.0, 3.0, f * k).astype(np.float32)
    if ties:
        t = np.round(t * 8) / 8  # many equal timestamps
    return np.sort(t).astype(np.float32).reshape(f, k)


@pytest.mark.parametrize("k", [1, 2, 3, 16, 1024, 1023])
@pytest.mark.parametrize("ties", [False, True])
def test_frame_mid_times_are_np_median(k, ties):
    """The middle timestamp, or the middle pair's mean, is `np.median` bit
    for bit on non-decreasing rows, with ties, zeros and NaN rows."""
    t = _sorted_rows(k, 40, k, ties)
    t[3] = 0.0
    t[4, : (k + 1) // 2] = -0.0
    t[4, (k + 1) // 2:] = 0.0
    t[5, -1] = np.nan
    t[6] = np.linspace(-1e-30, 1e-30, k, dtype=np.float32)
    got = t_agg._frame_mid_times(t)
    want = np.median(t, axis=1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.astype(np.float32).view(np.int32))


@pytest.fixture(scope="module")
def sequence():
    cam = CameraModel()
    traj = make_trajectory("simulation_3planes", 24, device="cpu")
    ev = simulate_events(cam, make_scene(SceneConfig(points_per_plane=80)), traj, device="cpu")
    return cam, ev, traj


def _fields(fr):
    return (fr.xy, fr.valid, fr.t_mid, fr.poses.R, fr.poses.t)


def _staged_on_cpu(ev, traj, e, keep_tail, policy="clamp"):
    staged = t_agg._stage(ev, traj, e, keep_tail, policy, pin_memory=False)
    return None if staged is None else t_agg._unstage(*staged)


@pytest.mark.parametrize("keep_tail", [True, False])
@pytest.mark.parametrize("cut", ["below_e", "multiple", "partial"])
def test_staged_frames_are_the_aggregators(sequence, cut, keep_tail):
    """The staged path's fields, unstaged on the CPU, are bitwise the
    aggregator's frames in all five fields: fewer events than a frame, a
    multiple of the frame size, a partial tail."""
    cam, ev, traj = sequence
    e = 256
    n = {"below_e": 200, "multiple": 20 * e, "partial": 20 * e + 77}[cut]
    part = EventStream(*(a[:n] for a in ev))
    want = t_agg.aggregate(cam, part, traj, e, keep_tail, pose_extrapolation="clamp",
                           device="cpu")
    got = _staged_on_cpu(part, traj, e, keep_tail)
    if want.xy.shape[0] == 0:
        assert got is None
        return
    for a, b in zip(_fields(got), _fields(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    assert got.xy.shape[0] == n // e + (keep_tail and n % e > 0)


def _warnings_of(fn) -> list[str]:
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        fn()
    return [str(w.message) for w in seen if issubclass(w.category, PoseExtrapolationWarning)]


def test_staged_path_keeps_the_span_policies(sequence):
    """Frames past the trajectory's span: "raise" refuses with the
    aggregator's message, "warn" gives its warnings (the full frames', then
    the tail's), "clamp" is silent."""
    cam, ev, traj = sequence
    short = Trajectory(traj.times[:-4], SE3(traj.poses.R[:-4], traj.poses.t[:-4]))
    e = 256
    with pytest.raises(PoseExtrapolationError) as want:
        t_agg.aggregate(cam, ev, short, e, pose_extrapolation="raise", device="cpu")
    with pytest.raises(PoseExtrapolationError) as got:
        _staged_on_cpu(ev, short, e, True, "raise")
    assert str(got.value) == str(want.value)
    want_w = _warnings_of(lambda: t_agg.aggregate(cam, ev, short, e, device="cpu"))
    got_w = _warnings_of(lambda: _staged_on_cpu(ev, short, e, True, "warn"))
    assert len(want_w) == 2 and got_w == want_w
    assert _warnings_of(lambda: _staged_on_cpu(ev, short, e, True, "clamp")) == []


def test_staged_path_rejects_misordered_events(sequence):
    cam, ev, traj = sequence
    t = ev.t.clone()
    t[500] = t[499] - 1e-3
    bad = ev._replace(t=t)
    with pytest.raises(NonMonotoneEventError) as want:
        t_agg.aggregate(cam, bad, traj, 256, device="cpu")
    with pytest.raises(NonMonotoneEventError) as got:
        _staged_on_cpu(bad, traj, 256, True)
    assert str(got.value) == str(want.value)


class _Ops(TorchDispatchMode):
    """Records the name of every dispatched operation that is not a view."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("keep_tail", [True, False])
def test_staged_frames_reach_the_device_by_one_copy_and_one_launch(sequence, keep_tail):
    """Traced on meta tensors, the device half of the staged path is one
    copy of the staging buffer and one `frame_poses` operation; the frames
    are views of the copy."""
    cam, ev, traj = sequence
    buf, fields = t_agg._stage(ev, traj, 1024, keep_tail, "clamp", pin_memory=False)
    with _Ops() as ops:
        fr = t_agg._unstage(buf.to("meta"), fields)
    assert ops.names == ["aten._to_copy.default", "repro_torch.frame_poses.default"]
    f = ev.t.shape[0] // 1024 + (keep_tail and ev.t.shape[0] % 1024 > 0)
    assert tuple(fr.xy.shape) == (f, 1024, 2) and fr.valid.dtype == torch.bool
    assert tuple(fr.poses.R.shape) == (f, 3, 3) and fr.xy.device.type == "meta"


def test_gated_aggregator_poses_through_the_wrapper(sequence):
    """A pose-gated aggregator on the CPU, fed the trajectory chunk by chunk,
    poses each release through the wrapper's CPU path: bitwise
    `pose_at_times` on the whole trajectory."""
    cam, ev, traj = sequence
    e = 256
    agg = t_agg.StreamingAggregator(cam, t_agg.TrajectoryBuffer(), e,
                                    pose_extrapolation="clamp", device="cpu")
    parts = []
    n_s, n_ev = traj.times.shape[0], ev.t.shape[0]
    for k in range(0, n_s, 5):
        parts.append(agg.push_poses(Trajectory(
            traj.times[k:k + 5], SE3(traj.poses.R[k:k + 5], traj.poses.t[k:k + 5]))))
        parts.append(agg.push(EventStream(*(a[k * n_ev // n_s:(k + 5) * n_ev // n_s]
                                            for a in ev))))
    parts += [agg.finalize_poses(), agg.flush()]
    got = t_agg.concat_event_frames(parts)
    assert got.t_mid.shape[0] == -(-n_ev // e)
    for a, b in zip(got.poses, pose_at_times(traj, got.t_mid)):
        assert torch.equal(_bits(a), _bits(b))


def test_aggregator_off_the_cpu_poses_by_one_kernel_op(sequence):
    """Off the CPU (traced on meta tensors) the streaming aggregator poses a
    push's frames by one `frame_poses` operation and none of the eager
    chain's. (A distorted camera, whose `aggregate` takes this path on the
    card, undistorts on the device and reads the result back, which meta
    tensors cannot; `tests/test_torch_cuda.py` holds it on the card.)"""
    cam, ev, traj = sequence
    agg = t_agg.StreamingAggregator(cam, traj, 256, pose_extrapolation="clamp",
                                    device="meta")
    with _Ops() as ops:
        fr = agg.push(ev)
    assert ops.names.count("repro_torch.frame_poses.default") == 1
    assert not any("searchsorted" in name for name in ops.names)
    assert tuple(fr.poses.R.shape) == (ev.t.shape[0] // 256, 3, 3)
    assert fr.poses.R.device.type == "meta"
