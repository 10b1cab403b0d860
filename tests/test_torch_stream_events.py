"""The port's streaming event side against the JAX reference, on the CPU.

The same numpy chunks go through both packages:

* `TrajectoryBuffer`: watermark, start time, coverage and every error
  (class and message) equal the reference's; translations interpolated
  from a prefix equal the reference's bitwise and the full trajectory's
  bitwise (prefix stability); rotations are the port's own sin/cos, held to
  POSE_ATOL (two float32 ulps at 1) against the reference's.
* The pose-gated `StreamingAggregator`: for every interleaving of the
  reference's `test_interleaving_invariance_bitwise`, the released frames
  equal the port's oracle `aggregate` bitwise (poses included), and the
  stall queue, watermark and pending events match the reference
  aggregator's after every chunk.
* Released poses do not depend on how many frames one release
  interpolates together (PyTorch's vectorised and scalar paths could differ
  in the last bit): one call, one frame at a time and random groups agree
  bitwise.
* `corrupt_stream` is bitwise the reference's for every mode; `StreamHygiene`
  under every mode x policy releases bitwise the reference's events, raises
  the same error class with the same message at the same chunk, and keeps
  the same counters.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.geometry import SE3 as JSE3
from repro.core.geometry import so3_exp as j_so3_exp
from repro.events import aggregation as j_agg
from repro.events import simulator as j_sim
from repro.events import stream_hygiene as j_hyg
from repro.events import trajectory_stream as j_ts
from repro_torch import interop
from repro_torch.core.geometry import SE3
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.events import stream_hygiene as t_hyg
from repro_torch.events import trajectory_stream as t_ts

POSE_ATOL = 2.5e-7
W, H = 32, 24  # synthetic sensor of the reference's hygiene unit tests


@pytest.fixture(scope="module")
def cams():
    cam = JCamera()
    return cam, interop.camera_from_dict(dataclasses.asdict(cam))


def _traj(n: int, t0: float = 0.0, t1: float = 1.0, seed: int = 0):
    """The reference tests' random trajectory, as numpy (R from the
    reference's so3_exp, shared by both packages)."""
    rng = np.random.default_rng(seed)
    times = np.linspace(t0, t1, n).astype(np.float32)
    w = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    R = np.array(j_so3_exp(w), np.float32)
    t = np.cumsum(rng.uniform(-0.05, 0.05, (n, 3)), axis=0).astype(np.float32)
    return times, R, t


def _j_traj(times, R, t, lo=0, hi=None):
    return j_sim.Trajectory(times=times[lo:hi], poses=JSE3(R[lo:hi], t[lo:hi]))


def _t_traj(times, R, t, lo=0, hi=None):
    return t_sim.Trajectory(torch.from_numpy(times[lo:hi]),
                            SE3(torch.from_numpy(R[lo:hi]), torch.from_numpy(t[lo:hi])))


def _events(n: int, t0: float = 0.0, t1: float = 1.0, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 200, (n, 2)).astype(np.float32),
            np.sort(rng.uniform(t0, t1, n).astype(np.float32)),
            rng.choice([-1, 1], n).astype(np.int8), np.ones(n, bool))


def _j_events(ev, lo=0, hi=None):
    return j_sim.EventStream(*(a[lo:hi] for a in ev))


def _t_events(ev, lo=0, hi=None):
    return t_sim.EventStream(*(torch.from_numpy(a[lo:hi]) for a in ev))


def _raises_alike(fn_ref, fn_port):
    """Both raise the same-named exception with the same message, or both
    return; returns the port's result."""
    try:
        fn_ref()
    except Exception as e:  # noqa: BLE001 - compared by name and message
        with pytest.raises(Exception) as got:
            fn_port()
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return None
    return fn_port()


# --- TrajectoryBuffer -------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_trajectory_buffer_matches_reference(seed):
    times, R, t = _traj(12, seed=seed)
    rng = np.random.default_rng(seed)
    cuts = [0, *sorted(rng.choice(np.arange(1, 12), 3, replace=False).tolist()), 12]
    jb, tb = j_ts.TrajectoryBuffer(), t_ts.TrajectoryBuffer()
    assert tb.watermark == jb.watermark == float("-inf")
    assert tb.start_time == jb.start_time == float("inf")
    tq = np.sort(rng.uniform(-0.1, 1.1, 40)).astype(np.float32)
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        assert tb.push(_t_traj(times, R, t, lo, hi)) == jb.push(_j_traj(times, R, t, lo, hi))
        assert (tb.num_samples, tb.watermark, tb.start_time) == (
            jb.num_samples, jb.watermark, jb.start_time)
        np.testing.assert_array_equal(tb.covers(tq), jb.covers(tq))
        np.testing.assert_array_equal(tb.times, jb.times)
        inside = tq[tb.covers(tq) & (tq < tb.watermark)]
        if inside.size:
            # prefix stability: strictly below the watermark, the prefix's
            # pose is the full trajectory's, bit for bit
            got = tb.pose_at_times(inside)
            full = t_ts.pose_at_times(_t_traj(times, R, t), torch.from_numpy(inside))
            assert torch.equal(got.t, full.t) and torch.equal(got.R, full.R)
    q = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    got, want = tb.pose_at_times(q), jb.pose_at_times(q)
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(want.t))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=POSE_ATOL)


@pytest.mark.parametrize("case", ["non_increasing", "overlap", "shape", "equal_start"])
def test_trajectory_buffer_rejects_like_reference(case):
    times, R, t = _traj(8)
    jb, tb = j_ts.TrajectoryBuffer(), t_ts.TrajectoryBuffer()
    jb.push(_j_traj(times, R, t, 0, 4))
    tb.push(_t_traj(times, R, t, 0, 4))
    if case == "non_increasing":
        bad = (times[4:][::-1].copy(), R[4:], t[4:])
    elif case == "overlap":
        bad = (times[2:6], R[2:6], t[2:6])
    elif case == "shape":
        bad = (times[4:], R[4:7], t[4:])
    else:
        bad = (times[3:5], R[3:5], t[3:5])
    _raises_alike(lambda: jb.push(j_sim.Trajectory(bad[0], JSE3(bad[1], bad[2]))),
                  lambda: tb.push(t_sim.Trajectory(torch.from_numpy(bad[0]),
                                                   SE3(torch.from_numpy(bad[1]),
                                                       torch.from_numpy(bad[2])))))
    assert tb.num_samples == jb.num_samples == 4  # the rejected chunk left no trace


def test_trajectory_buffer_query_errors_like_reference():
    times, R, t = _traj(6)
    jb, tb = j_ts.TrajectoryBuffer(), t_ts.TrajectoryBuffer()
    jb.push(_j_traj(times, R, t, 0, 1))
    tb.push(_t_traj(times, R, t, 0, 1))
    q = np.asarray([0.05], np.float32)
    _raises_alike(lambda: jb.pose_at_times(q), lambda: tb.pose_at_times(q))  # one sample
    jb.push(_j_traj(times, R, t, 1, 4))
    tb.push(_t_traj(times, R, t, 1, 4))
    past = np.asarray([0.3, 0.9], np.float32)
    with pytest.raises(t_ts.PoseExtrapolationError, match="watermark"):
        tb.pose_at_times(past)
    _raises_alike(lambda: jb.pose_at_times(past), lambda: tb.pose_at_times(past))


def test_trajectory_chunks_match_reference():
    times, R, t = _traj(11)
    want = list(j_sim.iter_trajectory_chunks(_j_traj(times, R, t), 4))
    got = list(t_sim.iter_trajectory_chunks(_t_traj(times, R, t), 4))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.times.numpy(), b.times)
        np.testing.assert_array_equal(a.poses.R.numpy(), b.poses.R)
    s = t_sim.slice_trajectory(_t_traj(times, R, t), 2, 5)
    np.testing.assert_array_equal(s.poses.t.numpy(), t[2:5])
    with pytest.raises(ValueError, match="chunk_poses"):
        next(t_sim.iter_trajectory_chunks(_t_traj(times, R, t), 0))


# --- the pose-gated aggregator ----------------------------------------------


def _frames_np(f) -> tuple:
    return tuple(np.asarray(a) for a in (f.xy, f.valid, f.t_mid, f.poses.R, f.poses.t))


def _concat(parts) -> tuple:
    parts = [_frames_np(p) for p in parts if p.xy.shape[0]]
    return tuple(np.concatenate(cols) for cols in zip(*parts))


@pytest.mark.parametrize("trial", range(4))
def test_interleavings_bitwise_and_stalls_match_reference(cams, trial):
    """The reference's `test_interleaving_invariance_bitwise` draws (rng 11,
    4 trials): the port's gated frames equal the port's oracle `aggregate`
    bitwise, and after every chunk the stall queue, watermark and pending
    events equal the reference aggregator's."""
    jcam, tcam = cams
    times, R, t = _traj(10, seed=4)
    ev = _events(120, seed=4)
    oracle = t_agg.aggregate(tcam, _t_events(ev), _t_traj(times, R, t), events_per_frame=16,
                             device="cpu")
    rng = np.random.default_rng(11)
    for _ in range(trial + 1):  # advance to this trial's draws
        ev_cuts = np.sort(rng.integers(0, 121, size=3)).tolist()
        pose_cuts = np.sort(rng.integers(0, 11, size=2)).tolist()
    ev_slices = list(zip([0] + ev_cuts, ev_cuts + [120]))
    pose_slices = list(zip([0] + pose_cuts, pose_cuts + [10]))
    ja = j_agg.StreamingAggregator(jcam, j_ts.TrajectoryBuffer(), events_per_frame=16)
    ta = t_agg.StreamingAggregator(tcam, t_ts.TrajectoryBuffer(), events_per_frame=16,
                                   device="cpu")

    def same_state():
        assert (ta.stalled_frames, ta.pose_watermark, ta.pending_events,
                ta.oldest_stalled_t) == (ja.stalled_frames, ja.pose_watermark,
                                         ja.pending_events, ja.oldest_stalled_t)

    parts = []
    while ev_slices or pose_slices:
        if ev_slices:
            lo, hi = ev_slices.pop(0)
            want = ja.push(_j_events(ev, lo, hi))
            parts.append(ta.push(_t_events(ev, lo, hi)))
            assert parts[-1].xy.shape[0] == want.xy.shape[0]
            same_state()
        if pose_slices:
            lo, hi = pose_slices.pop(0)
            want = ja.push_poses(_j_traj(times, R, t, lo, hi))
            parts.append(ta.push_poses(_t_traj(times, R, t, lo, hi)))
            assert parts[-1].xy.shape[0] == want.xy.shape[0]
            same_state()
    ja.flush()
    parts.append(ta.flush())
    same_state()
    ja.finalize_poses()
    parts.append(ta.finalize_poses())
    same_state()
    for got, want in zip(_concat(parts), _frames_np(oracle)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,steps", [("simulation_3planes", 24), ("simulation_3walls", 57),
                                        ("slider_far", 96)])
def test_released_poses_do_not_depend_on_batch_size(name, steps):
    """A release interpolates a group of stalled frames in one call: each
    frame's pose must be the bits it gets alone or in any other group."""
    traj = t_sim.make_trajectory(name, steps, device="cpu")
    rng = np.random.default_rng(steps)
    tq = np.sort(rng.uniform(0, 1, 203)).astype(np.float32)
    full = t_ts.pose_at_times(traj, torch.from_numpy(tq))
    alone = [t_ts.pose_at_times(traj, torch.from_numpy(tq[i:i + 1])) for i in range(tq.size)]
    assert torch.equal(torch.cat([p.R for p in alone]), full.R)
    assert torch.equal(torch.cat([p.t for p in alone]), full.t)
    for _ in range(8):
        cuts = np.unique(np.r_[0, rng.integers(1, tq.size, rng.integers(1, 9)), tq.size])
        got = [t_ts.pose_at_times(traj, torch.from_numpy(tq[lo:hi]))
               for lo, hi in zip(cuts[:-1], cuts[1:])]
        assert torch.equal(torch.cat([p.R for p in got]), full.R)
        assert torch.equal(torch.cat([p.t for p in got]), full.t)


def test_max_stalled_raises_and_recovers_like_reference(cams):
    jcam, tcam = cams
    times, R, t = _traj(10, seed=2)
    ev = _events(160, seed=2)
    ja = j_agg.StreamingAggregator(jcam, j_ts.TrajectoryBuffer(), events_per_frame=16,
                                   max_stalled=3)
    ta = t_agg.StreamingAggregator(tcam, t_ts.TrajectoryBuffer(), events_per_frame=16,
                                   max_stalled=3, device="cpu")
    _raises_alike(lambda: ja.push(_j_events(ev, 0, 100)), lambda: ta.push(_t_events(ev, 0, 100)))
    assert ta.stalled_frames == ja.stalled_frames == 6  # buffered, not lost
    ja.push_poses(_j_traj(times, R, t))
    released = ta.push_poses(_t_traj(times, R, t))
    assert released.xy.shape[0] == 6 - ja.stalled_frames
    oracle = t_agg.aggregate(tcam, _t_events(ev, 0, 96), _t_traj(times, R, t),
                             events_per_frame=16, device="cpu")
    for got, want in zip(_frames_np(released), _frames_np(oracle)):
        np.testing.assert_array_equal(got, want[:got.shape[0]])


def test_gated_edge_errors_match_reference(cams):
    jcam, tcam = cams
    times, R, t = _traj(6, t1=0.5)
    ev = _events(32, t1=1.0, seed=5)
    # finalize with frames past the last pose: warn-clamp, or raise
    for policy in ("warn", "raise"):
        ja = j_agg.StreamingAggregator(jcam, j_ts.TrajectoryBuffer(), events_per_frame=8,
                                       pose_extrapolation=policy)
        ta = t_agg.StreamingAggregator(tcam, t_ts.TrajectoryBuffer(), events_per_frame=8,
                                       pose_extrapolation=policy, device="cpu")
        for a, e, tr in ((ja, _j_events(ev), _j_traj(times, R, t)),
                         (ta, _t_events(ev), _t_traj(times, R, t))):
            a.push(e)
            a.push_poses(tr)
        assert ta.stalled_frames == ja.stalled_frames > 0
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            out = _raises_alike(ja.finalize_poses, ta.finalize_poses)
        if policy == "warn":
            ref = t_agg.aggregate(tcam, _t_events(ev), _t_traj(times, R, t), events_per_frame=8,
                                  pose_extrapolation="clamp", device="cpu")
            assert torch.equal(out.poses.t[-1], ref.poses.t[-1])
    # finalize before two samples; pose calls on an oracle aggregator
    ja = j_agg.StreamingAggregator(jcam, j_ts.TrajectoryBuffer(), events_per_frame=8)
    ta = t_agg.StreamingAggregator(tcam, t_ts.TrajectoryBuffer(), events_per_frame=8,
                                   device="cpu")
    ja.push(_j_events(ev, 0, 16))
    ta.push(_t_events(ev, 0, 16))
    _raises_alike(ja.finalize_poses, ta.finalize_poses)
    jo = j_agg.StreamingAggregator(jcam, _j_traj(times, R, t), events_per_frame=8)
    to = t_agg.StreamingAggregator(tcam, _t_traj(times, R, t), events_per_frame=8, device="cpu")
    _raises_alike(lambda: jo.push_poses(_j_traj(times, R, t)),
                  lambda: to.push_poses(_t_traj(times, R, t)))
    _raises_alike(jo.finalize_poses, to.finalize_poses)
    _raises_alike(lambda: j_agg.StreamingAggregator(jcam, _j_traj(times, R, t), max_stalled=2),
                  lambda: t_agg.StreamingAggregator(tcam, _t_traj(times, R, t), max_stalled=2,
                                                    device="cpu"))


# --- fault injection and ingest hygiene ------------------------------------


def _clean_stream(seed: int = 7, n: int = 400):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 1, n)).astype(np.float32)
    xy = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], 1).astype(np.float32)
    return xy, t, np.ones(n, np.int8), np.ones(n, bool)


@pytest.mark.parametrize("mode", j_sim.EVENT_CORRUPTIONS)
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_corrupt_stream_matches_reference(mode, seed):
    ev = _clean_stream(seed)
    want = j_sim.corrupt_stream(_j_events(ev), mode, 64, seed=seed, width=W, height=H, burst=40)
    got = t_sim.corrupt_stream(_t_events(ev), mode, 64, seed=seed, width=W, height=H, burst=40)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert isinstance(x, torch.Tensor)
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
            assert x.numpy().dtype == np.asarray(y).dtype


HYGIENE_CONFIGS = {
    "raise": dict(policy="raise", hot_pixel_limit=12),
    "drop": dict(policy="drop", hot_pixel_limit=12),
    "reorder": dict(policy="reorder", reorder_slack=0.8, hot_pixel_limit=12),
    "off": dict(policy="off"),
}


def _t_chunk(c) -> t_sim.EventStream:
    return t_sim.EventStream(*(torch.from_numpy(np.asarray(a)) for a in c))


@pytest.mark.parametrize("policy", sorted(HYGIENE_CONFIGS))
@pytest.mark.parametrize("mode", j_sim.EVENT_CORRUPTIONS)
def test_stream_hygiene_matches_reference(mode, policy):
    """Every corruption under every policy: each chunk's released events are
    bitwise the reference's, an offense raises the same error class with
    the same message at the same chunk (the guard then goes on with the
    next chunk), and the watermark and counters agree throughout."""
    ev = _clean_stream()
    chunks = j_sim.corrupt_stream(_j_events(ev), mode, 64, seed=5, width=W, height=H, burst=40)
    jh = j_hyg.StreamHygiene(j_hyg.HygieneConfig(**HYGIENE_CONFIGS[policy]), width=W, height=H)
    th = t_hyg.StreamHygiene(t_hyg.HygieneConfig(**HYGIENE_CONFIGS[policy]), width=W, height=H)
    raised = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for c in chunks:
            try:
                want = jh.scrub(c)
            except j_hyg.StreamHygieneError as e:
                raised += 1
                with pytest.raises(t_hyg.StreamHygieneError) as got:
                    th.scrub(_t_chunk(c))
                assert type(got.value).__name__ == type(e).__name__
                assert str(got.value) == str(e)
                continue
            out = th.scrub(_t_chunk(c))
            for x, y in zip(out, want):
                assert isinstance(x, np.ndarray) and x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
            assert th.watermark == jh.watermark
            assert th.stats == jh.stats
        for x, y in zip(th.flush(), jh.flush()):
            np.testing.assert_array_equal(x, y)
    assert th.stats == jh.stats
    if policy == "off" or (policy == "drop"):
        assert raised == 0  # "drop" sheds, "off" trusts: neither raises


def test_hygiene_config_and_monotone_check_like_reference():
    for bad in (dict(policy="shrug"), dict(reorder_slack=-1.0), dict(hot_pixel_limit=0),
                dict(hot_pixel_window=0.0), dict(duplicate_history=0)):
        _raises_alike(lambda: j_hyg.HygieneConfig(**bad), lambda: t_hyg.HygieneConfig(**bad))
    assert t_hyg.HYGIENE_POLICIES == j_hyg.HYGIENE_POLICIES
    for t, last in (([0.1, 0.3, 0.2], -1.0), ([0.1, 0.2], 0.5), ([0.1, 0.1], 0.1)):
        t = np.asarray(t, np.float32)
        _raises_alike(lambda: j_hyg.check_chunk_monotone(t, last),
                      lambda: t_hyg.check_chunk_monotone(t, last))
    empty = t_hyg.empty_event_stream()
    for x, y in zip(empty, j_hyg.empty_event_stream()):
        assert x.dtype == y.dtype and x.shape == y.shape


@pytest.mark.parametrize("name,steps", [("simulation_3planes", 24), ("simulation_3walls", 57),
                                        ("slider_far", 96)])
def test_pose_interpolator_is_bitwise_pose_at_times(name, steps):
    """The oracle's host interpolator (one interval log per trajectory
    interval, each query's arithmetic on host arrays) gives the bits of
    `pose_at_times`, one query at a time and in any batch, out-of-span
    queries clamped and sample times hit exactly."""
    traj = t_sim.make_trajectory(name, steps, device="cpu")
    interp = t_ts.PoseInterpolator(traj)
    rng = np.random.default_rng(steps)
    times = traj.times.numpy()
    tq = np.sort(np.concatenate([rng.uniform(-0.05, 1.05, 150).astype(np.float32),
                                 times[::7]])).astype(np.float32)
    full = t_ts.pose_at_times(traj, torch.from_numpy(tq))
    got = interp(tq)
    assert torch.equal(got.R, full.R) and torch.equal(got.t, full.t)
    for i in range(tq.size):
        one = interp(tq[i:i + 1])
        assert torch.equal(one.R, full.R[i:i + 1]) and torch.equal(one.t, full.t[i:i + 1])


class _OpCount(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten operations dispatched (metadata reads excluded) and
    the copies among them (`_to_copy`, `copy_`)."""

    def __init__(self):
        super().__init__()
        self.ops = 0
        self.copies = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace != "prim":
            self.ops += 1
            self.copies += func.overloadpacket.__name__ in ("_to_copy", "copy_", "copy")
        return func(*args, **(kwargs or {}))


# aten operations one StreamSession.push of one 1024-event frame may
# dispatch (sweeps excluded): 50 with the oracle's host interpolator; the
# per-frame pose_at_times it replaced dispatched 158
INGEST_OPS_PER_PUSH = 50


def test_ingest_per_push_is_pinned():
    """Host ingest per push (fault C3): with the sweeps stubbed out, each
    push of one frame dispatches at most INGEST_OPS_PER_PUSH aten
    operations on the session's CPU tensors and copies nothing."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import EMVSOptions
    from repro_torch.serving.emvs_stream import EMVSStreamEngine, StreamConfig, iter_event_chunks

    cam = CameraModel()
    traj = t_sim.make_trajectory("simulation_3planes", 48, device="cpu")
    scene = t_sim.make_scene(t_sim.SceneConfig(name="simulation_3planes", points_per_plane=150))
    ev = t_sim.simulate_events(cam, scene, traj, noise_fraction=0.02, seed=0, device="cpu")
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True,
                       keyframe_dist_frac=0.05)
    engine = EMVSStreamEngine(cam, dsi_cfg, traj, opts, StreamConfig(events_per_frame=1024),
                              device="cpu")
    dispatched = []
    engine._dispatcher._dispatch = lambda group, cap: dispatched.append(len(group))
    counts = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for chunk in iter_event_chunks(ev, 1024):
            mode = _OpCount()
            with mode:
                engine.push(chunk)
            counts.append((mode.ops, mode.copies))
    assert len(counts) >= 20 and dispatched  # segments closed along the way
    assert max(ops for ops, _ in counts) <= INGEST_OPS_PER_PUSH
    assert all(copies == 0 for _, copies in counts)
