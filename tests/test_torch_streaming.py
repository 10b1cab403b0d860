"""The port's streaming EMVS engine against the JAX reference, on the CPU.

Events and the trajectory come from the reference's simulator as numpy.
The offline yardstick is the reference's `run_emvs` (its matmul
formulation, which its own tests hold bitwise to its fused kernel) on the
port's host-aggregated frames as numpy: the two packages' sin/cos differ in
the last bits of a rotation, and the streaming session aggregates on the
host, so the frames must be the port's. Against it the port's engine must
give bitwise the same frame ranges, dsi, depth and mask on nearest voting,
float and Table-1 quantized, kernel (on the CPU, its kernels' plain
versions) and matmul formulations, for the reference's chunkings (224,
997, whole), every dispatch policy and every pose-lag profile; bilinear
voting within the reference's own tolerances
(`tests/test_segment_batching.py::_assert_results_match`). N sessions on
one `MultiStreamEngine` are held the same way in `test_torch_dispatch.py`,
with the helpers of this file.

Every stats counter must equal the reference engine's on the same chunks
(the latency histograms by their counts). Those counters depend only on
how the engine forms, dispatches and completes groups, never on what a
sweep computes. So the reference engine runs here with its sweep replaced
by one that returns zeros of the right shapes at once: on the CPU a port
sweep is complete when it returns, and the reference's is then too (its
JAX sweeps are asynchronous, so its adaptive policy would otherwise read a
timing-dependent in-flight depth), and no sweep program is compiled for
a run whose numbers are not compared. Its aggregator's pose interpolation
runs compiled for speed; the segments it closes must still match the
port's exactly, or the counters differ.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.geometry import SE3 as JSE3
from repro.core.pipeline import EMVSOptions as JOptions
from repro.core.pipeline import run_emvs as j_run_emvs
from repro.events import aggregation as j_agg
from repro.events import simulator as j_sim
from repro.events import trajectory_stream as j_ts
from repro.events.aggregation import EventFrames as JEventFrames
from repro.serving import emvs_stream as j_stream
from repro.serving import stream_session as j_sess
from repro.serving import sweep_dispatcher as j_disp
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.core.geometry import SE3
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.events.stream_hygiene import (
    DuplicateChunkError,
    HotPixelError,
    NonMonotoneEventError,
    OutOfBoundsEventError,
    StreamOverlapError,
)
from repro_torch.events.trajectory_stream import PoseStallError, TrajectoryBuffer
from repro_torch.profiling import AffineCostModel, NullCostModel, SweepProfiler, VariantKey
from repro_torch.serving import emvs_stream as t_stream
from repro_torch.serving import stream_session as t_sess
from repro_torch.serving import sweep_dispatcher as t_disp

EVENTS_PER_FRAME = 224  # does not divide the streams: exercises the tail
POLICIES = ("latency", "throughput", "adaptive")
POSE_PROFILES = ("ahead", "tracking", "behind")
SCHEDULES = ("balanced", "bursty", "starved")
KEYFRAME_FRAC = 0.03


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread leaves the other cores to the
    test workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(ev, keep):
    return tuple(a[:keep] for a in ev)


@pytest.fixture(scope="module")
def scene():
    """The reference tests' small scene: 3 planes of 150 points, a 24-step
    arc, no noise; 17 full 224-event frames and a tail, 16 planes."""
    jcam = JCamera()
    traj = j_sim.make_trajectory("simulation_3planes", 24)
    ev = j_sim.simulate_events(jcam, j_sim.make_scene(j_sim.SceneConfig(points_per_plane=150)),
                               traj, noise_fraction=0.0)
    ev = tuple(np.array(a) for a in ev)
    traj = (np.array(traj.times), np.array(traj.poses.R), np.array(traj.poses.t))
    cam = interop.camera_from_dict(dataclasses.asdict(jcam))
    jcfg = JDSIConfig.for_camera(jcam, num_planes=16, z_min=0.6, z_max=4.5)
    cfg = interop.dsi_config_from_dict(dataclasses.asdict(jcfg))
    return {"jcam": jcam, "cam": cam, "traj": traj, "ev": ev, "jcfg": jcfg, "cfg": cfg,
            "main": _cut(ev, 17 * EVENTS_PER_FRAME + 32), "refs": {}}


def _t_traj(traj, lo=0, hi=None) -> t_sim.Trajectory:
    times, R, t = traj
    return t_sim.Trajectory(torch.from_numpy(times[lo:hi]),
                            SE3(torch.from_numpy(R[lo:hi]), torch.from_numpy(t[lo:hi])))


def _j_traj(traj, lo=0, hi=None) -> j_sim.Trajectory:
    times, R, t = traj
    return j_sim.Trajectory(times[lo:hi], JSE3(R[lo:hi], t[lo:hi]))


def _chunks(ev, n: int, torch_chunks: bool = True):
    for lo in range(0, ev[1].shape[0], n):
        c = tuple(a[lo:lo + n] for a in ev)
        yield (t_sim.EventStream(*(torch.from_numpy(a) for a in c)) if torch_chunks
               else t_sim.EventStream(*c))


def _j_chunks(ev, n: int):
    for lo in range(0, ev[1].shape[0], n):
        yield j_sim.EventStream(*(a[lo:lo + n] for a in ev))


def _opts(mod, formulation="kernel", quantized=True, voting="nearest"):
    return mod.EMVSOptions(formulation=formulation, voting=voting, quantized=quantized,
                           keyframe_dist_frac=KEYFRAME_FRAC)


def _reference(scene, ev, quantized=True, voting="nearest"):
    """The reference's `run_emvs` on the port's host-aggregated frames."""
    key = (ev[1].shape[0], quantized, voting)
    if key not in scene["refs"]:
        frames = t_agg.aggregate(scene["cam"], t_sim.EventStream(*map(torch.from_numpy, ev)),
                                 _t_traj(scene["traj"]), events_per_frame=EVENTS_PER_FRAME,
                                 device="cpu")
        jframes = JEventFrames(frames.xy.numpy(), frames.valid.numpy(), frames.t_mid.numpy(),
                               JSE3(frames.poses.R.numpy(), frames.poses.t.numpy()))
        formulation = "matmul" if voting == "nearest" else "scatter"
        scene["refs"][key] = j_run_emvs(scene["jcam"], scene["jcfg"], jframes,
                                        JOptions(formulation=formulation, voting=voting,
                                                 quantized=quantized,
                                                 keyframe_dist_frac=KEYFRAME_FRAC))
    ref = scene["refs"][key]
    assert len(ref.segments) >= 2, "the scene must close several segments"
    return ref


def _assert_bitwise(res, ref):
    assert [s.frame_range for s in res.segments] == [s.frame_range for s in ref.segments]
    assert len(res.clouds) == len(res.segments)
    for a, b in zip(res.segments, ref.segments):
        assert a.dsi.device.type == "cpu"
        np.testing.assert_array_equal(a.dsi.numpy(), np.asarray(b.dsi))
        np.testing.assert_array_equal(a.depth_map.depth.numpy(), np.asarray(b.depth_map.depth))
        np.testing.assert_array_equal(a.depth_map.mask.numpy(), np.asarray(b.depth_map.mask))
    for a, b in zip(res.clouds, ref.clouds):
        np.testing.assert_array_equal(a.valid.numpy(), np.asarray(b.valid))


def _assert_close(res, ref):
    """The reference's bilinear tolerances (`_assert_results_match` with
    exact_dsi=False): dsi atol 1e-4, mask bitwise, depth on the mask and
    reference translations exactly within 1e-5 and 0."""
    assert [s.frame_range for s in res.segments] == [s.frame_range for s in ref.segments]
    for a, b in zip(res.segments, ref.segments):
        np.testing.assert_allclose(a.dsi.numpy(), np.asarray(b.dsi, np.float32), atol=1e-4)
        m = a.depth_map.mask.numpy()
        np.testing.assert_array_equal(m, np.asarray(b.depth_map.mask))
        np.testing.assert_allclose(a.depth_map.depth.numpy()[m],
                                   np.asarray(b.depth_map.depth)[m], atol=1e-5)
        np.testing.assert_allclose(a.T_w_ref.t.numpy(), np.asarray(b.T_w_ref.t), atol=0)


@contextlib.contextmanager
def _reference_sweeps_stubbed():
    """The reference engine for a comparison of counters, not numbers: its
    sweep returns zeros at once, and its aggregator interpolates poses with
    its own `pose_at_times` compiled (translations, which alone place the
    segments, are bitwise the port's either way)."""
    from repro.core.detection import DepthMap as JDepthMap
    from repro.core.pointcloud import PointCloud as JPointCloud

    def sweep(cam, dsi_cfg, batch, opts):
        s = batch.xy.shape[0]
        z = jnp.zeros((s, dsi_cfg.height, dsi_cfg.width), jnp.float32)
        return (jnp.zeros((s, *dsi_cfg.shape), jnp.int32),
                JDepthMap(z, z > 0, z))

    def points(cam, dms, T_w_refs):
        s, h, w = dms.depth.shape
        z = jnp.zeros((s, h * w), jnp.float32)
        return JPointCloud(jnp.zeros((s, h * w, 3), jnp.float32), z, z > 0)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_disp, "process_segments_batched", sweep)
        mp.setattr(j_disp, "depth_maps_to_points", points)
        mp.setattr(j_agg, "pose_at_times", _jitted_pose_at_times)
        yield


# the reference's own pose interpolation, compiled once per shape instead of
# dispatched op by op on every push (a fifth of a second a push on the CPU)
_jitted_pose_at_times = jax.jit(j_ts.pose_at_times, static_argnames=("strict",))


def _assert_stats_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        if key in ("queue_wait_s", "sweep_time_s"):
            assert got[key]["count"] == value["count"], key
            assert sum(got[key]["bins"]) == got[key]["count"], key
            assert got[key]["bin_edges_s"] == value["bin_edges_s"], key
            assert abs(got[key]["total_s"] - (got[key]["t_out_sum"] - got[key]["t_in_sum"])) < 1e-6
        else:
            assert got[key] == value, key


def _drive(engine, scene, ev, chunk, profile=None, jax_side=False, lag=0.06):
    """Feed `ev` in chunks; with a pose-lag `profile` the engine is
    pose-gated and gets its trajectory in chunks ("ahead": all before the
    events, "tracking": trailing the event front by `lag`, "behind": all
    after). Returns the flushed result."""
    times = scene["traj"][0]
    sent = 0
    slicer = _j_traj if jax_side else _t_traj

    def send_up_to(hi):
        nonlocal sent
        if hi > sent:
            engine.push_poses(slicer(scene["traj"], sent, hi))
            sent = hi

    if profile == "ahead":
        send_up_to(times.shape[0])
    for c in (_j_chunks(ev, chunk) if jax_side else _chunks(ev, chunk)):
        engine.push(c)
        if profile == "tracking":
            send_up_to(int(np.searchsorted(times, float(np.asarray(c.t)[-1]) - lag,
                                           side="right")))
    if profile is not None:
        send_up_to(times.shape[0])
        engine.finalize_poses()
    return engine.flush()


def _reference_stats(scene, policy, chunk, profile=None, ev=None, **cfg):
    """The reference engine's stats on the same chunks (cached)."""
    ev = scene["main"] if ev is None else ev
    key = ("stats", policy, chunk, profile, ev[1].shape[0], tuple(sorted(cfg.items())))
    if key not in scene["refs"]:
        with _reference_sweeps_stubbed(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            engine = j_stream.EMVSStreamEngine(
                scene["jcam"], scene["jcfg"], None if profile else _j_traj(scene["traj"]),
                _opts(j_stream, formulation="matmul"),
                j_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME,
                                      dispatch_policy=policy, **cfg))
            _drive(engine, scene, ev, chunk, profile, jax_side=True)
        scene["refs"][key] = engine.stats
    return scene["refs"][key]


def _engine(scene, profile=None, opts=None, cost_model=None, profiler=None, **cfg):
    return t_stream.EMVSStreamEngine(
        scene["cam"], scene["cfg"], None if profile else _t_traj(scene["traj"]),
        opts or _opts(tp), t_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME, **cfg),
        cost_model=cost_model, profiler=profiler, device="cpu")


# --- the headline grid --------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("formulation", ["kernel", "matmul"])
@pytest.mark.parametrize("quantized", [False, True])
def test_stream_matches_reference(scene, quantized, formulation, policy):
    """Chunkings 224 (one frame), 997 (prime) and the whole stream: results
    bitwise the reference's offline `run_emvs`, stats the reference
    engine's."""
    ev = scene["main"]
    ref = _reference(scene, ev, quantized)
    for chunk in (EVENTS_PER_FRAME, 997, ev[1].shape[0]):
        engine = _engine(scene, opts=_opts(tp, formulation, quantized), dispatch_policy=policy)
        _assert_bitwise(_drive(engine, scene, ev, chunk), ref)
        _assert_stats_equal(engine.stats, _reference_stats(scene, policy, chunk))
        assert engine.stats["frames"] == engine.planner.num_frames
        assert engine.stats["pending_segments"] == 0


@pytest.mark.parametrize("profile", POSE_PROFILES)
def test_pose_streamed_matches_reference(scene, profile):
    """Poses in chunks far ahead of, trailing, and entirely after the
    events, for every chunking: results bitwise, stats the reference's."""
    ev = scene["main"]
    ref = _reference(scene, ev)
    for chunk in (EVENTS_PER_FRAME, 997, ev[1].shape[0]):
        engine = _engine(scene, profile)
        _assert_bitwise(_drive(engine, scene, ev, chunk, profile), ref)
        _assert_stats_equal(engine.stats, _reference_stats(scene, "adaptive", chunk, profile))
        assert engine.stats["stalled_frames"] == 0
        assert engine.stats["pose_watermark"] == float(scene["traj"][0][-1])
        if profile == "behind":
            assert engine.stats["max_stalled"] >= engine.stats["frames"] - 1


def test_flush_with_missing_poses_raises_and_recovers(scene):
    ev = scene["main"]
    engine = _engine(scene, "tracking")
    for c in _chunks(ev, 997):
        engine.push(c)
    n_frames = engine.stats["frames"] + engine.aggregator.stalled_frames
    with pytest.raises(PoseStallError) as err:
        engine.flush()
    assert f"{n_frames + 1} frame(s)" in str(err.value) and "watermark" in str(err.value)
    with pytest.raises(RuntimeError, match="tail was already emitted"):
        engine.push(next(_chunks(ev, 64)))
    engine.push_poses(_t_traj(scene["traj"]))
    engine.finalize_poses()
    _assert_bitwise(engine.flush(), _reference(scene, ev))


def test_one_pose_chunk_closes_several_segments(scene):
    ev = scene["main"]
    engine = _engine(scene, "behind")
    for c in _chunks(ev, EVENTS_PER_FRAME):
        engine.push(c)
    assert engine.stats["dispatches"] == 0, "nothing can dispatch unposed"
    engine.push_poses(_t_traj(scene["traj"]))
    assert engine.stats["segments"] >= 2
    assert engine._store.base == engine.planner.open_start <= engine._store.end
    engine.finalize_poses()
    _assert_bitwise(engine.flush(), _reference(scene, ev))


@pytest.mark.parametrize("policy", POLICIES)
def test_bilinear_within_reference_tolerance(scene, policy):
    ev = scene["main"]
    ref = _reference(scene, ev, quantized=False, voting="bilinear")
    engine = _engine(scene, opts=_opts(tp, "scatter", False, "bilinear"), dispatch_policy=policy)
    _assert_close(_drive(engine, scene, ev, ev[1].shape[0]), ref)


# --- memory budget --------------------------------------------------------------


def _budget(scene, ev, extra_frames=0):
    """The largest segment's working set plus the frame that closes it."""
    fb = (EVENTS_PER_FRAME * 2 * 4) + EVENTS_PER_FRAME + 4 + 9 * 4 + 3 * 4
    max_seg = max(b - a for a, b in (s.frame_range for s in _reference(scene, ev).segments))
    return (max_seg + 1 + extra_frames) * fb, fb


@pytest.mark.parametrize("policy,chunk,extra", [("stall", None, 0), ("reject", EVENTS_PER_FRAME, 0),
                                                ("stall", 997, 3), ("reject", 997, 2)])
def test_memory_budget_matches_reference(scene, policy, chunk, extra):
    """The store never holds more than the budget, results stay bitwise and
    the admission counters equal the reference engine's."""
    ev = scene["main"]
    budget, _ = _budget(scene, ev, extra)
    chunk = chunk or ev[1].shape[0]
    cfg = dict(frame_store_budget_bytes=budget, budget_policy=policy)

    def run(engine, chunks):
        for c in chunks:
            for attempt in range(200):
                try:
                    engine.poll() if attempt else engine.push(c)
                    break
                except (t_sess.MemoryBudgetError, j_sess.MemoryBudgetError):
                    assert policy == "reject" and engine.stats["backlog_frames"] >= 1
            assert engine.stats["frame_store_bytes"] <= budget
        return engine.flush()

    engine = _engine(scene, **cfg)
    _assert_bitwise(run(engine, _chunks(ev, chunk)), _reference(scene, ev))
    assert engine.stats["frame_store_peak_bytes"] <= budget
    assert engine.stats["backlog_frames"] == 0
    with _reference_sweeps_stubbed():
        jengine = j_stream.EMVSStreamEngine(
            scene["jcam"], scene["jcfg"], _j_traj(scene["traj"]),
            _opts(j_stream, formulation="matmul"),
            j_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME, **cfg))
        run(jengine, _j_chunks(ev, chunk))
    _assert_stats_equal(engine.stats, jengine.stats)
    if policy == "stall" and chunk == ev[1].shape[0]:
        assert engine.stats["budget_stalls"] >= 1, "the budget must have bitten"


@pytest.mark.parametrize("policy,match", [("stall", "working set"), ("reject", "reject")])
def test_infeasible_budget_raises(scene, policy, match):
    ev = scene["main"]
    _, fb = _budget(scene, ev)
    engine = _engine(scene, frame_store_budget_bytes=3 * fb, budget_policy=policy)
    with pytest.raises(t_sess.MemoryBudgetError, match=match):
        for c in _chunks(ev, EVENTS_PER_FRAME):
            engine.push(c)
        engine.flush()


def test_frame_store_bytes_match_reference(scene):
    """Host numpy frames: live and peak bytes equal the reference store's,
    frame for frame, so a budget trips at the same frame."""
    frames = t_agg.aggregate(scene["cam"], t_sim.EventStream(*map(torch.from_numpy,
                                                                  scene["main"])),
                             _t_traj(scene["traj"]), events_per_frame=EVENTS_PER_FRAME,
                             device="cpu")
    jframes = JEventFrames(frames.xy.numpy(), frames.valid.numpy(), frames.t_mid.numpy(),
                           JSE3(frames.poses.R.numpy(), frames.poses.t.numpy()))
    ts, js = t_sess._FrameStore(), j_sess._FrameStore()
    ts.extend(frames)
    js.extend(jframes)
    assert (ts.live_bytes, ts.peak_bytes, ts.end) == (js.live_bytes, js.peak_bytes, js.end)
    ts.evict_before(5)
    js.evict_before(5)
    assert (ts.live_bytes, ts.peak_bytes, ts.base) == (js.live_bytes, js.peak_bytes, js.base)
    win = ts.window(6, 9)
    assert isinstance(win.xy, np.ndarray) and win.valid.dtype == bool
    np.testing.assert_array_equal(win.poses.R, js.window(6, 9).poses.R)
    for lo, hi in ((4, 6), (6, 99), (7, 7)):
        with pytest.raises(IndexError):
            ts.window(lo, hi)


# --- ingest hygiene through the engine -----------------------------------------

ENGINE_EXPECT = {
    "shuffle_events": {"raise": NonMonotoneEventError, "drop": "survives", "reorder": "bitwise"},
    "swap_chunks": {"raise": StreamOverlapError, "drop": "survives", "reorder": "bitwise"},
    "duplicate_chunk": {"raise": DuplicateChunkError, "drop": "bitwise",
                        "reorder": DuplicateChunkError},
    "out_of_bounds": {"raise": OutOfBoundsEventError, "drop": "bitwise",
                      "reorder": OutOfBoundsEventError},
    "hot_pixel": {"raise": HotPixelError, "drop": "survives", "reorder": HotPixelError},
}


@pytest.mark.parametrize("mode", sorted(ENGINE_EXPECT))
def test_engine_hygiene_grid(scene, mode):
    """Each corruption under each policy: a typed rejection, results bitwise
    the clean stream's, or a flush that completes with offenders shed — and
    the hygiene counters equal the reference guard's on the same chunks."""
    from repro_torch.events.stream_hygiene import HygieneConfig

    ev = _cut(scene["ev"], 11 * EVENTS_PER_FRAME + 32)
    ref = _reference(scene, ev)
    cam = scene["cam"]
    chunks = t_sim.corrupt_stream(t_sim.EventStream(*map(torch.from_numpy, ev)), mode,
                                  EVENTS_PER_FRAME, seed=3, width=cam.width,
                                  height=cam.height, burst=96)
    for policy, expect in ENGINE_EXPECT[mode].items():
        hyg = HygieneConfig(policy=policy, reorder_slack=0.1, hot_pixel_limit=32)
        engine = _engine(scene, hygiene=hyg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if isinstance(expect, type):
                with pytest.raises(expect):
                    for c in chunks:
                        engine.push(c)
                continue
            for c in chunks:
                engine.push(c)
            res = engine.flush()
        if expect == "bitwise":
            _assert_bitwise(res, ref)
        else:
            assert len(res.segments) >= 1
        from repro.events.stream_hygiene import HygieneConfig as JHygieneConfig
        from repro.events.stream_hygiene import StreamHygiene as JStreamHygiene

        jh = JStreamHygiene(JHygieneConfig(policy=policy, reorder_slack=0.1, hot_pixel_limit=32),
                            width=cam.width, height=cam.height)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for c in chunks:
                jh.scrub(j_sim.EventStream(*(a.numpy() for a in c)))
            jh.flush()
        assert engine.stats["hygiene"] == jh.stats


def test_numpy_and_tensor_chunks_agree(scene):
    """A session copies each chunk to the host once; numpy chunks and tensor
    chunks give the same results and counters."""
    ev = scene["main"]
    a, b = _engine(scene), _engine(scene)
    for c in _chunks(ev, 997, torch_chunks=False):
        a.push(c)
    for c in _chunks(ev, 997):
        b.push(c)
    ra, rb = a.flush(), b.flush()
    for x, y in zip(ra.segments, rb.segments):
        assert torch.equal(x.dsi, y.dsi)
    _assert_stats_equal(a.stats, b.stats)


def test_input_validation_like_reference(scene):
    ev = scene["main"]
    engine = _engine(scene)
    bad = t_sim.EventStream(*(torch.from_numpy(a[:n]) for a, n in zip(ev, (5, 7, 7, 6))))
    with pytest.raises(ValueError, match=r"t has 7 event\(s\) but.*valid has 6.*xy has 5"):
        engine.push(bad)
    assert engine.stats["chunks"] == engine.stats["frames"] == 0
    engine.push(t_sim.EventStream(*(torch.from_numpy(a[:0]) for a in ev)))
    assert (engine.stats["chunks"], engine.stats["empty_chunks"]) == (1, 1)
    for bad_n in (0, -3, 2.5, "64", None, True):
        with pytest.raises(ValueError, match="chunk_events"):
            next(t_stream.iter_event_chunks(t_sim.EventStream(*map(torch.from_numpy, ev)), bad_n))
    for kwargs in (dict(sweep="sharded"), dict(sweep="tiled"), dict(segment_buckets=(4, 2)),
                   dict(max_inflight=0), dict(dispatch_policy="eager"), dict(fairness="lottery"),
                   dict(target_latency_s=0.0), dict(max_stalled_frames=0),
                   dict(pose_extrapolation="guess"), dict(hygiene="shrug"),
                   dict(frame_store_budget_bytes=0), dict(budget_policy="hope")):
        with pytest.raises(ValueError) as got:
            t_stream.StreamConfig(**kwargs)
        if "sweep" not in kwargs:
            with pytest.raises(ValueError) as want:
                j_stream.StreamConfig(**kwargs)
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="ROADMAP A5"):
        t_stream.StreamConfig(sweep="sharded")
    with pytest.raises(ValueError, match="max_stalled_frames"):
        t_stream.EMVSStreamEngine(scene["cam"], scene["cfg"], _t_traj(scene["traj"]),
                                  _opts(tp), t_stream.StreamConfig(max_stalled_frames=2),
                                  device="cpu")
    oracle = _engine(scene)
    with pytest.raises(RuntimeError, match="pose-gated"):
        oracle.push_poses(_t_traj(scene["traj"]))
    gated = t_stream.EMVSStreamEngine(scene["cam"], scene["cfg"],
                                      TrajectoryBuffer(_t_traj(scene["traj"])), _opts(tp),
                                      device="cpu")
    assert gated.pose_gated and gated.stats["pose_watermark"] == float(scene["traj"][0][-1])


def test_engine_runs_on_the_card_unless_told_otherwise(scene):
    """`device=None` means the card: without one it raises instead of
    running on the CPU."""
    args = (scene["cam"], scene["cfg"], _t_traj(scene["traj"]), _opts(tp))
    if torch.cuda.is_available():
        assert t_stream.EMVSStreamEngine(*args).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.EMVSStreamEngine(*args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.MultiStreamEngine(scene["cam"], scene["cfg"], _opts(tp))
    assert _engine(scene).device.type == "cpu"


# --- dispatch internals ---------------------------------------------------------


class _StubEvent:
    """A CUDA event stand-in whose completion the test controls."""

    def __init__(self, ready: bool):
        self.ready = ready

    def query(self) -> bool:
        return self.ready

    def synchronize(self) -> None:
        self.ready = True


def _stub_inflight(seg, ready: bool):
    from repro_torch.core.detection import DepthMap
    from repro_torch.core.pointcloud import PointCloud

    h, w = 4, 6
    z = lambda *s: torch.zeros((1, *s))  # noqa: E731
    return t_disp._InFlight(
        segs=[seg], ref_R=z(3, 3), ref_t=z(3), dsis=z(2, h, w),
        dms=DepthMap(z(h, w), z(h, w).bool(), z(h, w)),
        pcs=PointCloud(z(h * w, 3), z(h * w), z(h * w).bool()),
        done=_StubEvent(ready), saturation=torch.zeros(1))


def test_poll_is_nonblocking_and_head_of_line(scene):
    """poll harvests only sweeps whose event has completed, in dispatch
    order: a finished sweep behind an unfinished one waits, and poll never
    waits on the unfinished head."""
    engine = _engine(scene)
    head, tail = _stub_inflight((0, 2), False), _stub_inflight((2, 4), True)
    engine._inflight.extend([head, tail])
    assert engine.poll() == []
    assert not head.done.ready, "poll must not wait on the head"
    head.done.ready = True
    assert [r.frame_range for r in engine.poll()] == [(0, 2), (2, 4)]
    assert not engine._inflight and engine.poll() == []
    with pytest.raises(AssertionError, match="at least one closed segment"):
        engine._dispatch([], 4)
    engine._dispatch_all([])
    assert engine.stats["dispatches"] == 0


def test_slo_and_profiler(scene):
    """A null cost model leaves the adaptive schedule as it was; a real one
    with a deadline changes when groups go but not the numbers, and its SLO
    counters equal the reference engine's under the same model (priced
    alike for the port's kernel backend and the reference's matmul one);
    the profiler's trace covers every dispatch."""
    from repro.profiling import AffineCostModel as JAffineCostModel

    ev = scene["main"]
    whole = ev[1].shape[0]
    base = _engine(scene)
    _drive(base, scene, ev, whole)
    null = _engine(scene, cost_model=NullCostModel(), target_latency_s=0.05)
    _assert_bitwise(_drive(null, scene, ev, whole), _reference(scene, ev))
    _assert_stats_equal(null.stats, base.stats)
    params = {"batched+kernel": (1e-3, 1e-6), "batched": (1e-3, 1e-6)}
    for target, counter in ((1e-6, "slo_dispatches"), (10.0, "slo_holds")):
        engine = _engine(scene, cost_model=AffineCostModel(params=dict(params)),
                         target_latency_s=target)
        _assert_bitwise(_drive(engine, scene, ev, whole), _reference(scene, ev))
        assert engine.stats[counter] > 0
        with _reference_sweeps_stubbed():
            jengine = j_stream.EMVSStreamEngine(
                scene["jcam"], scene["jcfg"], _j_traj(scene["traj"]),
                _opts(j_stream, formulation="matmul"),
                j_stream.StreamConfig(events_per_frame=EVENTS_PER_FRAME,
                                      target_latency_s=target),
                cost_model=JAffineCostModel(params=dict(params)))
            _drive(jengine, scene, ev, whole, jax_side=True)
        _assert_stats_equal(engine.stats, jengine.stats)
        assert engine.predict_drain_s() == jengine.predict_drain_s() == 0.0
    profiler = SweepProfiler()
    engine = _engine(scene, profiler=profiler, dispatch_policy="latency")
    _drive(engine, scene, ev, whole)
    trace = profiler.trace_json()
    assert len(trace["arrivals"]) == engine.stats["segments"]
    assert len(trace["dispatches"]) == engine.stats["dispatches"]
    for d in trace["dispatches"]:
        assert VariantKey.from_str(d["key"]).backend == "batched+kernel"
    total = sum(profiler.table.entry_stats(k)["count"] for k in profiler.table.keys())
    assert total + profiler.skipped_cold + profiler.skipped_shadowed == len(trace["dispatches"])
    assert engine.stats["dsi_saturation_peak"] == 0.0
