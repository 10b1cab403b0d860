"""The port's segment-parallel backend over `torch.distributed`, on the CPU.

Each gloo group (4 ranks, then 2) is spawned once for the module with
`gloo_group.outcomes` and a `FileStore` under a temporary
directory. The parent makes every input from a seed and the reference's
outputs with JAX; the ranks run the port and hold it to them, and each
rank reports every case's outcome. Each test below reads one case.

* `run_emvs(sweep="sharded")` equals the port's batched backend and the
  reference's batched `run_emvs` (matmul formulation) bitwise on dsi,
  depth, mask and confidence, nearest voting, float and Table-1
  quantized, with buckets whose segment counts are and are not multiples
  of the rank count (padded rows are discarded). Every rank returns the
  whole result.
* `make_emvs_step` on a 2 x 2 ("data", "model") mesh against the
  reference's `process_segment(formulation="matmul")` at the inputs of the
  reference's own distributed test: nearest exact with `vote_dtype` int16
  and int32, bilinear float32 within 1e-3, the mask equal; the pod path
  (a 2 x 1 x 2 mesh) equal to the step per segment.
* `EMVSStreamEngine` and `MultiStreamEngine` with
  `StreamConfig(sweep="sharded")` on 2 ranks: results bitwise `run_emvs`
  over host-aggregated frames, the S buckets rounded as the reference
  rounds them, `variant_space` equal to the reference's
  `enumerate_variant_space(..., mesh_segments=2)`.
* Errors: the reference's messages where the reference has the case.

The ranks import this module to find their entry point, so JAX and the
reference package are imported inside the parent's fixtures and tests,
never at module level: the ranks import torch and the port only.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
import types
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

import gloo_group
from gloo_group import assert_case, check, outcomes, run_ranks
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.distributed import emvs as t_emvs
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.serving import emvs_stream as t_stream
from repro_torch.serving import sweep_dispatcher as t_disp

RUN_CASES = [(frac, quantized) for frac in (0.05, 0.03) for quantized in (False, True)]
EVENTS_PER_FRAME = 256
STREAM_BUCKETS = (1, 2, 3, 5)  # rounded to (2, 4, 6) on 2 ranks
STEP_VOTINGS = [("nearest", "int16"), ("nearest", "int32"), ("bilinear", "int32")]
BILINEAR_ATOL = 1e-3


def _frames():
    """The seeded sequence of `tests/test_torch_pipeline.py`: 23 frames of
    256 events, as numpy. frac 0.05 buckets 4 + 2 segments, 0.03 nine."""
    from repro_torch.core.camera import CameraModel

    cam = CameraModel()
    traj = t_sim.make_trajectory("simulation_3planes", 24, device="cpu")
    ev = t_sim.simulate_events(cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=80)),
                               traj, device="cpu")
    tf = t_agg.aggregate(cam, ev, traj, events_per_frame=EVENTS_PER_FRAME,
                         pose_extrapolation="clamp", device="cpu")
    return (cam, tuple(a.numpy() for a in (tf.xy, tf.valid, tf.t_mid, *tf.poses)),
            tuple(a.numpy() for a in ev), (traj.times.numpy(), traj.poses.R.numpy(),
                                           traj.poses.t.numpy()))


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------


def _equal(a: torch.Tensor, b, what: str) -> None:
    b = torch.as_tensor(np.asarray(b))
    assert a.shape == b.shape and torch.equal(a.to(b.dtype), b), what


def _ranks(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=60))
    out: dict = {}
    try:
        _run_cases(rank, world, spec, out)
    finally:
        with open(os.path.join(tmp, f"out{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def _run_cases(rank: int, world: int, spec: dict, out: dict) -> None:
    cam = interop.camera_from_dict(spec["cam"])
    cfg = interop.dsi_config_from_dict(spec["cfg"])
    frames = interop.event_frames_from_numpy(*spec["frames"], device="cpu")
    mesh = t_emvs.make_segment_mesh()
    out["mesh"] = (tuple(mesh.mesh_dim_names), tuple(mesh.shape), mesh.device_type)

    for frac, quantized in RUN_CASES:
        def run(frac=frac, quantized=quantized):
            opts = tp.EMVSOptions(formulation="kernel", quantized=quantized,
                                  keyframe_dist_frac=frac)
            got = tp.run_emvs(cam, cfg, frames, opts, sweep="sharded", mesh=mesh,
                              device="cpu")
            want = spec["ref_runs"][(frac, quantized)]
            assert [s.frame_range for s in got.segments] == [r[0] for r in want]
            for s, (_, dsi, depth, mask, conf) in zip(got.segments, want):
                _equal(s.dsi, dsi, "dsi")
                _equal(s.depth_map.depth, depth, "depth")
                _equal(s.depth_map.mask, mask, "mask")
                _equal(s.depth_map.confidence, conf, "confidence")
            batched = tp.run_emvs(cam, cfg, frames, opts, device="cpu")
            for s, b, c, bc in zip(got.segments, batched.segments, got.clouds, batched.clouds):
                assert s.dsi.dtype == b.dsi.dtype
                for x, y in ((s.dsi, b.dsi), (s.depth_map.depth, b.depth_map.depth),
                             (s.depth_map.mask, b.depth_map.mask), (c.points, bc.points),
                             (c.valid, bc.valid)):
                    assert torch.equal(x, y)
        check(out, ("run", frac, quantized), run)

    if world == 2:
        _error_cases(cam, cfg, frames, out)
        _stream_cases(cam, cfg, spec, mesh, out)
    if world == 4:
        _step_cases(cam, spec, out)


def _error_cases(cam, cfg, frames, out: dict) -> None:
    from torch.distributed.device_mesh import init_device_mesh

    data_mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("data",))
    opts = tp.EMVSOptions(formulation="kernel")
    try:
        tp.run_emvs(cam, cfg, frames, opts, sweep="sharded", mesh=data_mesh, device="cpu")
        out["no_segments_axis"] = "no error"
    except ValueError as e:
        out["no_segments_axis"] = str(e)
    batch = tp.pad_segments(frames, [(0, 4), (4, 8), (8, 12)], 4)
    try:
        t_emvs.process_segments_sharded(cam, cfg, batch, opts)
        out["odd_segments"] = "no error"
    except ValueError as e:
        out["odd_segments"] = str(e)


def _stream_cases(cam, cfg, spec, mesh, out: dict) -> None:
    ev = t_sim.EventStream(*map(torch.from_numpy, spec["events"]))
    times, R, t = spec["traj"]
    traj = t_sim.Trajectory(torch.from_numpy(times),
                            tp.SE3(torch.from_numpy(R), torch.from_numpy(t)))
    opts = tp.EMVSOptions(formulation="kernel", quantized=True, keyframe_dist_frac=0.03)
    base = tp.run_emvs(cam, cfg, interop.event_frames_from_numpy(*spec["frames"], device="cpu"),
                       opts, device="cpu")

    def scfg(**kw):
        return t_stream.StreamConfig(sweep="sharded", events_per_frame=EVENTS_PER_FRAME,
                                     segment_buckets=STREAM_BUCKETS,
                                     pose_extrapolation="clamp", **kw)

    def same(res, what):
        assert [s.frame_range for s in res.segments] == [s.frame_range for s in base.segments], what
        for a, b in zip(res.segments, base.segments):
            for x, y in ((a.dsi, b.dsi), (a.depth_map.depth, b.depth_map.depth),
                         (a.depth_map.mask, b.depth_map.mask)):
                assert torch.equal(x, y), what

    for policy in ("latency", "throughput", "adaptive"):
        def single(policy=policy):
            engine = t_stream.EMVSStreamEngine(cam, cfg, traj, opts, scfg(dispatch_policy=policy),
                                               device="cpu")
            assert engine.mesh is not None
            for chunk in t_stream.iter_event_chunks(ev, 997):
                engine.push(chunk)
            same(engine.flush(), policy)
            out[("stream_stats", policy)] = {k: engine.stats[k] for k in (
                "segments", "dispatches", "padded_segments")}
            out["stream_buckets"] = engine._segment_buckets
            out["variant_space"] = engine._dispatcher.variant_space(24)
        check(out, ("stream", policy), single)

    def multi():
        engine = t_stream.MultiStreamEngine(cam, cfg, opts, scfg(
            dispatch_policy="throughput", fairness="round_robin"), device="cpu")
        a, b = engine.add_session("a", traj=traj), engine.add_session("b", traj=traj)
        for chunk in t_stream.iter_event_chunks(ev, 997):
            a.push(chunk)
            b.push(chunk)
        same(a.flush(), "session a")
        same(b.flush(), "session b")
        d = engine.stats["dispatcher"]
        assert d["cross_stream_dispatches"] >= 1 and d["pending_segments"] == 0, d
        out["multi_stats"] = dict(d)
    check(out, "multi", multi)


def _step_cases(cam, spec, out: dict) -> None:
    from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

    step_in = spec["step"]
    cfg = interop.dsi_config_from_dict(step_in["cfg"])
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    args = [torch.from_numpy(step_in[k]) for k in ("xy", "valid", "frame_valid", "H", "phi")]
    for voting, vote_dtype in STEP_VOTINGS:
        def step(voting=voting, vote_dtype=vote_dtype):
            fn = t_emvs.make_emvs_step(cam, cfg, mesh, mode=voting,
                                       vote_dtype=getattr(torch, vote_dtype))
            dsi, depth, mask, conf = fn(*args)
            dsi_ref, mask_ref = step_in["ref"][voting]
            assert dsi.shape == dsi_ref.shape and mask.shape == mask_ref.shape
            if voting == "nearest":
                assert dsi.dtype == torch.int32
                _equal(dsi, dsi_ref.astype(np.int32), "nearest dsi")
            else:
                assert dsi.dtype == torch.float32
                err = float(np.abs(dsi.numpy() - dsi_ref.astype(np.float32)).max())
                assert err < BILINEAR_ATOL, err
            _equal(mask, mask_ref, "mask")
        check(out, ("step", voting, vote_dtype), step)

    def pod():
        rng = np.random.default_rng(0)
        g, f, e, nz = 2, 4, 64, cfg.num_planes
        xy = rng.uniform((0, 0), (cam.width - 1, cam.height - 1), (g, f, e, 2)).astype(np.float32)
        valid = rng.random((g, f, e)) < 0.9
        frame_valid = np.ones((g, f), bool)
        frame_valid[:, -1] = False
        H = np.broadcast_to(np.eye(3, dtype=np.float32), (g, f, 3, 3)).copy()
        phi = np.stack([1.0 + 0.01 * rng.standard_normal((g, f, nz)),
                        rng.standard_normal((g, f, nz)), rng.standard_normal((g, f, nz))],
                       -1).astype(np.float32)
        pod_args = [torch.from_numpy(a) for a in (xy, valid, frame_valid, H, phi)]
        pod_mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 1, 2),
                              mesh_dim_names=("pod", "data", "model"))
        got = t_emvs.make_emvs_step(cam, cfg, pod_mesh, pod_axis="pod")(*pod_args)
        per_seg = t_emvs.make_emvs_step(cam, cfg, mesh)
        for k in range(g):
            want = per_seg(*(a[k] for a in pod_args))
            for x, y in zip(got, want):
                assert torch.equal(x[k], y)
        assert int(got[0].sum()) > 0
    check(out, "pod", pod)


# ---------------------------------------------------------------------------
# The parent: inputs, reference outputs, one spawn per group size
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Every input and reference output the ranks need, pickled once."""
    from repro.core.camera import CameraModel as JCamera
    from repro.core.dsi import DSIConfig as JDSIConfig
    from repro.core.geometry import SE3 as JSE3
    from repro.core.pipeline import EMVSOptions as JOptions
    from repro.core.pipeline import run_emvs as j_run_emvs
    from repro.events.aggregation import EventFrames as JEventFrames

    cam, frames, events, traj = _frames()
    jcam = JCamera(**dataclasses.asdict(cam))
    jcfg = JDSIConfig.for_camera(jcam, num_planes=16, z_min=0.6, z_max=4.5)
    jframes = JEventFrames(*frames[:3], JSE3(*frames[3:]))
    ref_runs = {}
    for frac, quantized in RUN_CASES:
        res = j_run_emvs(jcam, jcfg, jframes, JOptions(formulation="matmul", quantized=quantized,
                                                        keyframe_dist_frac=frac))
        ref_runs[(frac, quantized)] = [
            (s.frame_range, *(np.asarray(a) for a in (s.dsi, s.depth_map.depth, s.depth_map.mask,
                                                       s.depth_map.confidence)))
            for s in res.segments]
    tmp = str(tmp_path_factory.mktemp("sharded"))
    out = {"cam": dataclasses.asdict(cam), "cfg": dataclasses.asdict(jcfg), "frames": frames,
           "events": events, "traj": traj, "ref_runs": ref_runs, "step": _step_inputs()}
    with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
        pickle.dump(out, f)
    return types.SimpleNamespace(tmp=tmp, data=out, ranks={})


def _step_inputs() -> dict:
    """The reference's distributed test inputs (section 3): 20 trajectory
    steps, 120 points per plane, no noise, 1024-event frames, 16 planes,
    frames padded to a multiple of 4 with frame_valid 0; its
    `process_segment(formulation="matmul", median_filter=False)` outputs."""
    import jax
    import jax.numpy as jnp

    from repro.core.camera import CameraModel as JCamera
    from repro.core.dsi import DSIConfig as JDSIConfig
    from repro.core.geometry import SE3 as JSE3
    from repro.core.pipeline import EMVSOptions as JOptions
    from repro.core.pipeline import precompute_segment_geometry, process_segment
    from repro.events.aggregation import aggregate
    from repro.events.simulator import SceneConfig, make_scene, make_trajectory, simulate_events

    cam = JCamera()
    traj = make_trajectory("simulation_3planes", 20)
    ev = simulate_events(cam, make_scene(SceneConfig(points_per_plane=120)), traj,
                         noise_fraction=0.0)
    frames = aggregate(cam, ev, traj, 1024)
    cfg = JDSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    T_w_ref = JSE3(frames.poses.R[0], frames.poses.t[0])
    f = int(frames.xy.shape[0])
    f_pad = -(-f // 4) * 4
    pad = jax.tree.map(lambda a: np.concatenate(
        [np.asarray(a)] + [np.asarray(a)[-1:]] * (f_pad - f)), frames)
    planes = cfg.planes()
    geoms = precompute_segment_geometry(cam, pad, T_w_ref, planes, planes[cfg.num_planes // 2])
    phi = jnp.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], axis=-1)
    ref = {}
    for voting in ("nearest", "bilinear"):
        dsi, dm = process_segment(cam, cfg, frames, T_w_ref, JOptions(
            formulation="matmul", voting=voting, median_filter=False))
        ref[voting] = (np.asarray(dsi), np.asarray(dm.mask))
    return {"cfg": dataclasses.asdict(cfg), "xy": np.asarray(pad.xy),
            "valid": np.asarray(pad.valid).astype(np.float32),
            "frame_valid": (np.arange(f_pad) < f).astype(np.float32),
            "H": np.asarray(geoms.H), "phi": np.asarray(phi), "ref": ref}



@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("frac,quantized", RUN_CASES)
def test_run_emvs_sharded_matches_batched(spec, world, frac, quantized):
    """Sharded == the port's batched == the reference's batched, bitwise,
    on every rank; bucket segment counts of 4 and 2 (frac 0.05) and 9
    (0.03) against 2 and 4 ranks exercise the padding. The module's first
    test; the 4-rank case comes first, so each group is spawned under the
    time limit of a test of its own."""
    assert_case(outcomes(_ranks, spec, world), ("run", frac, quantized))
    for out in outcomes(_ranks, spec, world):
        assert out["mesh"] == (("segments",), (world,), "cpu")


def test_run_cases_cover_bucket_counts_off_and_on_rank_multiples(spec):
    """The run cases' buckets hold segment counts that are and are not
    multiples of 2 and 4, so padding and discarding rows are exercised."""
    from repro_torch.core.pipeline import bucket_capacity, plan_segments

    frames = interop.event_frames_from_numpy(*spec.data["frames"], device="cpu")
    cfg = interop.dsi_config_from_dict(spec.data["cfg"])
    counts = set()
    for frac in (0.05, 0.03):
        by_cap: dict = {}
        for a, b in plan_segments(frames, cfg, tp.EMVSOptions(keyframe_dist_frac=frac)):
            by_cap[bucket_capacity(b - a)] = by_cap.get(bucket_capacity(b - a), 0) + 1
        counts.update(by_cap.values())
    assert any(c % 2 for c in counts) and any(c % 4 == 0 for c in counts)
    assert any(c % 4 and c % 2 == 0 for c in counts)


@pytest.mark.parametrize("voting,vote_dtype", STEP_VOTINGS)
def test_emvs_step_matches_reference(spec, voting, vote_dtype):
    assert_case(outcomes(_ranks, spec, 4), ("step", voting, vote_dtype))


def test_emvs_step_pod_axis(spec):
    assert_case(outcomes(_ranks, spec, 4), "pod")


@pytest.mark.parametrize("policy", ["latency", "throughput", "adaptive"])
def test_stream_engine_sharded(spec, policy):
    assert_case(outcomes(_ranks, spec, 2), ("stream", policy))
    stats = [out[("stream_stats", policy)] for out in outcomes(_ranks, spec, 2)]
    assert stats[0] == stats[1], "the ranks took different dispatch decisions"
    assert stats[0]["dispatches"] >= 1


def test_multi_stream_engine_sharded(spec):
    assert_case(outcomes(_ranks, spec, 2), "multi")
    outs = outcomes(_ranks, spec, 2)
    assert outs[0]["multi_stats"]["dispatches"] == outs[1]["multi_stats"]["dispatches"]


def test_stream_buckets_and_variant_space_match_reference(spec):
    from repro.serving import emvs_stream as j_stream
    from repro.serving.sweep_dispatcher import enumerate_variant_space

    assert_case(outcomes(_ranks, spec, 2), ("stream", "latency"))
    jcfg = j_stream.StreamConfig(sweep="sharded", segment_buckets=STREAM_BUCKETS)
    want = enumerate_variant_space(jcfg, 24, mesh_segments=2, formulation="kernel")
    for out in outcomes(_ranks, spec, 2):
        assert out["stream_buckets"] == want["s_buckets"] == (2, 4, 6)
        assert out["variant_space"] == want
    tcfg = t_stream.StreamConfig(sweep="sharded", segment_buckets=STREAM_BUCKETS)
    for n in (1, 2, 3, 4):
        assert t_disp.enumerate_variant_space(tcfg, 24, mesh_segments=n, formulation="kernel") \
            == enumerate_variant_space(jcfg, 24, mesh_segments=n, formulation="kernel")


def test_errors_inside_the_group_match_reference(spec, monkeypatch):
    import jax

    from repro.core.camera import CameraModel as JCamera
    from repro.core.dsi import DSIConfig as JDSIConfig
    from repro.core.pipeline import EMVSOptions as JOptions
    from repro.core.pipeline import SegmentBatch as JBatch
    from repro.distributed import emvs as j_emvs

    outs = outcomes(_ranks, spec, 2)
    with pytest.raises(ValueError) as want:
        j_emvs.segment_axis_size(jax.make_mesh((1,), ("data",)))
    assert outs[0]["no_segments_axis"] == outs[1]["no_segments_axis"] == str(want.value)
    # the reference's mesh here has one device: report two on its axis so
    # its own check of S against n fires
    monkeypatch.setattr(j_emvs, "segment_axis_size", lambda mesh, axis_name: 2)
    jcam = JCamera()
    batch = JBatch(*(np.zeros((3, *s), np.float32) for s in (
        (4, 8, 2), (4, 8), (4,), (4, 3, 3), (4, 3), (3, 3), (3,))))
    with pytest.raises(ValueError) as want:
        j_emvs.process_segments_sharded(jcam, JDSIConfig.for_camera(jcam, num_planes=4), batch,
                                        JOptions())
    assert outs[0]["odd_segments"] == outs[1]["odd_segments"] == str(want.value)


def test_errors_outside_a_group_match_reference():
    from repro.core.camera import CameraModel as JCamera
    from repro.core.dsi import DSIConfig as JDSIConfig
    from repro.core.pipeline import EMVSOptions as JOptions
    from repro.core.pipeline import run_emvs as j_run_emvs
    from repro.events.aggregation import EventFrames as JEventFrames
    from repro.serving import emvs_stream as j_stream
    from repro.serving import sweep_dispatcher as j_disp

    assert not dist.is_initialized()
    jcam = JCamera()
    jcfg = JDSIConfig.for_camera(jcam, num_planes=8)
    cam = interop.camera_from_dict(dataclasses.asdict(jcam))
    cfg = interop.dsi_config_from_dict(dataclasses.asdict(jcfg))
    frames = t_agg.empty_event_frames(8, device="cpu")
    jframes = JEventFrames(*(a.numpy() for a in frames[:3]), None)
    for kwargs in (dict(sweep="tiled"), dict(sweep="batched", mesh=object())):
        with pytest.raises(ValueError) as got:
            tp.run_emvs(cam, cfg, frames, sweep=kwargs["sweep"], mesh=kwargs.get("mesh"),
                        device="cpu")
        with pytest.raises(ValueError) as want:
            j_run_emvs(jcam, jcfg, jframes, **kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        t_disp.SweepDispatcher(cam, cfg, tp.EMVSOptions(), t_stream.StreamConfig(),
                               mesh=object(), device="cpu")
    with pytest.raises(ValueError) as want:
        j_disp.SweepDispatcher(jcam, jcfg, JOptions(), j_stream.StreamConfig(), mesh=object())
    assert str(got.value) == str(want.value)
    # no implicit process group: the sharded entry points raise
    with pytest.raises(RuntimeError, match="init_process_group"):
        tp.run_emvs(cam, cfg, frames, sweep="sharded", device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        t_stream.EMVSStreamEngine(cam, cfg, None, tp.EMVSOptions(),
                                  t_stream.StreamConfig(sweep="sharded"), device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        t_emvs.make_segment_mesh()


def test_stream_engine_refuses_a_multi_card_mesh():
    """Rank-local readiness on several cards could split the schedule."""
    from repro_torch.core.camera import CameraModel

    cam = CameraModel()
    cfg = tp.DSIConfig.for_camera(cam, num_planes=8)
    for n, refused in ((2, True), (1, False)):
        mesh = types.SimpleNamespace(mesh_dim_names=("segments",), shape=(n,),
                                     device_type="cuda")
        if refused:
            with pytest.raises(NotImplementedError, match="readiness"):
                t_stream.EMVSStreamEngine(cam, cfg, None, tp.EMVSOptions(),
                                          t_stream.StreamConfig(sweep="sharded"), mesh=mesh,
                                          device="cpu")
        else:
            engine = t_stream.EMVSStreamEngine(cam, cfg, None, tp.EMVSOptions(),
                                               t_stream.StreamConfig(sweep="sharded"),
                                               mesh=mesh, device="cpu")
            assert engine.mesh is mesh and engine._segment_buckets == (1, 2, 4)


def test_emvs_input_specs_match_reference():
    from repro.core.camera import CameraModel as JCamera
    from repro.core.dsi import DSIConfig as JDSIConfig
    from repro.distributed.emvs import emvs_input_specs as j_specs

    jcfg = JDSIConfig.for_camera(JCamera(), num_planes=16)
    cfg = interop.dsi_config_from_dict(dataclasses.asdict(jcfg))
    for segments in (None, 2):
        got = t_emvs.emvs_input_specs(cfg, frames=12, events=64, segments=segments)
        want = j_specs(jcfg, frames=12, events=64, segments=segments)
        assert list(got) == list(want) == ["xy", "valid", "frame_valid", "H", "phi"]
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert got[k].device.type == "meta" and got[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# The spawn helper of all three gloo modules
# ---------------------------------------------------------------------------

HELPER_DEADLINE_S = 15


def _report(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, f"out{world}_{rank}.pkl"), "wb") as f:
        pickle.dump({"rank": rank, "threads": torch.get_num_threads()}, f)


def _rank1_hangs(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    if rank == 1:
        time.sleep(3600)
    _report(rank, world, tmp)


def test_run_ranks_hands_back_every_outcome(tmp_path):
    """A group that returns: each rank's outcome in rank order, each rank
    with its share of this process's torch threads."""
    outs = run_ranks(_report, 2, str(tmp_path))
    share = max(1, torch.get_num_threads() // 2)
    assert outs == [{"rank": 0, "threads": share}, {"rank": 1, "threads": share}]


def test_run_ranks_fails_at_its_deadline(tmp_path, monkeypatch):
    """A rank that outwaits the deadline: the test fails within the
    deadline plus 10 s, naming that rank (and rank 0 only if it had not
    reported yet), and no rank is left alive. The module's next call for
    that group fails at once with the same message and spawns nothing."""
    monkeypatch.setattr(gloo_group, "RANKS_DEADLINE_S", HELPER_DEADLINE_S)
    group = types.SimpleNamespace(tmp=str(tmp_path), ranks={})
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as failed:
        outcomes(_rank1_hangs, group, 2, order=(2,))
    assert time.monotonic() - start < HELPER_DEADLINE_S + 10
    late = [1] if (tmp_path / "out2_0.pkl").exists() else [0, 1]
    message = f"gloo ranks {late} of 2 had not returned within {HELPER_DEADLINE_S} s"
    assert message in str(failed.value)
    pids = [int(p.read_text()) for p in tmp_path.glob("pid*")]
    assert pids or late == [0, 1]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)

    monkeypatch.setattr(gloo_group, "run_ranks", lambda *args: pytest.fail("spawned again"))
    start = time.monotonic()
    with pytest.raises(pytest.fail.Exception) as again:
        outcomes(_rank1_hangs, group, 2, order=(2,))
    assert time.monotonic() - start < 1
    assert "the 2-rank gloo group failed in an earlier test" in str(again.value)
    assert message in str(again.value)
