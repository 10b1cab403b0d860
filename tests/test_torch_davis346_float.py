"""DAVIS346 over the whole sensor on the float32 datapath, on the CPU at a
small size: the port's `aggregate` and `run_emvs` with the fused kernel
formulation and no Table-1 quantization, on `CAMERAS["davis346"]`, against
the benchmark's plain reference (`bench/reference/emvs.py`) under the
`davis346.offline` cell's limits. The configuration file is the one the
cell runs, cut to few planes and few scene points."""
from __future__ import annotations

import json
from pathlib import Path

import torch

from bench.harness import check, port, sim
from bench.reference import emvs as ref
from repro_torch.core.camera import CAMERAS
from repro_torch.core.pipeline import EMVSOptions, run_emvs
from repro_torch.events.aggregation import aggregate

ROOT = Path(__file__).resolve().parents[1]
CELL = "davis346.offline"
CPU = torch.device("cpu")


def config(num_planes: int = 16, points_per_plane: int = 100) -> tuple[dict, dict]:
    cfg = json.loads((ROOT / "bench/configs/davis346-3planes.json").read_text())
    traffic = json.loads((ROOT / "bench/traffic/offline-seq.json").read_text())
    cfg["emvs"]["num_planes"] = num_planes
    cfg["scene"]["points_per_plane"] = points_per_plane
    return cfg, traffic


def test_configuration_is_the_float32_davis346_path():
    cfg, _ = config()
    cam, _, opts = port.build(cfg)
    assert cam == CAMERAS["davis346"] and not cam.has_distortion()
    assert (opts.formulation, opts.quantized, opts.voting) == ("kernel", False, "nearest")
    limits = check.load_limits(CELL)
    base = check.load_limits("davis240.offline")
    assert set(limits) == set(base)
    assert all(limits[k] <= base[k] for k in base), (limits, base)


def test_float32_davis346_matches_reference():
    cfg, traffic = config()
    s = sim.offline_sequence(cfg, traffic, 2**31 + 7)
    cam = CAMERAS["davis346"]
    _, dsi_cfg, cell_opts = port.build(cfg)
    opts = EMVSOptions(formulation="kernel", quantized=False,
                       keyframe_dist_frac=cell_opts.keyframe_dist_frac)
    assert cell_opts == opts
    frames = aggregate(cam, port.event_stream(s.xy, s.t, s.polarity, s.valid),
                       port.trajectory(s.pose_t, s.pose_R, s.pose_p),
                       int(cfg["emvs"]["events_per_frame"]), device=CPU)
    res = run_emvs(cam, dsi_cfg, frames, opts, device=CPU)

    e = cfg["emvs"]
    fr = ref.make_frames(s.xy, s.t, s.valid, s.pose_t, s.pose_R, s.pose_p,
                         events_per_frame=int(e["events_per_frame"]), keep_tail=True,
                         device=CPU)
    assert check.frames_mismatch((frames.xy, frames.valid, frames.t_mid), fr) == 0
    plan = ref.plan_segments(fr.p, e["keyframe_dist_frac"] * 0.5 * (e["z_min"] + e["z_max"]))
    assert [tuple(seg.frame_range) for seg in res.segments] == plan and len(plan) >= 3

    limits = check.load_limits(CELL)
    for seg, cloud in zip(res.segments, res.clouds):
        assert seg.dsi.dtype == torch.float32
        assert seg.dsi.shape == (e["num_planes"], cam.height, cam.width)
        want = ref.segment(fr, tuple(seg.frame_range), cfg)
        gaps = check.segment_gaps(port.segment_outputs(seg, cloud), want)
        for name, value in gaps.items():
            assert value <= limits[name], (seg.frame_range, name, value, limits[name])
