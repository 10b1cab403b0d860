"""The plain reference at a small size against a stored answer, and the
port at that size (its plain CPU versions) against the reference."""
import json
from pathlib import Path

import pytest
import torch

from bench.harness import check, sim
from bench.reference import emvs as ref
from small import tweak

BENCH = Path(__file__).resolve().parents[1]


def small_sequence():
    cfg = json.loads((BENCH / "configs/davis240-3planes.json").read_text())
    tr = json.loads((BENCH / "traffic/offline-seq.json").read_text())
    tweak(cfg, tr)
    s = sim.offline_sequence(cfg, tr, 2024)
    fr = ref.make_frames(s.xy, s.t, s.valid, s.pose_t, s.pose_R, s.pose_p,
                         events_per_frame=1024, keep_tail=True, device="cpu")
    return cfg, s, fr


def test_reference_stored_answer():
    cfg, _, fr = small_sequence()
    plan = ref.plan_segments(fr.p, 0.05 * 0.5 * (0.6 + 4.5))
    assert fr.xy.shape[0] == 43
    assert plan == [(0, 6), (6, 14), (14, 23), (23, 33), (33, 39), (39, 43)]
    out = ref.segment(fr, plan[1], cfg)
    assert int(out.dsi.sum()) == 194041 and int(out.dsi.max()) == 25
    assert int(out.mask.sum()) == 133
    assert float(out.depth[out.mask].mean()) == pytest.approx(2.553, abs=2e-3)
    assert float(out.points[out.point_valid].abs().sum()) == pytest.approx(458.3, rel=1e-3)


def test_table1_rules():
    c = torch.tensor([-0.6, -0.5, -0.2, 0.49, 0.5, 254.5, 255.49, 255.6, float("nan")])
    assert ref.pixel_index_u8(c).tolist() == [255, 0, 0, 0, 1, 255, 255, 255, 0]
    x = torch.tensor([1.0 / 256, -1.0 / 256, 300.0, -300.0])
    assert ref.fixed_point(x, 16, 7).tolist() == [1 / 128, -1 / 128, 32767 / 128, -256.0]


def test_port_matches_reference_at_small_size():
    from repro_torch.core.pipeline import run_emvs
    from repro_torch.events.aggregation import aggregate

    from bench.harness import offline, port

    cfg, s, _ = small_sequence()
    cam, dsi_cfg, opts = port.build(cfg)
    frames = aggregate(cam, port.event_stream(s.xy, s.t, s.polarity, s.valid),
                       port.trajectory(s.pose_t, s.pose_R, s.pose_p), 1024, device="cpu")
    res = run_emvs(cam, dsi_cfg, frames, opts, device="cpu")
    tally = check.Tally()
    offline.compare_sequence(tally, cfg, s, frames, res, torch.device("cpu"))
    ok, checks = tally.report(check.load_limits("davis240.offline"))
    assert ok, checks
    assert tally.values["frames"] == 0 and tally.values["plan"] == 0
