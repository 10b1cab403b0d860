"""The control of the comparison that decides `correct`: the reference in
bfloat16 (the precision below the configuration's float32) put in the
program's place, compared with the float32 reference exactly as a run
compares the program. Its readings are the upper ends the limits in
`bench/limits/` are set under; every reading must fail some limit.

    python3 bench/tools/control.py --workload <name> --seeds 1 2 3 [--seconds 10]

Prints one JSON line per seed: the control's numbers and whether the
limits pass them (they must not). Runs on the first card, or `--device cpu`.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from bench.harness import check, cli, sim  # noqa: E402
from bench.harness import live as live_mode  # noqa: E402
from bench.reference import emvs as ref  # noqa: E402

LOW = torch.bfloat16


def as_program(out: ref.SegmentOut) -> dict:
    return {"dsi": out.dsi, "depth": out.depth, "mask": out.mask,
            "confidence": out.confidence, "R_ref": out.R_ref, "p_ref": out.p_ref,
            "points": out.points, "weights": out.weights, "point_valid": out.point_valid}


def compare_segments(tally, cfg, fr_lo, fr, segs) -> None:
    """The control's outputs on the float32 plan's segments (its own plan
    may differ, which `plan` counts apart)."""
    for seg in segs:
        lo = ref.segment(fr_lo, seg, cfg, dtype=LOW)
        for name, value in check.segment_gaps(as_program(lo), ref.segment(fr, seg, cfg)).items():
            tally.worst(name, value)


def readings(workload: str, seed: int, seconds: float, device: str, tweak=None) -> dict:
    spec = cli.load_spec()
    cell, cfg, tr = cli.resolve(spec, workload)
    if tweak is not None:
        tweak(cfg, tr)
    dev = torch.device(device)
    e = cfg["emvs"]
    epf = int(e["events_per_frame"])
    threshold = float(e["keyframe_dist_frac"]) * 0.5 * (float(e["z_min"]) + float(e["z_max"]))
    tally = check.Tally()
    if tr["mode"] == "offline":
        n = int(tr["sequences"])
        for k in range(n):
            s = sim.offline_sequence(cfg, tr, seed * n + k)
            args = (s.xy, s.t, s.valid, s.pose_t, s.pose_R, s.pose_p)
            fr = ref.make_frames(*args, events_per_frame=epf, keep_tail=True, device=dev)
            lo = ref.make_frames(*args, events_per_frame=epf, keep_tail=True, device=dev,
                                 dtype=LOW)
            tally.worst("frames", check.frames_mismatch((lo.xy, lo.valid, lo.t_mid), fr))
            tally.worst("pose", check.pose_err(lo.R, lo.p, fr.R, fr.p))
            plan, plan_lo = (ref.plan_segments(f.p, threshold) for f in (fr, lo))
            tally.worst("plan", len(set(plan) ^ set(plan_lo)))
            compare_segments(tally, cfg, lo, fr, plan)
    else:
        warm = float(tr["warmup_s"])
        w_end = warm + seconds
        n_cams = int(tr["cameras"])
        streams = [sim.live_stream(cfg, tr, seed, c, w_end + float(tr["tail_s"]))
                   for c in range(n_cams)]
        frames, in_window, _ = live_mode.window_plan(cfg, streams, warm, w_end, dev)
        lows, in_lo, plans_lo = live_mode.window_plan(cfg, streams, warm, w_end, dev, LOW)
        tally.worst("missing", len({(c, g) for c, g, _ in in_window}
                                   - {(c, g) for c, g, _ in in_lo}))
        tally.worst("plan", sum(g not in plans_lo[c] for c, g, _ in in_window))
        pool = [(c, g) for c, g, _ in in_window]
        for c, g in live_mode.sample(seed, pool, int(tr["sample_segments"])):
            compare_segments(tally, cfg, lows[c], frames[c], [g])
    ok, checks = tally.report(check.load_limits(workload))
    return {"workload": workload, "seed": seed, "passes_limits": ok,
            "readings": {k: v["value"] for k, v in checks.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
