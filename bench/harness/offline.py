"""Offline reconstruction: a closed loop over recorded sequences.

Set-up makes `sequences` distinct recordings from the seed (scene and event
seeds `seed * sequences + k`) as host event streams and trajectories, and
runs each once through the timed path, which builds and warms every shape
the window uses. The window hands them in turn to `aggregate` and then
`run_emvs`, waits for each result on the device, and counts the events of
every finished sequence. Once the window has closed, the last result of
every sequence is compared with the reference.
"""
from __future__ import annotations

import sys
import time

import torch

from bench.harness import check, port, roofline, sim
from bench.harness.cli import Outcome, Run
from bench.reference import emvs as ref


def run(r: Run) -> Outcome:
    from repro_torch.core.pipeline import run_emvs
    from repro_torch.events.aggregation import aggregate

    cfg, tr, dev = r.cfg, r.traffic, r.device
    cam, dsi_cfg, opts = port.build(cfg)
    epf = int(cfg["emvs"]["events_per_frame"])
    n_seq = int(tr["sequences"])
    seqs = [sim.offline_sequence(cfg, tr, r.seed * n_seq + k) for k in range(n_seq)]
    inputs = [(port.event_stream(s.xy, s.t, s.polarity, s.valid),
               port.trajectory(s.pose_t, s.pose_R, s.pose_p)) for s in seqs]
    span = r.tracer.span

    def one(k: int):
        stream, traj = inputs[k]
        with span("aggregate"):
            frames = aggregate(cam, stream, traj, epf, device=dev)
        with span("run_emvs"):
            res = run_emvs(cam, dsi_cfg, frames, opts, device=dev)
        port.synchronize(dev)
        return frames, res

    last = [one(k) for k in range(n_seq)]  # warm-up: every sequence once
    port.settle()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    window = min(r.seconds, float(tr["trace_seconds"])) if r.trace else r.seconds
    done = 0
    t0 = time.perf_counter()
    setup_s = t0 - r.t_start
    with r.tracer.window():
        while True:
            k = done % n_seq
            last[k] = one(k)
            done += 1
            if time.perf_counter() - t0 >= window:
                break
    elapsed = time.perf_counter() - t0
    peak = port.memory_peak(dev)
    events = sum(seqs[k % n_seq].t.shape[0] for k in range(done))
    e2e = {"setup_s": setup_s, "recon_mev_s": events / elapsed / 1e6}

    layer_ctx = {"summary": r.tracer.summary, "sequences": done}
    if r.trace:
        layer_ctx.update(work(cfg, last, done, n_seq, epf))

    tally = check.Tally()
    t_ref = time.perf_counter()
    for k, s in enumerate(seqs):
        compare_sequence(tally, cfg, s, *last[k], dev)
    print(f"offline: {done} sequences in {elapsed:.3f} s; reference comparison "
          f"{time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    return Outcome(end_to_end=e2e, layer_ctx=layer_ctx, attempted=done, failed=0,
                   memory_peak_bytes=peak, checks=tally.values)


def work(cfg, last, done: int, n_seq: int, epf: int) -> dict:
    """B1's and B2's (bytes, operations) over the `done` sequences of the
    window, from each sequence's real segments and valid events."""
    e = cfg["emvs"]
    nz, q = int(e["num_planes"]), bool(e["quantized"])
    h, w = int(cfg["camera"]["height"]), int(cfg["camera"]["width"])
    per_seq = []
    for frames, res in last:
        valid = frames.valid.sum(-1).cpu()
        b1, b2 = [0, 0], [0, 0]
        for seg in res.segments:
            a, b = seg.frame_range
            for acc, (nb, no) in ((b1, roofline.b1_work(b - a, epf, int(valid[a:b].sum()),
                                                        nz, h, w, q)),
                                  (b2, roofline.b2_work(nz, h, w, q))):
                acc[0] += nb
                acc[1] += no
        per_seq.append((b1, b2))
    times = [done // n_seq + (1 if k < done % n_seq else 0) for k in range(n_seq)]
    b1 = [sum(c * ps[0][i] for c, ps in zip(times, per_seq)) for i in (0, 1)]
    b2 = [sum(c * ps[1][i] for c, ps in zip(times, per_seq)) for i in (0, 1)]
    return {"b1_work": tuple(b1), "b2_work": tuple(b2)}


def compare_sequence(tally: check.Tally, cfg: dict, s: sim.Stream, frames, res, dev
                     ) -> None:
    """The program's frames, plan, and each segment's outputs against the
    reference worked out from the same events and trajectory."""
    e = cfg["emvs"]
    fr = ref.make_frames(s.xy, s.t, s.valid, s.pose_t, s.pose_R, s.pose_p,
                         events_per_frame=int(e["events_per_frame"]), keep_tail=True,
                         device=dev)
    tally.worst("frames", check.frames_mismatch((frames.xy, frames.valid, frames.t_mid), fr))
    if frames.xy.shape == fr.xy.shape:
        tally.worst("pose", check.pose_err(frames.poses.R, frames.poses.t, fr.R, fr.p))
    threshold = float(e["keyframe_dist_frac"]) * 0.5 * (float(e["z_min"]) + float(e["z_max"]))
    plan = ref.plan_segments(fr.p, threshold)
    got = [tuple(seg.frame_range) for seg in res.segments]
    tally.worst("plan", len(set(plan) ^ set(got)))
    for seg, cloud in zip(res.segments, res.clouds):
        key = tuple(seg.frame_range)
        if key not in plan:
            continue
        gaps = check.segment_gaps(port.segment_outputs(seg, cloud), ref.segment(fr, key, cfg))
        for name, value in gaps.items():
            tally.worst(name, value)
