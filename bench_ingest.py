#!/usr/bin/env python3
"""Host ingest per push of the port's streaming engine, at the headline of
`repro_torch.benchmarks.streaming_latency --main-path`.

    python3 bench_ingest.py [--src DIR] [--device cpu] [--chunk-frames 1]
                            [--streams 5] [--profile 25]

Builds the benchmark's main-path sequence (the simulation_3planes scene
over a 96-step arc, 1024-event frames of DAVIS240, 128 planes, Table-1
quantized nearest votes on the fused-kernel formulation), warms the
offline path and one stream, then times `--streams` streams in chunks of
`--chunk-frames` frames with the trajectory oracle, as the benchmark's
headline does, each after one offline run (host aggregation plus
`run_emvs`). Per stream it prints one JSON line: pushes, the pushes' wall,
the time spent inside `SweepDispatcher._dispatch` (staging and enqueueing
the sweeps), the ingest per push (push wall minus dispatch time, over the
pushes), the first depth map's latency and the offline wall.

`--profile N` also prints the N costliest functions of one stream's
pushes by cumulative time under cProfile (profiled pushes run slower).
On the card it also prints the kernel launches of one warm `run_emvs` of
the sequence's frames (`repro_torch.kernels.cuda.launch_counts`).

`--src DIR` imports `repro_torch` from DIR instead of the `src/` beside
this file, so one call can time the parent commit's tree
(`git archive` into a directory) and the change's, in turns.
Last it prints the card's name and power limit (on the card).
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def timed_stream(seq, scfg, chunk_events: int, profile: cProfile.Profile | None = None):
    """One stream with the oracle trajectory: push wall, dispatch time,
    pushes and the first result's latency, all on the host's clock."""
    from repro_torch.serving.emvs_stream import EMVSStreamEngine, iter_event_chunks

    engine = EMVSStreamEngine(seq.cam, seq.dsi_cfg, seq.traj, seq.opts, scfg,
                              device=seq.dev)
    disp = engine._dispatcher
    inner = disp._dispatch
    spent = [0.0]

    def dispatch(group, cap):
        t0 = time.perf_counter()
        try:
            inner(group, cap)
        finally:
            spent[0] += time.perf_counter() - t0

    disp._dispatch = dispatch
    chunks = list(iter_event_chunks(seq.ev, chunk_events))
    first = None
    push_s = 0.0
    t0 = time.perf_counter()
    for c in chunks:
        t_push = time.perf_counter()
        if profile is not None:
            profile.enable()
        got = engine.push(c)
        if profile is not None:
            profile.disable()
        now = time.perf_counter()
        push_s += now - t_push
        if got and first is None:
            first = now - t0
    pushes_dispatch_s = spent[0]
    engine.flush()
    seq.sync()
    wall = time.perf_counter() - t0
    return {"pushes": len(chunks), "push_ms": 1e3 * push_s,
            "dispatch_ms_in_pushes": 1e3 * pushes_dispatch_s,
            "ingest_ms_per_push": 1e3 * (push_s - pushes_dispatch_s) / len(chunks),
            "first_depth_ms": None if first is None else 1e3 * first,
            "stream_wall_ms": 1e3 * wall, "dispatches": engine.stats["dispatches"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--chunk-frames", type=int, default=1)
    ap.add_argument("--streams", type=int, default=5)
    ap.add_argument("--profile", type=int, default=0,
                    help="print this many functions of a cProfile of one stream's pushes")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))

    from repro_torch.benchmarks.streaming_latency import build_sequence, offline
    from repro_torch.serving.emvs_stream import StreamConfig

    seq = build_sequence("main", args.device)
    scfg = StreamConfig(events_per_frame=seq.e_frame)
    chunk_events = args.chunk_frames * seq.e_frame
    offline(seq)
    timed_stream(seq, scfg, chunk_events)
    rows = []
    for _ in range(args.streams):
        t0 = time.perf_counter()
        offline(seq)
        t_off = 1e3 * (time.perf_counter() - t0)
        row = timed_stream(seq, scfg, chunk_events)
        row["offline_ms"] = t_off
        row["gate_holds"] = row["first_depth_ms"] is not None and row["first_depth_ms"] < t_off
        row["src"] = args.src
        rows.append(row)
        print(json.dumps(row))
    print(json.dumps({"src": args.src, "chunk_frames": args.chunk_frames,
                      "median_ingest_ms_per_push": statistics.median(
                          r["ingest_ms_per_push"] for r in rows),
                      "median_first_depth_ms": statistics.median(
                          r["first_depth_ms"] or float("inf") for r in rows),
                      "median_offline_ms": statistics.median(r["offline_ms"] for r in rows),
                      "gate_holds": [r["gate_holds"] for r in rows]}))
    if args.profile:
        prof = cProfile.Profile()
        timed_stream(seq, scfg, chunk_events, profile=prof)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(args.profile)
        print(out.getvalue())
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(args.profile)
        print(out.getvalue())
    if seq.dev.type == "cuda":
        import torch

        from repro_torch.benchmarks.streaming_latency import host_frames
        from repro_torch.core.pipeline import run_emvs
        from repro_torch.kernels import cuda

        frames = host_frames(seq)
        run_emvs(seq.cam, seq.dsi_cfg, frames, seq.opts, device=seq.dev)
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        run_emvs(seq.cam, seq.dsi_cfg, frames, seq.opts, device=seq.dev)
        torch.cuda.synchronize()
        print(json.dumps({"src": args.src, "warm_run_emvs_launches": dict(cuda.launch_counts)}))
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
