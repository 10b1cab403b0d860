"""Streaming EMVS demo on the port: depth maps while the sensor is still moving.

The offline demo (`emvs_reconstruction`) aggregates the whole recording,
then reconstructs. This variant feeds the same event stream chunk by chunk
into `EMVSStreamEngine`: key-frame segments close the moment the K
criterion trips, vote on the card while later events are still arriving,
and depth maps are printed as they complete. The final result equals
`run_emvs` over host-aggregated frames bitwise on the nearest datapath.

    PYTHONPATH=src python -m repro_torch.examples.emvs_streaming \\
        [--device cpu] [--scene simulation_3walls] [--chunk-frames 2] \\
        [--sweep sharded] [--policy adaptive] [--target-latency-ms 50] \\
        [--pose-lag 0.1] [--max-stall 32] [--sessions 3] \\
        [--out results/emvs_stream_torch.npz]

Runs on the CUDA card unless `--device cpu`; each dispatch there runs the
sweep kernel B1 and the depth max/argmax kernel B2 (nearest voting,
Table-1 quantized, the fused-kernel formulation), on the CPU their plain
versions.

`--sessions N` (N > 1) simulates an N-camera rig: each session gets its
own event stream (same scene and trajectory, different sensor noise), all
multiplexed onto ONE `MultiStreamEngine` whose shared dispatcher coalesces
shape-compatible segments from different cameras into one sweep. Chunks
interleave round-robin across sessions; every session's reconstruction is
checked bitwise against its own offline `run_emvs`.

`--sweep sharded` dispatches each closed-segment bucket through
`repro_torch.distributed.emvs.process_segments_sharded`. Without a process
group the demo starts one of one rank (NCCL on the card, gloo on the CPU,
rendezvous through a file) and ends it when done.

`--policy` picks how closed segments leave the coalescing queue
("latency", "throughput", "adaptive"); the reconstruction is the same
under every policy. `--pose-lag SECONDS` streams the poses too, lagging the
event front (a tracker behind the sensor); `--max-stall N` bounds the
frames stalled past the pose watermark. `--hygiene` picks the ingest guard
and `--corrupt MODE` injects one fault of `simulator.corrupt_stream`.
`--target-latency-ms MS` arms the SLO-aware adaptive planner with a cost
model from COST_TABLE (recorded on the card by
`python -m repro_torch.benchmarks.streaming_latency`), else a rough affine
prior, and prints each dispatch's predicted drain time beside the wall time
the queue took to go idle. `--budget-frames N` caps the frame store at N
frames' bytes (`--budget-policy stall` or `reject`).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import EMVSOptions, run_emvs
from repro_torch.core.pointcloud import concatenate, radius_outlier_filter
from repro_torch.device import resolve_device, to_host
from repro_torch.events.aggregation import EVENTS_PER_FRAME, aggregate
from repro_torch.events.simulator import (
    EVENT_CORRUPTIONS,
    EventStream,
    SceneConfig,
    Trajectory,
    absrel,
    corrupt_stream,
    ground_truth_depth,
    make_scene,
    make_trajectory,
    simulate_events,
    slice_trajectory,
)
from repro_torch.events.stream_hygiene import HygieneConfig, StreamHygieneError
from repro_torch.serving.emvs_stream import (
    HYGIENE_POLICIES,
    EMVSStreamEngine,
    MemoryBudgetError,
    MultiStreamEngine,
    StreamConfig,
    _FrameStore,
    iter_event_chunks,
)

# the cost table the card's streaming benchmark records
COST_TABLE = os.path.join("results", "cost_table_h100.json")


def frame_budget_bytes(n_frames: int) -> int:
    """Byte budget equivalent to holding `n_frames` aggregated frames."""
    one = _FrameStore._frame_bytes(
        np.zeros((EVENTS_PER_FRAME, 2), np.float32),
        np.zeros(EVENTS_PER_FRAME, bool), np.float32(0.0),
        np.zeros((3, 3), np.float32), np.zeros(3, np.float32))
    return n_frames * one


def offline(cam, dsi_cfg, events, traj, opts, dev):
    """`run_emvs` on the card over frames aggregated on the host, as the
    stream's sessions aggregate them."""
    host_events = EventStream(*(a.cpu() for a in events))
    host_traj = Trajectory(traj.times.cpu(), SE3(traj.poses.R.cpu(), traj.poses.t.cpu()))
    frames = aggregate(cam, host_events, host_traj, EVENTS_PER_FRAME, device="cpu")
    return run_emvs(cam, dsi_cfg, frames, opts, device=dev)


def max_dsi_delta(res, ref) -> float:
    assert [s.frame_range for s in res.segments] == [s.frame_range for s in ref.segments]
    return max((float((a.dsi.float() - b.dsi.float()).abs().max())
                for a, b in zip(res.segments, ref.segments)), default=0.0)


def run_multi(args, cam, scene, traj, dsi_cfg, opts, dev) -> dict:
    """N-camera rig: one shared dispatcher, round-robin interleave,
    per-session offline equivalence, cross-stream coalescing summary."""
    engine = MultiStreamEngine(cam, dsi_cfg, opts, StreamConfig(
        sweep=args.sweep, dispatch_policy=args.policy), device=dev)
    feeds = {}
    for i in range(args.sessions):
        ev = simulate_events(cam, scene, traj, noise_fraction=0.02, seed=i, device=dev)
        sess = engine.add_session(f"cam{i}", traj=traj)
        feeds[sess.session_id] = ev
    chunks = {sid: iter_event_chunks(ev, args.chunk_frames * EVENTS_PER_FRAME)
              for sid, ev in feeds.items()}
    print(f"streaming {args.sessions} sessions, round-robin chunks of "
          f"{args.chunk_frames} frame(s)...")
    t0 = time.perf_counter()
    while chunks:
        drained = []
        for sid, it in chunks.items():
            chunk = next(it, None)
            if chunk is None:
                drained.append(sid)
                continue
            for seg in engine.push(sid, chunk):
                print(f"  t={time.perf_counter() - t0:6.2f}s  [{sid}] keyframe {seg.frame_range}")
        for sid in drained:
            del chunks[sid]
    print("end of all streams -> flush")
    results = engine.flush()
    d = engine.stats["dispatcher"]
    print(f"shared dispatcher: {d['segments']} segments in {d['dispatches']} dispatches "
          f"({d['cross_stream_dispatches']} spanning multiple sessions, "
          f"{d['coalesced_segments']} segment(s) coalesced, {d['padded_segments']} padded "
          f"rows, peak queue depth {d['max_pending']})")
    deltas = {}
    for sid, res in results.items():
        deltas[sid] = max_dsi_delta(res, offline(cam, dsi_cfg, feeds[sid], traj, opts, dev))
        print(f"  [{sid}] offline equivalence over {len(res.segments)} segments: "
              f"max |DSI delta| = {deltas[sid]:g}")
    assert all(v == 0.0 for v in deltas.values()), deltas
    print("OK: every session matches its dedicated offline reconstruction")
    return {"results": results, "stats": engine.stats, "max_dsi_delta": deltas}


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the result, the engine's stats and the largest
    DSI difference from the offline reconstruction (None when skipped)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="simulation_3planes",
                    choices=["simulation_3planes", "simulation_3walls",
                             "slider_close", "slider_far"])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--planes", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--chunk-frames", type=int, default=1,
                    help="push granularity, in aggregated frames")
    ap.add_argument("--sweep", default="batched", choices=["batched", "sharded"],
                    help="segment-sweep backend (see StreamConfig.sweep)")
    ap.add_argument("--policy", default="adaptive",
                    choices=["latency", "throughput", "adaptive"],
                    help="dispatch policy of the closed-segment coalescing queue")
    ap.add_argument("--target-latency-ms", type=float, default=None,
                    help="SLO deadline for the adaptive planner (requires --policy "
                         "adaptive); prints predicted vs actual drain time per dispatch")
    ap.add_argument("--pose-lag", type=float, default=None,
                    help="stream poses too, lagging the event front by this many "
                         "seconds (default: fully known pose oracle)")
    ap.add_argument("--max-stall", type=int, default=None,
                    help="pose-gated back-pressure: max frames stalled past the pose "
                         "watermark before push raises PoseStallError")
    ap.add_argument("--sessions", type=int, default=1,
                    help="N > 1 simulates an N-camera rig on one MultiStreamEngine")
    ap.add_argument("--hygiene", default="raise", choices=HYGIENE_POLICIES,
                    help="ingest guard policy for adversarial chunks")
    ap.add_argument("--reorder-slack", type=float, default=0.0,
                    help="reorder-buffer depth in seconds (hygiene=reorder)")
    ap.add_argument("--hot-pixel-limit", type=int, default=None,
                    help="max events per pixel per 50 ms window before the hot-pixel "
                         "guard trips")
    ap.add_argument("--corrupt", default=None, choices=EVENT_CORRUPTIONS,
                    help="fault-inject one corruption mode into the stream")
    ap.add_argument("--budget-frames", type=int, default=None,
                    help="cap the frame store at this many frames' bytes")
    ap.add_argument("--budget-policy", default="stall", choices=["stall", "reject"],
                    help="over-budget admission: stall or reject")
    ap.add_argument("--out", default=os.path.join("results", "emvs_stream_torch.npz"))
    args = ap.parse_args(argv)
    if args.sessions < 1:
        ap.error("--sessions must be >= 1")
    pose_gated = args.pose_lag is not None
    if args.max_stall is not None and not pose_gated:
        ap.error("--max-stall requires --pose-lag: the stall bound only "
                 "applies to a streamed (pose-gated) trajectory")
    if args.target_latency_ms is not None:
        if args.policy != "adaptive":
            ap.error("--target-latency-ms drives the SLO-aware ADAPTIVE "
                     "planner; use --policy adaptive")
        if args.sessions > 1:
            ap.error("--target-latency-ms demos the single-stream SLO "
                     "planner; use --sessions 1")
    if args.corrupt and pose_gated:
        ap.error("--corrupt demos the ingest guard on the plain event "
                 "stream; use it without --pose-lag")
    if args.sessions > 1 and (pose_gated or args.corrupt):
        ap.error("--pose-lag and --corrupt demo a single stream; use --sessions 1")
    dev = resolve_device(args.device)

    with contextlib.ExitStack() as stack:
        if args.sweep == "sharded" and not torch.distributed.is_initialized():
            from repro_torch.distributed.emvs import local_process_group

            stack.enter_context(local_process_group(dev))
        return _demo(args, dev, pose_gated)


def _demo(args, dev, pose_gated: bool) -> dict:
    cam = CameraModel()
    scene = make_scene(SceneConfig(name=args.scene, points_per_plane=args.points))
    traj = make_trajectory(args.scene, args.steps, device=dev)
    events = simulate_events(cam, scene, traj, noise_fraction=0.02, device=dev)
    z = (0.5, 1.8) if args.scene == "slider_close" else (0.6, 4.5)
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=args.planes, z_min=z[0], z_max=z[1])
    opts = EMVSOptions(voting="nearest", formulation="kernel", quantized=True)
    print(f"scene={args.scene} on {dev}: {int(events.valid.sum())} events, DSI "
          f"{dsi_cfg.shape}, chunk={args.chunk_frames} frame(s), sweep={args.sweep}")
    if args.sessions > 1:
        return run_multi(args, cam, scene, traj, dsi_cfg, opts, dev)

    cost_model = None
    if args.target_latency_ms is not None:
        from repro_torch.profiling import AffineCostModel, CostTable
        from repro_torch.profiling.cost_model import model_from_table

        try:
            table = CostTable.load(COST_TABLE)
            cost_model = model_from_table(table)
            print(f"SLO planner: deadline {args.target_latency_ms:g} ms, cost model from "
                  f"{COST_TABLE} ({len(table)} measured variants)")
        except FileNotFoundError:
            # rough prior: a few ms of dispatch overhead plus a per-row rate
            cost_model = AffineCostModel(params={
                "batched": (5e-3, 2e-4), "sharded": (1e-2, 1e-4),
                "batched+kernel": (5e-3, 2e-4), "sharded+kernel": (1e-2, 1e-4)})
            print(f"SLO planner: deadline {args.target_latency_ms:g} ms, built-in affine "
                  f"prior (no {COST_TABLE})")
    engine = EMVSStreamEngine(
        cam, dsi_cfg, None if pose_gated else traj, opts, StreamConfig(
            sweep=args.sweep, dispatch_policy=args.policy,
            target_latency_s=(args.target_latency_ms / 1e3
                              if args.target_latency_ms is not None else None),
            max_stalled_frames=args.max_stall,
            hygiene=HygieneConfig(policy=args.hygiene, reorder_slack=args.reorder_slack,
                                  hot_pixel_limit=args.hot_pixel_limit),
            frame_store_budget_bytes=(frame_budget_bytes(args.budget_frames)
                                      if args.budget_frames else None),
            budget_policy=args.budget_policy),
        cost_model=cost_model, device=dev)
    t0 = time.perf_counter()

    # --target-latency-ms: per-dispatch predicted-vs-actual drain audit
    drain_watch: list = []  # [dispatch #, t_dispatched, predicted_s]
    drain_seen = 0

    def watch_drain() -> None:
        nonlocal drain_seen
        if args.target_latency_ms is None:
            return
        now = time.perf_counter() - t0
        n = engine.stats["dispatches"]
        if n > drain_seen:
            pred = engine.predict_drain_s()
            for k in range(drain_seen + 1, n + 1):
                drain_watch.append([k, now, pred])
            drain_seen = n
        if drain_watch and not engine._inflight and engine.stats["pending_segments"] == 0:
            for k, t_disp, pred in drain_watch:
                print(f"  dispatch #{k}: predicted drain {pred * 1e3:7.1f} ms, actual "
                      f"{(now - t_disp) * 1e3:7.1f} ms")
            drain_watch.clear()

    def report(seg) -> None:
        gt, gtm = ground_truth_depth(cam, scene, seg.T_w_ref)
        err = float(absrel(seg.depth_map.depth, seg.depth_map.mask, gt, gtm))
        px = int(seg.depth_map.mask.sum())
        print(f"  t={time.perf_counter() - t0:6.2f}s  keyframe {seg.frame_range}: "
              f"AbsRel {err:.4f}  {px:6d} px")

    pose_times = to_host(traj.times)
    pose_sent = 0  # pose samples already pushed (pose-gated mode)

    def push_poses_behind(event_front: float) -> list:
        """Tracker model: poses are available up to event_front - lag."""
        nonlocal pose_sent
        hi = int(np.searchsorted(pose_times, event_front - args.pose_lag, side="right"))
        if hi <= pose_sent:
            return []
        lo, pose_sent = pose_sent, hi
        return engine.push_poses(slice_trajectory(traj, lo, hi))

    chunk_events = args.chunk_frames * EVENTS_PER_FRAME
    if args.corrupt:
        chunks = corrupt_stream(events, args.corrupt, chunk_events, seed=0,
                                width=cam.width, height=cam.height)
        print(f"fault injection: {args.corrupt} (mid-stream), hygiene={args.hygiene}")
    else:
        chunks = iter_event_chunks(events, chunk_events)

    def guarded_push(chunk):
        """push with the reject-policy recovery loop: on MemoryBudgetError
        the frames are retained in the backlog; poll() retries admission."""
        try:
            return engine.push(chunk)
        except MemoryBudgetError:
            if args.budget_policy != "reject":
                raise
            print(f"  budget reject (backlog {engine.stats['backlog_frames']} frame(s)); "
                  f"retrying via poll()")
            for _ in range(1000):
                segs = engine.poll()
                if not engine.stats["backlog_frames"]:
                    return segs
            raise

    print("streaming..." + (f" (pose stream lagging {args.pose_lag}s)" if pose_gated else ""))
    try:
        for chunk in chunks:
            for seg in guarded_push(chunk):
                report(seg)
            if pose_gated:
                for seg in push_poses_behind(float(chunk.t[-1])):
                    report(seg)
            watch_drain()
    except StreamHygieneError as e:
        print(f"stream REJECTED by hygiene={args.hygiene!r}: {type(e).__name__}: {e}")
        return {"rejected": e, "stats": engine.stats, "max_dsi_delta": None}
    if pose_gated:
        for seg in push_poses_behind(float("inf")):
            report(seg)
        for seg in engine.finalize_poses():
            report(seg)
        print(f"pose stream done: watermark t={engine.stats['pose_watermark']:.3f}, "
              f"max stall {engine.stats['max_stalled']} frame(s)")
    print("end of stream -> flush")
    known = {s.frame_range for s in engine.result().segments}
    res = engine.flush()
    for seg in res.segments:
        if seg.frame_range not in known:
            report(seg)
    watch_drain()
    if args.target_latency_ms is not None:
        print(f"SLO deadline {args.target_latency_ms:g} ms: {engine.stats['slo_dispatches']} "
              f"deadline-driven dispatch(es), {engine.stats['slo_holds']} hold(s) with "
              f"predicted slack")
    print(f"streamed {engine.stats['frames']} frames, {engine.stats['dispatches']} dispatches "
          f"({engine.stats['padded_segments']} padded segment rows); policy={args.policy}: "
          f"{engine.stats['coalesced_segments']} segment(s) coalesced into "
          f"{engine.stats['coalesced_dispatches']} batched dispatch(es), peak queue depth "
          f"{engine.stats['max_pending']}")
    h = engine.stats["hygiene"]
    if args.hygiene != "off":
        shed = (h["dropped_out_of_order"] + h["dropped_duplicate_events"]
                + h["dropped_out_of_bounds"] + h["dropped_hot_pixel"])
        print(f"hygiene={args.hygiene}: {h['events_in']} events in, {shed} shed, peak "
              f"reorder hold {h['reorder_peak_held']} event(s)")
    if args.budget_frames:
        print(f"budget={args.budget_frames} frame(s): peak frame store "
              f"{engine.stats['frame_store_peak_bytes']} / "
              f"{frame_budget_bytes(args.budget_frames)} bytes, "
              f"{engine.stats['budget_stalls']} stall(s), "
              f"{engine.stats['budget_rejects']} reject(s)")

    # the streamed reconstruction is the offline one, segment for segment,
    # unless the stream was corrupted and the policy sheds or ignores faults
    delta = None
    if args.corrupt and args.hygiene != "reorder":
        print(f"offline equivalence skipped: the {args.corrupt} stream "
              + ("was shed down to a clean subset" if args.hygiene == "drop" else
                 "went in UNGUARDED — results are not trustworthy"))
    else:
        delta = max_dsi_delta(res, offline(cam, dsi_cfg, events, traj, opts, dev))
        print(f"offline equivalence: max |DSI_stream - DSI_offline| = {delta:g}")
        assert delta == 0.0, delta

    cloud = radius_outlier_filter(concatenate(res.clouds), radius=0.08, min_neighbors=2)
    keep = to_host(cloud.valid)
    print(f"merged global map: {int(keep.sum())} points after outlier filtering")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, points=to_host(cloud.points)[keep], weights=to_host(cloud.weights)[keep],
             depth_last=to_host(res.segments[-1].depth_map.depth),
             mask_last=to_host(res.segments[-1].depth_map.mask))
    print(f"wrote {args.out}")
    return {"result": res, "stats": engine.stats, "max_dsi_delta": delta}


if __name__ == "__main__":
    main()
