"""Streaming EMVS latency on the port: time to the first depth map against
the offline sweep, dispatch policies, multi-stream coalescing, session
churn, and the sweep cost table the SLO-aware planner prices with.

    PYTHONPATH=src python -m repro_torch.benchmarks.streaming_latency \\
        [--device cpu] [--dry-run | --main-path] \\
        [--cost-table results/cost_table_h100.json]

Counterpart of the reference's `benchmarks/streaming_latency.py`, section
for section:

  * headline: the offline path (host aggregation plus `run_emvs`) cannot
    emit anything before the whole trajectory has arrived; the streaming
    engine closes a key-frame segment the moment the K criterion trips.
    First-segment latency must be below the offline end-to-end time, and
    the streamed result must equal the offline one bitwise. The distinct
    dispatch shapes (from a `SweepProfiler`'s trace) stay within
    |segment_buckets| x |capacities|;
  * the pose-lag sweep: the pose stream trails the event front by 0, 10%
    and 30% of the sequence; results stay bitwise offline's;
  * `dispatch_policy_sweep`: "latency", "throughput" and "adaptive" under
    a per-frame trickle and a whole-stream burst, warm, best of N repeats
    round-robin; the gate: adaptive coalesces under burst (structural) and
    sustains at least `min_ratio` of the per-segment baseline's segments/s;
  * `multi_stream_sweep`: N trickle sessions on one `MultiStreamEngine`
    against N dedicated engines ("throughput"); the gate (structural):
    at least one cross-stream group and fewer dispatches in all;
  * `session_churn_sweep`: stayers, a leaver and a joiner under load; the
    gate (structural): cross-stream groups on both sides of the change and
    an empty queue at the end;
  * `cost_model_section`: every warm policy and churn run carries a
    `SweepProfiler` that records warm, unshadowed sweep wall times into one
    `CostTable`, saved to `--cost-table` (on the card by default
    `results/cost_table_h100.json`), fitted by the affine model and held to
    the burst replay gate `dispatch_replay.check_slo_burst`.

Sizes: `--dry-run` is the reference's smoke (96 steps, 100 points per
plane, 256-event frames, 8 planes); the default the reference's full run
(144 steps, 200 points, 512 events, 16 planes); `--main-path` the port's
EMVS main path (96 steps, the simulator's default scene, 1024-event frames
of DAVIS240, 128 planes, keyframe fraction 0.05). Voting is nearest and
Table-1 quantized on the fused-kernel formulation: on the card every
dispatch runs B1 and B2. The port compiles nothing per shape, so every
section is measured warm, after one run of each sweep variant. Runs on the
card unless `--device cpu`; times on the CPU are the host's clock. Every
section goes into `BENCH_emvs_torch.json` before the gates assert.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks._emvs_common import device_label, update_bench_json
from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import (
    EMVSOptions,
    bucket_capacity,
    pad_segments,
    plan_segments,
    process_segments_batched,
    run_emvs,
)
from repro_torch.core.pointcloud import depth_maps_to_points
from repro_torch.device import resolve_device, to_host
from repro_torch.events.aggregation import aggregate
from repro_torch.events.simulator import (
    EventStream,
    SceneConfig,
    Trajectory,
    make_scene,
    make_trajectory,
    simulate_events,
    slice_trajectory,
)
from repro_torch.profiling import CostTable, SweepProfiler, fit_affine_model
from repro_torch.serving.dispatch_replay import check_slo_burst
from repro_torch.serving.emvs_stream import (
    EMVSStreamEngine,
    MultiStreamEngine,
    StreamConfig,
    iter_event_chunks,
)

# (trajectory steps, points per plane or None for the scene's default,
# events per frame, planes, keyframe fraction) per size
SIZES = {"dry": (96, 100, 256, 8, 0.02), "default": (144, 200, 512, 16, 0.02),
         "main": (96, None, 1024, 128, 0.05)}


@dataclasses.dataclass
class Sequence:
    cam: CameraModel
    traj: Trajectory  # on the host
    ev: EventStream  # on the host, as a camera hands it over
    e_frame: int
    dsi_cfg: DSIConfig
    opts: EMVSOptions
    dev: torch.device

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


def build_sequence(size: str = "dry", device=None) -> Sequence:
    dev = resolve_device(device)
    steps, points, e_frame, planes, frac = SIZES[size]
    cam = CameraModel()
    scene_cfg = SceneConfig(name="simulation_3planes")
    if points is not None:
        scene_cfg = dataclasses.replace(scene_cfg, points_per_plane=points)
    traj = make_trajectory("simulation_3planes", steps, device="cpu")
    ev = simulate_events(cam, make_scene(scene_cfg), traj, noise_fraction=0.02, seed=0,
                         device="cpu")
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=planes, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True,
                       keyframe_dist_frac=frac)
    return Sequence(cam, traj, ev, e_frame, dsi_cfg, opts, dev)


def host_frames(seq: Sequence):
    """The sequence's frames aggregated on the host, as a session does."""
    return aggregate(seq.cam, seq.ev, seq.traj, events_per_frame=seq.e_frame, device="cpu")


def offline(seq: Sequence):
    """Host aggregation plus `run_emvs` on the device: the offline wall."""
    res = run_emvs(seq.cam, seq.dsi_cfg, host_frames(seq), seq.opts, device=seq.dev)
    seq.sync()
    return res


def _assert_bitwise(res, ref, what: str) -> None:
    assert [s.frame_range for s in res.segments] == \
        [s.frame_range for s in ref.segments], f"{what}: boundaries diverged"
    for sa, sb in zip(res.segments, ref.segments):
        for a, b, name in ((sa.dsi, sb.dsi, "dsi"),
                           (sa.depth_map.depth, sb.depth_map.depth, "depth"),
                           (sa.depth_map.mask, sb.depth_map.mask, "mask")):
            assert torch.equal(a, b), f"{what}: {name} of {sa.frame_range} differs (must be bitwise)"


def _warm_variants(seq: Sequence, frames, segs, scfg) -> None:
    """Run every (S bucket x frame capacity) sweep a stream could dispatch
    once, with its point clouds, so the timed runs find the device's
    allocator and libraries warm."""
    for cap in sorted({bucket_capacity(b - a) for a, b in segs}):
        seg = next(s for s in segs if bucket_capacity(s[1] - s[0]) == cap)
        for s_bucket in scfg.segment_buckets:
            batch = pad_segments(frames, [seg] * s_bucket, cap)
            batch = type(batch)(*(t.to(seq.dev) for t in batch))
            _, dms = process_segments_batched(seq.cam, seq.dsi_cfg, batch, seq.opts)
            depth_maps_to_points(seq.cam, dms, SE3(batch.ref_R, batch.ref_t))
    seq.sync()


def _stream_once(seq: Sequence, scfg, chunk_events: int, profiler=None):
    """One timed stream: per-segment completion timeline and stats, with
    the host ingest per push: the pushes' wall less the time spent inside
    the dispatcher's `_dispatch` (staging and enqueueing sweeps), over the
    pushes."""
    engine = EMVSStreamEngine(seq.cam, seq.dsi_cfg, seq.traj, seq.opts, scfg,
                              profiler=profiler, device=seq.dev)
    timeline: list[tuple[float, tuple[int, int]]] = []
    push_s, pushes = 0.0, 0
    t0 = time.perf_counter()
    for c in iter_event_chunks(seq.ev, chunk_events):
        t_push = time.perf_counter()
        done = engine.push(c)
        now = time.perf_counter()
        push_s += now - t_push
        pushes += 1
        for seg in done:
            timeline.append((now - t0, seg.frame_range))
    ingest_s = push_s - engine._dispatcher.host_dispatch_s
    res = engine.flush()
    seq.sync()
    t_total = time.perf_counter() - t0
    seen = {fr for _, fr in timeline}
    timeline += [(t_total, s.frame_range) for s in res.segments if s.frame_range not in seen]
    return res, t_total, timeline, dict(engine.stats,
                                        ingest_ms_per_push=1e3 * ingest_s / max(pushes, 1))


def stream_with_pose_lag(seq: Sequence, scfg, lag_s: float, chunk_events: int):
    """Stream events with the pose stream trailing the event front by
    `lag_s` seconds. Returns (result, first-depth latency, end-to-end
    time, engine stats)."""
    engine = EMVSStreamEngine(seq.cam, seq.dsi_cfg, None, seq.opts, scfg, device=seq.dev)
    pose_t = to_host(seq.traj.times)
    sent = 0
    first = None
    t0 = time.perf_counter()
    for chunk in iter_event_chunks(seq.ev, chunk_events):
        if engine.push(chunk) and first is None:
            first = time.perf_counter() - t0
        hi = int(np.searchsorted(pose_t, float(chunk.t[-1]) - lag_s, side="right"))
        if hi > sent:
            got = engine.push_poses(slice_trajectory(seq.traj, sent, hi))
            sent = hi
            if got and first is None:
                first = time.perf_counter() - t0
    if sent < pose_t.shape[0]:
        got = engine.push_poses(slice_trajectory(seq.traj, sent, pose_t.shape[0]))
        if got and first is None:
            first = time.perf_counter() - t0
    engine.finalize_poses()
    res = engine.flush()
    seq.sync()
    t_total = time.perf_counter() - t0
    return res, (t_total if first is None else first), t_total, engine.stats


def dispatch_policy_sweep(seq: Sequence, frames, ref, repeats: int,
                          table: CostTable | None = None) -> list[dict]:
    """Sustained segments/s and p50/p99 first-depth latency per (load
    profile x dispatch policy), warm, best of `repeats` run round-robin.
    Every run is held bitwise to offline. With `table`, every run carries
    a fresh `SweepProfiler` feeding it."""
    n_events = int(seq.ev.t.shape[0])
    segs = plan_segments(frames, seq.dsi_cfg, seq.opts)
    scfg_by_policy = {
        policy: StreamConfig(events_per_frame=seq.e_frame, dispatch_policy=policy)
        for policy in ("latency", "throughput", "adaptive")}
    _warm_variants(seq, frames, segs, next(iter(scfg_by_policy.values())))
    configs = [(profile, chunk_events, policy)
               for profile, chunk_events in (("burst", n_events), ("trickle", seq.e_frame))
               for policy in scfg_by_policy]
    best: dict = {}
    for _ in range(repeats):
        for cfg in configs:
            profile, chunk_events, policy = cfg
            profiler = SweepProfiler(table=table) if table is not None else None
            res, t_total, timeline, stats = _stream_once(
                seq, scfg_by_policy[policy], chunk_events, profiler=profiler)
            _assert_bitwise(res, ref, f"policy={policy} {profile}")
            if cfg not in best or t_total < best[cfg][0]:
                best[cfg] = (t_total, timeline, stats, len(res.segments))
    rows = []
    print(f"\ndispatch-policy sweep (warm, best of {repeats}, interleaved):")
    print(f"{'profile':<10}{'policy':<12}{'seg/s':>8}{'p50 ms':>9}"
          f"{'p99 ms':>9}{'dispatches':>11}{'coalesced':>10}{'max queue':>10}")
    for cfg in configs:
        profile, _, policy = cfg
        t_total, timeline, stats, n_segs = best[cfg]
        lat = np.asarray([t for t, _ in timeline], np.float64)
        row = {
            "profile": profile,
            "policy": policy,
            "segments_per_s": n_segs / t_total,
            "end_to_end_s": t_total,
            "first_depth_p50_s": float(np.percentile(lat, 50)),
            "first_depth_p99_s": float(np.percentile(lat, 99)),
            "dispatches": int(stats["dispatches"]),
            "coalesced_dispatches": int(stats["coalesced_dispatches"]),
            "coalesced_segments": int(stats["coalesced_segments"]),
            "max_pending": int(stats["max_pending"]),
        }
        rows.append(row)
        print(f"{profile:<10}{policy:<12}{row['segments_per_s']:>8.2f}"
              f"{1e3 * row['first_depth_p50_s']:>9.2f}{1e3 * row['first_depth_p99_s']:>9.2f}"
              f"{row['dispatches']:>11d}{row['coalesced_dispatches']:>10d}"
              f"{row['max_pending']:>10d}")
    print("OK: every policy x profile is bitwise-equal to offline")
    return rows


def _churn_config(seq: Sequence, n_ref: int) -> StreamConfig:
    # a top S bucket that does NOT divide the per-session segment count, so
    # some run leaves a partial bucket that only cross-stream coalescing
    # fills (S cannot be divisible by all of 4, 3, 5 and 7 below ~400)
    top = next(b for b in (4, 3, 5, 7) if n_ref % b != 0)
    return StreamConfig(events_per_frame=seq.e_frame, dispatch_policy="throughput",
                        segment_buckets=(1, 2, top) if top > 2 else (1, 2))


def multi_stream_sweep(seq: Sequence, frames, ref, n_sessions: int) -> dict:
    """N concurrent trickle streams: one shared dispatcher against N
    dedicated engines, under "throughput" (a schedule set by load shape
    alone, so the gate is deterministic)."""
    segs = plan_segments(frames, seq.dsi_cfg, seq.opts)
    n_ref = len(ref.segments)
    scfg = _churn_config(seq, n_ref)
    _warm_variants(seq, frames, segs, scfg)
    chunk_events = seq.e_frame

    ded_stats: list[dict] = []
    ded_p99: list[float] = []
    t_ded = 0.0
    for i in range(n_sessions):
        res, t_total, timeline, stats = _stream_once(seq, scfg, chunk_events)
        _assert_bitwise(res, ref, f"dedicated[{i}]")
        ded_p99.append(float(np.percentile(np.asarray([t for t, _ in timeline]), 99)))
        ded_stats.append(stats)
        t_ded += t_total

    engine = MultiStreamEngine(seq.cam, seq.dsi_cfg, seq.opts, scfg, device=seq.dev)
    handles = [engine.add_session(traj=seq.traj) for _ in range(n_sessions)]
    times: dict[str, list[float]] = {h.session_id: [] for h in handles}
    t0 = time.perf_counter()
    for chunk in iter_event_chunks(seq.ev, chunk_events):
        for h in handles:
            for _seg in h.push(chunk):
                times[h.session_id].append(time.perf_counter() - t0)
    for h in handles:
        res = h.flush()
        t_now = time.perf_counter() - t0
        _assert_bitwise(res, ref, f"multi session {h.session_id}")
        times[h.session_id] += [t_now] * (len(res.segments) - len(times[h.session_id]))
    seq.sync()
    t_multi = time.perf_counter() - t0
    d = engine.stats["dispatcher"]
    assert d["pending_segments"] == 0, "multi engine left work queued"

    def _fill(seg_total: int, padded: int) -> float:
        return seg_total / (seg_total + padded) if seg_total + padded else 1.0

    dedicated = {
        "dispatches": sum(s["dispatches"] for s in ded_stats),
        "padded_segments": sum(s["padded_segments"] for s in ded_stats),
        "segments": sum(s["segments"] for s in ded_stats),
        "aggregate_segments_per_s": n_sessions * n_ref / t_ded,
        "end_to_end_s": t_ded,
        "per_session_p99_s": ded_p99,
    }
    dedicated["bucket_fill_rate"] = _fill(dedicated["segments"], dedicated["padded_segments"])
    multi_p99 = {sid: float(np.percentile(np.asarray(ts), 99)) for sid, ts in times.items()}
    multi = {
        "dispatches": int(d["dispatches"]),
        "padded_segments": int(d["padded_segments"]),
        "segments": int(d["segments"]),
        "cross_stream_dispatches": int(d["cross_stream_dispatches"]),
        "coalesced_dispatches": int(d["coalesced_dispatches"]),
        "aggregate_segments_per_s": n_sessions * n_ref / t_multi,
        "end_to_end_s": t_multi,
        "per_session_p99_s": multi_p99,
        "bucket_fill_rate": _fill(int(d["segments"]), int(d["padded_segments"])),
    }
    print(f"\nmulti-stream sweep ({n_sessions} trickle sessions x {n_ref} segments, "
          f"policy=throughput, buckets {scfg.segment_buckets}):")
    print(f"{'arrangement':<14}{'agg seg/s':>10}{'p99 ms':>9}{'dispatches':>11}"
          f"{'fill rate':>10}{'cross':>7}")
    print(f"{'dedicated xN':<14}{dedicated['aggregate_segments_per_s']:>10.2f}"
          f"{1e3 * max(ded_p99):>9.2f}{dedicated['dispatches']:>11d}"
          f"{dedicated['bucket_fill_rate']:>10.3f}{'-':>7}")
    print(f"{'multi-stream':<14}{multi['aggregate_segments_per_s']:>10.2f}"
          f"{1e3 * max(multi_p99.values()):>9.2f}{multi['dispatches']:>11d}"
          f"{multi['bucket_fill_rate']:>10.3f}{multi['cross_stream_dispatches']:>7d}")
    print(f"OK: all {n_sessions} multi-stream sessions are bitwise-equal to offline")
    return {"sessions": n_sessions, "segments_per_session": n_ref,
            "segment_buckets": list(scfg.segment_buckets), "policy": "throughput",
            "multi": multi, "dedicated": dedicated}


def session_churn_sweep(seq: Sequence, frames, ref, n_stayers: int,
                        table: CostTable | None = None) -> dict:
    """Membership churn under load: `n_stayers` trickle sessions plus a
    double-rate leaver that flushes out mid-run and a double-rate joiner
    admitted after it. Every session pushes the whole sequence and must
    equal offline bitwise."""
    segs = plan_segments(frames, seq.dsi_cfg, seq.opts)
    n_ref = len(ref.segments)
    scfg = _churn_config(seq, n_ref)
    _warm_variants(seq, frames, segs, scfg)
    profiler = SweepProfiler(table=table) if table is not None else None
    engine = MultiStreamEngine(seq.cam, seq.dsi_cfg, seq.opts, scfg, profiler=profiler,
                               device=seq.dev)
    chunks = list(iter_event_chunks(seq.ev, seq.e_frame))
    half = len(chunks) // 2
    times: dict[str, list[float]] = {}
    t0 = time.perf_counter()

    def _track(handle, emitted) -> None:
        now = time.perf_counter() - t0
        times.setdefault(handle.session_id, []).extend([now] * len(emitted))

    def _settle(handle, res) -> None:
        done = times.setdefault(handle.session_id, [])
        done += [time.perf_counter() - t0] * (len(res.segments) - len(done))

    stayers = [engine.add_session(f"stay{i}", traj=seq.traj) for i in range(n_stayers)]
    leaver = engine.add_session("leaver", traj=seq.traj)
    for i, chunk in enumerate(chunks[:half]):
        for h in stayers:
            _track(h, h.push(chunk))
        for j in (2 * i, 2 * i + 1):
            if j < len(chunks):
                _track(leaver, leaver.push(chunks[j]))
    for j in range(2 * half, len(chunks)):
        _track(leaver, leaver.push(chunks[j]))
    cross_before = int(engine.stats["dispatcher"]["cross_stream_dispatches"])
    res_leaver = leaver.flush()
    _settle(leaver, res_leaver)
    _assert_bitwise(res_leaver, ref, "churn leaver")

    joiner = engine.add_session("joiner", traj=seq.traj)
    rest = chunks[half:]
    for i, chunk in enumerate(rest):
        for h in stayers:
            _track(h, h.push(chunk))
        for j in (2 * i, 2 * i + 1):
            if j < len(chunks):
                _track(joiner, joiner.push(chunks[j]))
    for j in range(2 * len(rest), len(chunks)):
        _track(joiner, joiner.push(chunks[j]))
    for h in [*stayers, joiner]:
        res = h.flush()
        _settle(h, res)
        _assert_bitwise(res, ref, f"churn session {h.session_id}")
    seq.sync()
    t_total = time.perf_counter() - t0

    d = engine.stats["dispatcher"]
    record = {
        "stayers": n_stayers,
        "segments_per_session": n_ref,
        "segment_buckets": list(scfg.segment_buckets),
        "policy": "throughput",
        "end_to_end_s": t_total,
        "aggregate_segments_per_s": (n_stayers + 2) * n_ref / t_total,
        "per_session_p99_s": {sid: float(np.percentile(np.asarray(ts), 99))
                              for sid, ts in times.items()},
        "dispatches": int(d["dispatches"]),
        "segments": int(d["segments"]),
        "coalesced_dispatches": int(d["coalesced_dispatches"]),
        "cross_stream_dispatches": int(d["cross_stream_dispatches"]),
        "cross_stream_before_leave": cross_before,
        "cross_stream_after_join": int(d["cross_stream_dispatches"]) - cross_before,
        "pending_segments": int(d["pending_segments"]),
    }
    print(f"\nsession-churn sweep ({n_stayers} stayers + leaver + joiner x {n_ref} segments, "
          f"policy=throughput, buckets {scfg.segment_buckets}):")
    print(f"  {record['dispatches']} dispatches / {record['segments']} segments, "
          f"cross-stream {cross_before} before leave + {record['cross_stream_after_join']} "
          f"after join, agg {record['aggregate_segments_per_s']:.2f} seg/s, p99 "
          f"{1e3 * max(record['per_session_p99_s'].values()):.2f} ms")
    print(f"OK: all {n_stayers + 2} churned sessions are bitwise-equal to offline")
    return record


def cost_model_section(table: CostTable, table_path: str) -> dict:
    """Save the measured cost table, fit the affine model, and run the
    burst replay gate per measured backend. The gates assert in the caller
    after the section is written."""
    os.makedirs(os.path.dirname(os.path.abspath(table_path)), exist_ok=True)
    table.save(table_path)
    _, report = fit_affine_model(table)
    print(f"\ncost model ({len(table)} measured variants -> {table_path}):")
    for key in sorted(table.keys(), key=lambda k: k.to_str()):
        st = table.entry_stats(key)
        print(f"  {key.to_str()}: mean {1e3 * st['mean_s']:.3f} ms over {st['count']} "
              f"warm sweep(s)")
    for backend, rec in sorted(report["backends"].items()):
        print(f"  [{backend}] overhead {rec['overhead_s'] * 1e3:.3f} ms + "
              f"{rec['rate_s_per_row'] * 1e6:.2f} us/row; rel error mean "
              f"{100 * rec['mean_rel_error']:.1f}% max {100 * rec['max_rel_error']:.1f}%")
    gates = []
    for backend in sorted({key.backend for key in table.keys()}):
        try:
            g = check_slo_burst(table, backend=backend)
        except AssertionError as exc:
            gates.append({"backend": backend, "failure": str(exc)})
            continue
        gates.append(g)
        tp, slo = g["throughput"], g["slo_adaptive"]
        print(f"  [{g['backend']}] burst replay: throughput {tp['dispatch_count']} "
              f"dispatches p99 {1e3 * tp['predicted_p99_s']:.2f} ms; SLO-adaptive "
              f"{slo['dispatch_count']} dispatches p99 {1e3 * slo['predicted_p99_s']:.2f} ms "
              f"(deadline {1e3 * g['target_latency_s']:.2f} ms)")
    return {"table_path": table_path, "measured_variants": len(table),
            "entries": table.to_json()["entries"], "calibration": report,
            "slo_burst_gates": gates}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--dry-run", action="store_true",
                      help="the reference's smoke size (same code path, loose timing gate)")
    size.add_argument("--main-path", action="store_true",
                      help="the EMVS main path's size (1024-event frames, 128 planes)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--chunk-frames", type=int, default=1, help="chunk size in frames")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    ap.add_argument("--cost-table", default=None,
                    help="where to save the measured sweep cost table (default "
                         "results/cost_table_h100.json on the card, "
                         "results/cost_table_cpu.json on the CPU)")
    args = ap.parse_args(argv)

    seq = build_sequence("dry" if args.dry_run else "main" if args.main_path else "default",
                         args.device)
    loose = args.dry_run or args.main_path
    # best of N per (profile, policy): on the main path one burst run's wall
    # varies by a fifth between identical runs on the card's host, more than
    # the one dispatch that coalescing saves there, so it takes more samples
    repeats = 3 if args.dry_run else 9 if args.main_path else 5
    table_path = args.cost_table or os.path.join(
        "results", "cost_table_h100.json" if seq.dev.type == "cuda" else "cost_table_cpu.json")
    label = device_label(str(seq.dev))
    frames = host_frames(seq)
    segs = plan_segments(frames, seq.dsi_cfg, seq.opts)
    caps = sorted({bucket_capacity(b - a) for a, b in segs})
    n_events = int(seq.ev.t.shape[0])
    print(f"on {label['device']} ({label['card']}): {n_events} events -> "
          f"{frames.xy.shape[0]} frames x {seq.e_frame} events, {len(segs)} segments, "
          f"capacities {caps}, {seq.dsi_cfg.num_planes} planes")

    # --- headline: offline against streaming, warm ------------------------
    scfg = StreamConfig(events_per_frame=seq.e_frame)
    chunk_events = args.chunk_frames * seq.e_frame
    offline(seq)
    _stream_once(seq, scfg, chunk_events)
    t0 = time.perf_counter()
    ref = offline(seq)
    t_offline = time.perf_counter() - t0
    profiler = SweepProfiler()
    res, t_total, timeline, stream_stats = _stream_once(seq, scfg, chunk_events,
                                                        profiler=profiler)
    _assert_bitwise(res, ref, "streaming (nearest voting)")
    variants = len({d.key for d in profiler.dispatches})
    bound = len(scfg.segment_buckets) * len(caps)
    assert variants <= bound, f"{variants} dispatch shapes exceed the bound {bound}"
    first = timeline[0][0]
    print(f"\nnumerical match: bitwise ({len(res.segments)} segments); dispatch shapes: "
          f"{variants} (bound {bound})")
    print(f"\n{'metric':<34}{'offline':>12}{'streaming':>12}")
    print(f"{'end-to-end ms':<34}{1e3 * t_offline:>12.2f}{1e3 * t_total:>12.2f}")
    print(f"{'first depth map ms':<34}{1e3 * t_offline:>12.2f}{1e3 * first:>12.2f}")
    print(f"{'events/s (M)':<34}{n_events / t_offline / 1e6:>12.3f}"
          f"{n_events / t_total / 1e6:>12.3f}")
    print(f"per-segment completion times (ms): "
          f"{', '.join(f'{1e3 * t:.2f}' for t, _ in timeline)}")
    print(f"host ingest per push: {stream_stats['ingest_ms_per_push']:.3f} ms "
          f"({chunk_events}-event chunks)")
    assert first < t_offline, (
        f"first-segment latency {first:.4f}s not below offline end-to-end {t_offline:.4f}s")
    print("OK: first depth map arrives before the offline path finishes")

    # --- pose-lag sweep -----------------------------------------------------
    t_ev = to_host(seq.ev.t)
    duration = float(t_ev[-1]) - float(t_ev[0])
    print(f"\npose-lag sweep (sequence duration {duration:.2f}s):")
    print(f"{'lag s':<10}{'first depth ms':>15}{'end-to-end ms':>15}{'max stalled':>12}"
          f"{'watermark':>12}")
    pose_lag_rows = []
    for lag in (0.0, round(0.1 * duration, 4), round(0.3 * duration, 4)):
        lag_res, lag_first, lag_total, stats = stream_with_pose_lag(seq, scfg, lag,
                                                                    chunk_events)
        _assert_bitwise(lag_res, ref, f"pose lag {lag}s")
        print(f"{lag:<10.3f}{1e3 * lag_first:>15.2f}{1e3 * lag_total:>15.2f}"
              f"{stats['max_stalled']:>12d}{stats['pose_watermark']:>12.3f}")
        pose_lag_rows.append({
            "lag_s": lag, "first_depth_latency_s": lag_first, "end_to_end_s": lag_total,
            "max_stalled_frames": int(stats["max_stalled"]),
            "pose_watermark": float(stats["pose_watermark"]),
            "pose_chunks": int(stats["pose_chunks"])})
    print("OK: reconstruction is pose-lag invariant (bitwise)")

    # --- dispatch-policy sweep ---------------------------------------------
    cost_table = CostTable()
    policy_rows = dispatch_policy_sweep(seq, frames, ref, repeats=repeats, table=cost_table)
    burst = {r["policy"]: r for r in policy_rows if r["profile"] == "burst"}
    # structural: adaptive coalesces under burst; timing: its segments/s
    # is at least min_ratio of the per-segment baseline: strict on the full
    # run, a loose barrier on the smoke and main-path runs, whose bursts of
    # a few segments save one or two dispatches, less than their walls'
    # jitter between runs
    gate = {
        "profile": "burst",
        "adaptive_segments_per_s": burst["adaptive"]["segments_per_s"],
        "latency_segments_per_s": burst["latency"]["segments_per_s"],
        "adaptive_dispatches": burst["adaptive"]["dispatches"],
        "adaptive_coalesced_dispatches": burst["adaptive"]["coalesced_dispatches"],
        "segments": len(ref.segments),
        "min_ratio": 0.85 if loose else 1.0,
    }
    update_bench_json("dispatch_policy_sweep", {
        "dry_run": bool(args.dry_run), "main_path": bool(args.main_path), **label,
        "rows": policy_rows, "gate": gate}, path=args.json_out)

    multi_rec = multi_stream_sweep(seq, frames, ref, n_sessions=3 if loose else 4)
    update_bench_json("multi_stream_sweep", {
        "dry_run": bool(args.dry_run), "main_path": bool(args.main_path), **label,
        **multi_rec}, path=args.json_out)
    churn_rec = session_churn_sweep(seq, frames, ref, n_stayers=2 if loose else 3,
                                    table=cost_table)
    update_bench_json("session_churn", {
        "dry_run": bool(args.dry_run), "main_path": bool(args.main_path), **label,
        **churn_rec}, path=args.json_out)
    cost_rec = cost_model_section(cost_table, table_path)
    update_bench_json("cost_model", {
        "dry_run": bool(args.dry_run), "main_path": bool(args.main_path), **label,
        **cost_rec}, path=args.json_out)
    headline = {
        "dry_run": bool(args.dry_run), "main_path": bool(args.main_path), **label,
        "events": n_events, "segments": len(res.segments),
        "offline_end_to_end_s": t_offline, "streaming_end_to_end_s": t_total,
        "first_depth_latency_s": first, "first_depth_speedup": t_offline / first,
        "chunk_events": chunk_events, "ingest_ms_per_push": stream_stats["ingest_ms_per_push"],
        "dispatch_shapes": variants, "dispatch_shape_bound": bound,
        "stream_stats": {k: v for k, v in stream_stats.items() if not isinstance(v, dict)},
        "pose_lag_sweep": pose_lag_rows}
    print(f"wrote {update_bench_json('streaming_latency', headline, path=args.json_out)}")

    # the gates, after every section is written
    assert (gate["adaptive_coalesced_dispatches"] >= 1
            and gate["adaptive_dispatches"] < gate["segments"]), (
        f"REGRESSION: adaptive policy stopped coalescing under burst "
        f"({gate['adaptive_dispatches']} dispatches for {gate['segments']} segments)")
    floor = gate["min_ratio"] * gate["latency_segments_per_s"]
    assert gate["adaptive_segments_per_s"] >= floor, (
        f"REGRESSION: adaptive policy sustains {gate['adaptive_segments_per_s']:.3f} "
        f"segments/s under burst, below {gate['min_ratio']:g}x the per-segment baseline "
        f"{gate['latency_segments_per_s']:.3f}")
    print(f"OK: adaptive coalesces under burst ({gate['adaptive_dispatches']} dispatches / "
          f"{gate['segments']} segments) and sustains {gate['adaptive_segments_per_s']:.2f} "
          f"segments/s vs the per-segment baseline {gate['latency_segments_per_s']:.2f}")
    m, ded = multi_rec["multi"], multi_rec["dedicated"]
    assert m["cross_stream_dispatches"] >= 1, (
        "REGRESSION: the shared dispatcher never issued a cross-stream group")
    assert m["dispatches"] < ded["dispatches"], (
        f"REGRESSION: cross-stream coalescing stopped reducing dispatches "
        f"({m['dispatches']} shared vs {ded['dispatches']} dedicated)")
    print(f"OK: cross-stream coalescing cuts dispatches {ded['dispatches']} -> "
          f"{m['dispatches']} ({m['cross_stream_dispatches']} cross-stream groups)")
    assert churn_rec["pending_segments"] == 0, (
        "REGRESSION: dispatcher left work queued after session churn")
    assert (churn_rec["cross_stream_before_leave"] >= 1
            and churn_rec["cross_stream_after_join"] >= 1), (
        f"REGRESSION: cross-stream coalescing died across the membership change "
        f"({churn_rec['cross_stream_before_leave']} before the leave, "
        f"{churn_rec['cross_stream_after_join']} after the join)")
    assert churn_rec["dispatches"] < churn_rec["segments"], (
        "REGRESSION: no coalescing under churn")
    print("OK: coalescing survives session churn")
    failed = [g for g in cost_rec["slo_burst_gates"] if "failure" in g]
    assert not failed, ("REGRESSION: SLO burst replay gate failed: "
                        + "; ".join(f"[{g['backend']}] {g['failure']}" for g in failed))
    assert cost_rec["measured_variants"] >= 1, "REGRESSION: profiler recorded no warm sweep"
    print(f"OK: SLO burst replay gate passed on the measured table "
          f"({cost_rec['measured_variants']} variants -> {cost_rec['table_path']})")
    return {"streaming_latency": headline, "dispatch_policy_sweep": policy_rows,
            "gate": gate, "multi_stream_sweep": multi_rec, "session_churn": churn_rec,
            "cost_model": cost_rec}


if __name__ == "__main__":
    main()
