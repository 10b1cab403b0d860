"""Live mapping: an open loop of event packets and tracker poses.

Each camera of the rig sweeps its arc forward and back (`sim.live_stream`).
Its events go out in packets of `packet_events`, each when its last event
falls due, and its trajectory samples when their times fall due, all
cameras' items merged in order of due time. One camera is served by an
`EMVSStreamEngine`, several by one `MultiStreamEngine`, both with
`StreamConfig`'s defaults and poses streamed (`push_poses`).

Set-up feeds the first `warmup_s` of stream time as fast as the engine
takes it, which builds and warms every dispatch shape, and drains it. Then
stream time is pinned to the host clock and the loop offers every later
item at its due time, polling the engine while it waits. A segment's
latency runs from the due time of the last event of its last frame to the
moment a `push`, `push_poses`, `poll` or a final `flush` returns it. The
window holds the segments whose last event falls due in
[warmup_s, warmup_s + seconds); after it the stream runs on for `tail_s`,
and anything still missing is drained by `flush` (at most a minute).
Once the loop has ended, a sample of the window's segments drawn from the
seed is compared with the reference.

A traced run (`--trace 1`) runs the same loop over the same window, with
the profiler recording the card's activity over the whole of it; the
per-layer metrics read the window's push calls, dispatches and device
operations.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

from bench.harness import check, port, sim
from bench.harness.cli import Outcome, Run
from bench.reference import emvs as ref

POSE, EVENTS = 0, 1
DRAIN_LIMIT_S = 60.0
LEAD_S = 0.02


def schedule(streams: list[sim.Stream], packet: int) -> np.ndarray:
    """(due_s, camera, kind, lo, hi) rows in order of due time: event
    packets [lo, hi) and single trajectory samples lo."""
    rows = []
    for c, s in enumerate(streams):
        lo = np.arange(0, s.t.shape[0], packet)
        hi = np.minimum(lo + packet, s.t.shape[0])
        rows.append(np.stack([s.t[hi - 1].astype(np.float64), np.full(lo.shape, c),
                              np.full(lo.shape, EVENTS), lo, hi], 1))
        k = np.arange(s.pose_t.shape[0])
        rows.append(np.stack([s.pose_t.astype(np.float64), np.full(k.shape, c),
                              np.full(k.shape, POSE), k, k + 1], 1))
    rows = np.concatenate(rows)
    return rows[np.lexsort((rows[:, 2], rows[:, 0]))]


class Rig:
    """The engine and its sessions, behind one camera-indexed interface."""

    def __init__(self, cam, dsi_cfg, opts, n_cams: int, device):
        from repro_torch.serving.emvs_stream import (
            EMVSStreamEngine,
            MultiStreamEngine,
            StreamConfig,
        )

        self.multi = n_cams > 1
        if self.multi:
            self.engine = MultiStreamEngine(cam, dsi_cfg, opts, StreamConfig(), device=device)
            self.ids = [f"cam{c}" for c in range(n_cams)]
            for sid in self.ids:
                self.engine.add_session(sid)
        else:
            self.engine = EMVSStreamEngine(cam, dsi_cfg, None, opts, StreamConfig(),
                                           device=device)
            self.ids = [None]

    def push(self, c: int, chunk) -> list:
        if self.multi:
            return [(c, r) for r in self.engine.push(self.ids[c], chunk)]
        return [(0, r) for r in self.engine.push(chunk)]

    def push_poses(self, c: int, chunk) -> list:
        if self.multi:
            return [(c, r) for r in self.engine.push_poses(self.ids[c], chunk)]
        return [(0, r) for r in self.engine.push_poses(chunk)]

    def poll(self) -> list:
        if self.multi:
            return [(self.ids.index(sid), r) for sid, rs in self.engine.poll().items()
                    for r in rs]
        return [(0, r) for r in self.engine.poll()]

    def flush(self) -> list:
        if self.multi:
            out = self.engine.flush()
            return [(self.ids.index(sid), r) for sid, res in out.items() for r in res.segments]
        return [(0, r) for r in self.engine.flush().segments]

    def dispatches(self) -> int:
        st = self.engine.stats
        return int(st["dispatcher"]["dispatches"] if self.multi else st["dispatches"])

    def result(self, c: int):
        return self.engine.result(self.ids[c]) if self.multi else self.engine.result()


def run(r: Run) -> Outcome:
    cfg, tr, dev = r.cfg, r.traffic, r.device
    cam, dsi_cfg, opts = port.build(cfg)
    epf = int(cfg["emvs"]["events_per_frame"])
    n_cams = int(tr["cameras"])
    warm, tail = float(tr["warmup_s"]), float(tr["tail_s"])
    w_end = warm + r.seconds
    streams = [sim.live_stream(cfg, tr, r.seed, c, w_end + tail) for c in range(n_cams)]
    items = schedule(streams, int(tr["packet_events"]))
    chunks = [(port.event_stream(s.xy, s.t, s.polarity, s.valid),
               port.trajectory(s.pose_t, s.pose_R, s.pose_p)) for s in streams]
    rig = Rig(cam, dsi_cfg, opts, n_cams, dev)
    span = r.tracer.span
    arrived: dict[tuple[int, tuple[int, int]], float] = {}
    calls = {"push_calls": 0, "push_s": 0.0, "late_s": []}

    def note(got, now):
        for c, seg in got:
            arrived.setdefault((c, tuple(seg.frame_range)), now)

    def offer(i: int) -> None:
        _, c, kind, lo, hi = items[i]
        c, lo, hi = int(c), int(lo), int(hi)
        ev, traj = chunks[c]
        t0 = time.perf_counter()
        if kind == EVENTS:
            with span("push"):
                got = rig.push(c, type(ev)(*(f[lo:hi] for f in ev)))
        else:
            with span("push_poses"):
                got = rig.push_poses(c, type(traj)(traj.times[lo:hi], type(traj.poses)(
                    traj.poses.R[lo:hi], traj.poses.t[lo:hi])))
        t1 = time.perf_counter()
        calls["push_calls"] += 1
        calls["push_s"] += t1 - t0
        note(got, t1)

    # set-up: the first `warm` seconds of stream as fast as the engine takes it
    i = 0
    while i < len(items) and items[i, 0] < warm:
        offer(i)
        i += 1
    drain(rig, dev, note)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    arrived.clear()
    port.settle()

    def loop(i: int, until_s: float, base: float) -> int:
        while i < len(items) and items[i, 0] < until_s:
            due = base + items[i, 0]
            now = time.perf_counter()
            if now < due:
                with span("poll"):
                    got = rig.poll()
                note(got, time.perf_counter())
                rest = due - time.perf_counter()
                if rest > 0:
                    with span("sleep"):
                        time.sleep(min(rest, 1e-3))
                continue
            calls["late_s"].append(now - due)
            offer(i)
            i += 1
        return i

    with r.tracer.window():
        base = time.perf_counter() - warm + LEAD_S
        setup_s = base + warm - r.t_start
        d0, n0 = rig.dispatches(), len(arrived)
        calls.update(push_calls=0, push_s=0.0)
        i = loop(i, w_end, base)
        layer_ctx = {"dispatches": rig.dispatches() - d0, "segments": len(arrived) - n0,
                     "push_calls": calls["push_calls"], "push_s": calls["push_s"]}
        late = np.asarray(calls["late_s"]) if calls["late_s"] else np.zeros(1)
    layer_ctx["summary"] = r.tracer.summary
    i = loop(i, float("inf"), base)
    drain(rig, dev, note)
    peak = port.memory_peak(dev)

    frames, in_window, plans = window_plan(cfg, streams, warm, w_end, dev)
    missing = [(c, seg) for c, seg, _ in in_window if (c, seg) not in arrived]
    if missing:
        note(rig.flush(), time.perf_counter())
        missing = [(c, seg) for c, seg, _ in in_window if (c, seg) not in arrived]
    lat = np.asarray([arrived[(c, seg)] - (base + t) for c, seg, t in in_window
                      if (c, seg) in arrived])
    e2e = {"setup_s": setup_s,
           "depth_p50_ms": 1e3 * float(np.percentile(lat, 50)) if lat.size else float("nan"),
           "depth_p95_ms": 1e3 * float(np.percentile(lat, 95)) if lat.size else float("nan")}
    e2e["generator_late_p95_ms"] = 1e3 * float(np.percentile(late, 95))
    if lat.size:
        layer_ctx["depth_p95_ms"] = e2e["depth_p95_ms"]
    if lat.size >= 8:  # a growing backlog shows as a later quarter slower than the first
        q = lat.size // 4
        e2e["first_quarter_p50_ms"] = 1e3 * float(np.median(lat[:q]))
        e2e["last_quarter_p50_ms"] = 1e3 * float(np.median(lat[-q:]))
    print(f"live: {len(in_window)} segments due in the window, generator late "
          f"p50 {1e3 * np.percentile(late, 50):.3f} ms, p95 "
          f"{1e3 * np.percentile(late, 95):.3f} ms over {late.size} items, push mean "
          f"{1e3 * layer_ctx['push_s'] / max(layer_ctx['push_calls'], 1):.4f} ms over "
          f"{layer_ctx['push_calls']} calls, {layer_ctx['segments']} segments in "
          f"{layer_ctx['dispatches']} dispatches, latency p50 {e2e['depth_p50_ms']:.3f} "
          f"p95 {e2e['depth_p95_ms']:.3f} ms", file=sys.stderr)

    t_ref = time.perf_counter()
    tally = check.Tally()
    tally.worst("missing", len(missing))
    stray = [k for k in arrived
             if warm <= due_time(streams, k, epf) < w_end and k[1] not in plans[k[0]]]
    tally.worst("plan", len(stray))
    pool = [(c, seg) for c, seg, _ in in_window if (c, seg) in arrived]
    by_cam: dict[int, dict] = {}
    for c, seg in sample(r.seed, pool, int(tr["sample_segments"])):
        if c not in by_cam:
            res = rig.result(c)
            by_cam[c] = {tuple(s.frame_range): (s, pc) for s, pc in zip(res.segments,
                                                                        res.clouds)}
        out = port.segment_outputs(*by_cam[c][seg])
        for name, value in check.segment_gaps(out, ref.segment(frames[c], seg, cfg)).items():
            tally.worst(name, value)
    print(f"live: reference comparison {time.perf_counter() - t_ref:.2f} s",
          file=sys.stderr)
    return Outcome(end_to_end=e2e, layer_ctx=layer_ctx, attempted=len(in_window),
                   failed=len(missing), memory_peak_bytes=peak, checks=tally.values)


def window_plan(cfg: dict, streams: list[sim.Stream], warm: float, w_end: float, dev,
                dtype=torch.float32):
    """The reference's frames of each stream, the segments of its plan whose
    last event falls due in [warm, w_end) as (camera, segment, due), and
    each stream's plan as a set."""
    e = cfg["emvs"]
    epf = int(e["events_per_frame"])
    threshold = float(e["keyframe_dist_frac"]) * 0.5 * (float(e["z_min"]) + float(e["z_max"]))
    frames, in_window, plans = [], [], []
    for c, s in enumerate(streams):
        fr = ref.make_frames(s.xy, s.t, s.valid, s.pose_t, s.pose_R, s.pose_p,
                             events_per_frame=epf, keep_tail=False, device=dev, dtype=dtype)
        plan = ref.plan_segments(fr.p, threshold)
        frames.append(fr)
        plans.append(set(plan))
        for seg in plan:
            t = float(s.t[seg[1] * epf - 1])
            if warm <= t < w_end:
                in_window.append((c, seg, t))
    return frames, in_window, plans


def sample(seed: int, pool: list, k: int) -> list:
    """`k` entries of `pool` drawn from the seed, in pool order."""
    if not pool:
        return []
    pick = np.random.default_rng(seed).choice(len(pool), size=min(len(pool), k),
                                              replace=False)
    return [pool[j] for j in sorted(int(x) for x in pick)]


def due_time(streams, key, epf: int) -> float:
    c, (_, end) = key
    return float(streams[c].t[end * epf - 1])


def drain(rig: Rig, dev, note) -> None:
    """Wait for the device and harvest until nothing more comes."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < DRAIN_LIMIT_S:
        port.synchronize(dev)
        got = rig.poll()
        note(got, time.perf_counter())
        if not got and rig.engine.stats.get("pending_segments", 0) == 0 and (
                not rig.multi or rig.engine.stats["dispatcher"]["pending_segments"] == 0):
            return
