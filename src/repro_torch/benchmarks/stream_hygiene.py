"""Ingest hygiene on the port: what the guard costs, and what it survives.

    PYTHONPATH=src python -m repro_torch.benchmarks.stream_hygiene \\
        [--device cpu] [--dry-run]

Counterpart of the reference's `benchmarks/stream_hygiene.py`; one
`"stream_hygiene"` section of `BENCH_emvs_torch.json`:

  * clean-stream overhead: the same per-frame trickle through the
    streaming engine with `hygiene="off"` against `"raise"`, warm, best of
    N round-robin; the gate: at most 5% of end-to-end time (50% on the
    `--dry-run` smoke, a crash barrier). A scrub-only rate (Mevents/s
    through `StreamHygiene.scrub`) rides along;
  * adversarial grid: every `corrupt_stream` mode through the engine
    under `"raise"` and `"reorder"`: each run raises the expected typed
    error, or equals the clean stream's result bitwise (structural);
  * hot-pixel storm: a burst under `"drop"` with a per-pixel limit; the
    engine must survive, shed the storm and give every segment.

Sizes and options are `streaming_latency`'s (`--dry-run` the reference's
smoke). Runs on the card unless `--device cpu`; the section is written
before the gates assert.
"""
from __future__ import annotations

import argparse
import time
import warnings

import numpy as np

from repro_torch.benchmarks._emvs_common import device_label, update_bench_json
from repro_torch.benchmarks.streaming_latency import (
    Sequence,
    _assert_bitwise,
    _warm_variants,
    build_sequence,
    host_frames,
    offline,
)
from repro_torch.core.pipeline import plan_segments
from repro_torch.device import to_host
from repro_torch.events.simulator import EVENT_CORRUPTIONS, corrupt_stream
from repro_torch.events.stream_hygiene import (
    DuplicateChunkError,
    HotPixelError,
    HygieneConfig,
    NonMonotoneEventError,
    OutOfBoundsEventError,
    StreamHygiene,
    StreamHygieneError,
    StreamHygieneWarning,
    StreamOverlapError,
)
from repro_torch.serving.emvs_stream import EMVSStreamEngine, StreamConfig, iter_event_chunks

# expected response per (corruption mode, hygiene policy): an error type
# (must raise exactly it) or "bitwise" (must reproduce the clean result)
GRID_EXPECT = {
    ("shuffle_events", "raise"): NonMonotoneEventError,
    ("swap_chunks", "raise"): StreamOverlapError,
    ("duplicate_chunk", "raise"): DuplicateChunkError,
    ("out_of_bounds", "raise"): OutOfBoundsEventError,
    ("hot_pixel", "raise"): HotPixelError,
    ("shuffle_events", "reorder"): "bitwise",
    ("swap_chunks", "reorder"): "bitwise",
    ("duplicate_chunk", "reorder"): DuplicateChunkError,
    ("out_of_bounds", "reorder"): OutOfBoundsEventError,
    ("hot_pixel", "reorder"): HotPixelError,
}
HOT_PIXEL_LIMIT = 24
HOT_PIXEL_BURST = 96


def _stream_once(seq: Sequence, scfg, chunks):
    engine = EMVSStreamEngine(seq.cam, seq.dsi_cfg, seq.traj, seq.opts, scfg, device=seq.dev)
    t0 = time.perf_counter()
    for c in chunks:
        engine.push(c)
    res = engine.flush()
    seq.sync()
    return res, time.perf_counter() - t0, engine.stats


def clean_overhead(seq: Sequence, frames, ref, repeats: int) -> dict:
    """Warm best-of-N trickle runs, hygiene off against raise (both bitwise)."""
    chunks = list(iter_event_chunks(seq.ev, seq.e_frame))
    cfgs = {p: StreamConfig(events_per_frame=seq.e_frame, hygiene=p) for p in ("off", "raise")}
    _warm_variants(seq, frames, plan_segments(frames, seq.dsi_cfg, seq.opts),
                         cfgs["off"])
    best = {p: float("inf") for p in cfgs}
    for _ in range(repeats):  # round-robin so machine noise spreads evenly
        for p, scfg in cfgs.items():
            res, dt, _ = _stream_once(seq, scfg, chunks)
            _assert_bitwise(res, ref, f"hygiene={p} trickle")
            best[p] = min(best[p], dt)
    hyg = StreamHygiene(HygieneConfig(policy="raise"), width=seq.cam.width,
                        height=seq.cam.height)
    t0 = time.perf_counter()
    for c in chunks:
        hyg.scrub(c)
    scrub_s = time.perf_counter() - t0
    n_events = int(seq.ev.t.shape[0])
    return {"off_best_s": best["off"], "raise_best_s": best["raise"],
            "overhead_ratio": best["raise"] / best["off"] - 1.0,
            "scrub_mevents_per_s": n_events / scrub_s / 1e6,
            "chunks": len(chunks), "events": n_events}


def adversarial_grid(seq: Sequence, ref) -> list[dict]:
    """Every corruption x {raise, reorder} through the engine: rejected
    with the expected type, or bitwise the clean result."""
    rows = []
    for mode in EVENT_CORRUPTIONS:
        bad = corrupt_stream(seq.ev, mode, seq.e_frame, seed=7, width=seq.cam.width,
                             height=seq.cam.height, burst=HOT_PIXEL_BURST)
        spans = [float(t.max() - t.min()) for t in (to_host(c.t) for c in bad) if t.shape[0]]
        slack = 2.0 * max(spans)
        for policy in ("raise", "reorder"):
            hyg = HygieneConfig(policy=policy, reorder_slack=slack,
                                hot_pixel_limit=HOT_PIXEL_LIMIT)
            scfg = StreamConfig(events_per_frame=seq.e_frame, hygiene=hyg)
            want = GRID_EXPECT[(mode, policy)]
            try:
                res, _, _ = _stream_once(seq, scfg, bad)
                _assert_bitwise(res, ref, f"{mode}/{policy}")
                outcome = "bitwise"
            except StreamHygieneError as e:
                outcome = f"raised:{type(e).__name__}"
            expected = want if isinstance(want, str) else f"raised:{want.__name__}"
            rows.append({"mode": mode, "policy": policy, "outcome": outcome,
                         "expected": expected, "ok": outcome == expected})
            print(f"  {mode:<16}{policy:<9}{outcome:<28}"
                  f"{'OK' if outcome == expected else 'UNEXPECTED'}")
    return rows


def storm_survival(seq: Sequence, ref) -> dict:
    """A hot-pixel storm under hygiene="drop": the engine must survive,
    shed the storm, and keep producing depth maps."""
    bad = corrupt_stream(seq.ev, "hot_pixel", seq.e_frame, seed=7, width=seq.cam.width,
                         height=seq.cam.height, burst=HOT_PIXEL_BURST)
    scfg = StreamConfig(events_per_frame=seq.e_frame,
                        hygiene=HygieneConfig(policy="drop", hot_pixel_limit=HOT_PIXEL_LIMIT))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", StreamHygieneWarning)
        res, dt, stats = _stream_once(seq, scfg, bad)
    return {"burst_events": HOT_PIXEL_BURST, "hot_pixel_limit": HOT_PIXEL_LIMIT,
            "dropped_hot_pixel": int(stats["hygiene"]["dropped_hot_pixel"]),
            "segments": len(res.segments), "clean_segments": len(ref.segments),
            "end_to_end_s": dt}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dry-run", action="store_true",
                    help="the reference's smoke size (same asserts, looser timing gate)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    args = ap.parse_args(argv)

    seq = build_sequence("dry" if args.dry_run else "default", args.device)
    frames = host_frames(seq)
    ref = offline(seq)
    print(f"sequence: {int(seq.ev.t.shape[0])} events, {int(frames.xy.shape[0])} frames, "
          f"{len(ref.segments)} segments on {seq.dev}")
    repeats = 3 if args.dry_run else 5
    overhead = clean_overhead(seq, frames, ref, repeats)
    print(f"\nclean-stream overhead (warm, best of {repeats}): off="
          f"{1e3 * overhead['off_best_s']:.2f} ms raise={1e3 * overhead['raise_best_s']:.2f} "
          f"ms -> {100 * overhead['overhead_ratio']:.1f}% (scrub alone: "
          f"{overhead['scrub_mevents_per_s']:.3f} Mevents/s)")
    print("\nadversarial grid (full engine):")
    grid = adversarial_grid(seq, ref)
    storm = storm_survival(seq, ref)
    print(f"\nhot-pixel storm under drop: {storm['segments']} segments (clean: "
          f"{storm['clean_segments']}), {storm['dropped_hot_pixel']} storm events shed")

    max_overhead = 0.5 if args.dry_run else 0.05
    gate = {"max_overhead": max_overhead, "overhead_ratio": overhead["overhead_ratio"],
            "grid_ok": all(r["ok"] for r in grid),
            "storm_survived": storm["segments"] == storm["clean_segments"]
            and storm["dropped_hot_pixel"] > 0}
    record = {"dry_run": bool(args.dry_run), **device_label(str(seq.dev)),
              "overhead": overhead, "adversarial_grid": grid, "hot_pixel_storm": storm,
              "gate": gate}
    print(f"\nwrote {update_bench_json('stream_hygiene', record, path=args.json_out)}")

    assert gate["grid_ok"], ("adversarial grid: unexpected outcome(s): "
                             + str([r for r in grid if not r["ok"]]))
    assert gate["storm_survived"], f"hot-pixel storm not survived: {storm}"
    assert overhead["overhead_ratio"] <= max_overhead, (
        f"hygiene overhead {100 * overhead['overhead_ratio']:.1f}% exceeds the "
        f"{100 * max_overhead:.0f}% gate")
    return record


if __name__ == "__main__":
    main()
