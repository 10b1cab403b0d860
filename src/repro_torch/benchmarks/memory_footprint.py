"""Paper section 2.3 on the port: "our hybrid data quantization strategy can
save up to 50% of the memory requirement and data transferring bandwidth".

    PYTHONPATH=src python -m repro_torch.benchmarks.memory_footprint [--device cpu]

Counterpart of the reference's `benchmarks/memory_footprint.py`. First
table: bytes per 1024-event frame of each datapath value, float32 against
Table 1 (`quant.policies.memory_report`, from shapes). Second table: the
streaming host window. Each session keeps its aggregated frames in a host
`_FrameStore` until the open segment no longer needs them, counting live
and peak resident bytes; a small stream shows that the peak stays below
the whole sequence's footprint and that nothing is resident after
`flush`. Writes the `memory_footprint` section of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks._emvs_common import update_bench_json
from repro_torch.core.camera import CameraModel
from repro_torch.quant.policies import memory_report


def run() -> dict:
    rep = memory_report(CameraModel(), num_planes=128, events_per_frame=1024)
    f32 = sum(rep["float32"].values())
    q = sum(rep["table1"].values())
    return {"float32_bytes_per_frame": f32, "table1_bytes_per_frame": q,
            "saving": 1 - q / f32, "detail": rep, "claim_ok": bool(q <= 0.55 * f32)}


def run_streaming_window(device=None) -> dict:
    """Stream a small sequence and report the host frame window: peak
    resident bytes against the whole sequence's (every frame in one
    `_FrameStore`), and the live bytes after flush (must be 0)."""
    from repro_torch.benchmarks.streaming_latency import build_sequence, host_frames
    from repro_torch.serving.emvs_stream import (
        EMVSStreamEngine,
        StreamConfig,
        _FrameStore,
        iter_event_chunks,
    )

    seq = build_sequence("dry", device)
    engine = EMVSStreamEngine(seq.cam, seq.dsi_cfg, seq.traj, seq.opts,
                              StreamConfig(events_per_frame=seq.e_frame), device=seq.dev)
    for chunk in iter_event_chunks(seq.ev, seq.e_frame):
        engine.push(chunk)
    res = engine.flush()
    stats = engine.stats
    whole_store = _FrameStore()
    whole_store.extend(host_frames(seq))
    whole = whole_store.live_bytes
    return {
        "frames": int(stats["frames"]),
        "segments": len(res.segments),
        "live_bytes_after_flush": int(stats["frame_store_bytes"]),
        "peak_bytes": int(stats["frame_store_peak_bytes"]),
        "whole_sequence_bytes": int(whole),
        "peak_fraction_of_sequence": stats["frame_store_peak_bytes"] / whole if whole else 0.0,
        "window_ok": bool(stats["frame_store_bytes"] == 0
                          and 0 < stats["frame_store_peak_bytes"] <= whole),
    }


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    args = ap.parse_args(argv)
    out = run()
    print("== section 2.3 memory footprint (bytes per 1024-event frame + DSI) ==")
    print(f"{'item':14s} {'float32':>12s} {'table1':>12s}")
    for k in out["detail"]["float32"]:
        print(f"{k:14s} {out['detail']['float32'][k]:12d} {out['detail']['table1'][k]:12d}")
    print(f"total: {out['float32_bytes_per_frame']} -> {out['table1_bytes_per_frame']} bytes "
          f"({out['saving'] * 100:.1f}% saved; paper: 'up to 50%'; "
          f"{'OK' if out['claim_ok'] else 'VIOLATED'})")
    win = run_streaming_window(args.device)
    print("\n== streaming host frame window (live/peak byte accounting) ==")
    print(f"frames aggregated:       {win['frames']}")
    print(f"segments swept:          {win['segments']}")
    print(f"whole sequence resident: {win['whole_sequence_bytes']} bytes")
    print(f"peak window resident:    {win['peak_bytes']} bytes "
          f"({win['peak_fraction_of_sequence'] * 100:.1f}% of sequence)")
    print(f"live after flush:        {win['live_bytes_after_flush']} bytes")
    print("OK: eviction bounds the window and flush drains it"
          if win["window_ok"] else "VIOLATED: window accounting broken")
    record = {**out, "streaming_window": win}
    print(f"wrote {update_bench_json('memory_footprint', record, path=args.json_out)}")
    return record


if __name__ == "__main__":
    main()
