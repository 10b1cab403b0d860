"""Looped per-segment EMVS against the padded batched segment sweep, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.segment_batching \\
        [--device cpu] [--dry-run]

Counterpart of the reference's `benchmarks/segment_batching.py`.
`run_emvs_looped` sweeps one key-frame segment per call; `run_emvs` pads
segments into multiple-of-four frame-capacity buckets and sweeps each
bucket in one call (on the card: one launch of B1 and one of B2 per
bucket). Reported per path: the first run in the process ("cold": kernel
loading, allocator growth) and the best of WARM_REPEATS warm runs, as
segments/s and Mev/s of real (unpadded) events. The two must agree
bitwise on dsi and mask (nearest voting). Sizes are the reference's (144
steps, 200 points per plane, 512-event frames, 16 planes); `--dry-run`
the streaming benchmarks' smoke size. Times on the card end in a device
synchronize; with `--device cpu` they are the host's clock. Writes the
`segment_batching` section of `BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.benchmarks._emvs_common import device_label, update_bench_json
from repro_torch.benchmarks.streaming_latency import build_sequence, host_frames
from repro_torch.core.pipeline import plan_segments, run_emvs, run_emvs_looped

WARM_REPEATS = 3


def _measure(fn, sync):
    t0 = time.perf_counter()
    res = fn()
    sync()
    cold = time.perf_counter() - t0
    warm = float("inf")
    for _ in range(WARM_REPEATS):
        t0 = time.perf_counter()
        fn()
        sync()
        warm = min(warm, time.perf_counter() - t0)
    return res, cold, warm


def check_match(a, b) -> None:
    """Nearest votes are integral counts: the two paths agree bitwise."""
    assert len(a.segments) == len(b.segments), "segment count mismatch"
    for sa, sb in zip(a.segments, b.segments):
        assert sa.frame_range == sb.frame_range
        assert torch.equal(sa.dsi, sb.dsi), f"dsi of {sa.frame_range} differs"
        assert torch.equal(sa.depth_map.mask, sb.depth_map.mask)
        assert torch.equal(sa.depth_map.depth, sb.depth_map.depth)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dry-run", action="store_true", help="the smoke size")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    args = ap.parse_args(argv)

    seq = build_sequence("dry" if args.dry_run else "default", args.device)
    frames = host_frames(seq)
    opts = seq.opts
    segs = plan_segments(frames, seq.dsi_cfg, opts)
    lengths = sorted({b - a for a, b in segs})
    n_seg = len(segs)
    n_ev = sum(b - a for a, b in segs) * frames.xy.shape[1]
    print(f"sequence: {frames.xy.shape[0]} frames x {frames.xy.shape[1]} events, {n_seg} "
          f"segments, lengths {lengths}, on {seq.dev}")

    res_l, cold_l, warm_l = _measure(
        lambda: run_emvs_looped(seq.cam, seq.dsi_cfg, frames, opts, device=seq.dev), seq.sync)
    res_b, cold_b, warm_b = _measure(
        lambda: run_emvs(seq.cam, seq.dsi_cfg, frames, opts, device=seq.dev), seq.sync)
    check_match(res_l, res_b)
    print("numerical match: looped == batched bitwise (dsi, depth, mask)")
    print(f"\n{'path':<10}{'cold ms':>10}{'cold seg/s':>12}{'cold Mev/s':>12}"
          f"{'warm ms':>10}{'warm seg/s':>12}{'warm Mev/s':>12}")
    for name, cold, warm in (("looped", cold_l, warm_l), ("batched", cold_b, warm_b)):
        print(f"{name:<10}{1e3 * cold:>10.2f}{n_seg / cold:>12.2f}{n_ev / cold / 1e6:>12.3f}"
              f"{1e3 * warm:>10.2f}{n_seg / warm:>12.2f}{n_ev / warm / 1e6:>12.3f}")
    print(f"\nbatched sweep speedup: {cold_l / cold_b:.2f}x cold, {warm_l / warm_b:.2f}x warm")

    def path(cold, warm):
        return {"cold_s": cold, "warm_s": warm, "cold_segments_per_s": n_seg / cold,
                "warm_segments_per_s": n_seg / warm}

    record = {"dry_run": bool(args.dry_run), **device_label(str(seq.dev)),
              "segments": n_seg, "events": int(n_ev), "bitwise_match": True,
              "looped": path(cold_l, warm_l), "batched": path(cold_b, warm_b),
              "cold_speedup": cold_l / cold_b, "warm_speedup": warm_l / warm_b}
    print(f"wrote {update_bench_json('segment_batching', record, path=args.json_out)}")
    return record


if __name__ == "__main__":
    main()
