"""The batched segment sweep against the segment-sharded sweep, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.sharded_sweep \\
        [--device cpu] [--dry-run] [--devices N]

Counterpart of the reference's `benchmarks/sharded_sweep.py`.
`run_emvs(sweep="batched")` sweeps each capacity bucket's segments as one
batch; `run_emvs(sweep="sharded")` splits the bucket's segment axis over
the ranks of a `torch.distributed` mesh (`process_segments_sharded`), the
paper's key-frame-level parallelism. The two must agree bitwise on dsi,
depth and mask (nearest voting), on every rank.

Ranks: with a process group already initialized, its ranks. Otherwise
`--devices 1` (the default) runs one rank on the device (NCCL on the card,
gloo on the CPU, rendezvous through a file), and `--devices N` > 1 spawns N
gloo ranks on the CPU, which share its cores: there the outputs that
matter are the bitwise check and the segments/s record, not the speedup.
`--devices N` > 1 with an explicit `--device` other than cpu raises: to
shard across cards, initialize their process group first.
Both paths are measured on their first run in the process and warm (best
of WARM_REPEATS). Rank 0 writes the `sharded_sweep` section of
`BENCH_emvs_torch.json`.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.benchmarks._emvs_common import device_label, update_bench_json
from repro_torch.benchmarks.segment_batching import check_match
from repro_torch.benchmarks.streaming_latency import build_sequence, host_frames
from repro_torch.core.pipeline import plan_segments, run_emvs
from repro_torch.device import resolve_device
from repro_torch.distributed.emvs import (
    SEGMENT_AXIS,
    local_process_group,
    make_segment_mesh,
    segment_axis_size,
)

WARM_REPEATS = 2


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


def run(args) -> dict:
    """The benchmark on every rank of the initialized default group."""
    seq = build_sequence("dry" if args.dry_run else "default", args.device)
    mesh = make_segment_mesh()
    n_ranks = segment_axis_size(mesh)
    frames = host_frames(seq)
    segs = plan_segments(frames, seq.dsi_cfg, seq.opts)
    n_seg = len(segs)
    n_ev = sum(b - a for a, b in segs) * frames.xy.shape[1]
    rank = dist.get_rank()
    if rank == 0:
        print(f"sequence: {frames.xy.shape[0]} frames x {frames.xy.shape[1]} events, {n_seg} "
              f"segments; mesh: {n_ranks} rank(s) on the '{SEGMENT_AXIS}' axis "
              f"({mesh.device_type})")
    res_b, cold_b, warm_b = _measure(
        lambda: run_emvs(seq.cam, seq.dsi_cfg, frames, seq.opts, device=seq.dev), seq.sync)
    res_s, cold_s, warm_s = _measure(
        lambda: run_emvs(seq.cam, seq.dsi_cfg, frames, seq.opts, sweep="sharded", mesh=mesh,
                         device=seq.dev), seq.sync)
    assert len(res_b.segments) == len(res_s.segments) == n_seg
    check_match(res_b, res_s)

    def path(cold, warm):
        return {"cold_s": cold, "warm_s": warm, "cold_segments_per_s": n_seg / cold,
                "warm_segments_per_s": n_seg / warm}

    record = {"dry_run": bool(args.dry_run), **device_label(str(seq.dev)),
              "ranks": n_ranks, "segments": n_seg, "events": int(n_ev),
              "batched": path(cold_b, warm_b), "sharded": path(cold_s, warm_s),
              "bitwise_match": True}
    if rank == 0:
        print(f"numerical match: batched == sharded bitwise (dsi, depth, mask) on "
              f"{n_ranks} rank(s)")
        print(f"\n{'path':<10}{'cold ms':>10}{'cold seg/s':>12}{'warm ms':>10}"
              f"{'warm seg/s':>12}")
        for name, cold, warm in (("batched", cold_b, warm_b), ("sharded", cold_s, warm_s)):
            print(f"{name:<10}{1e3 * cold:>10.2f}{n_seg / cold:>12.2f}{1e3 * warm:>10.2f}"
                  f"{n_seg / warm:>12.2f}")
        print(f"\nsharded/batched warm ratio: {warm_b / warm_s:.2f}x")
        print(f"wrote {update_bench_json('sharded_sweep', record, path=args.json_out)}")
    return record


def _spawned_rank(rank: int, world: int, store: str, args) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or world) // world))
    with local_process_group("cpu", rank=rank, world_size=world, store_path=store):
        run(args)


def main(argv: list[str] | None = None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dry-run", action="store_true", help="the smoke size")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks when no process group is initialized; more than 1 "
                         "spawns that many gloo ranks on the CPU")
    ap.add_argument("--json-out", default=None, help="BENCH_emvs_torch.json path")
    args = ap.parse_args(argv)
    if dist.is_initialized():
        return run(args)
    if args.devices > 1:
        if args.device not in (None, "cpu"):
            raise ValueError(
                f"--devices {args.devices} spawns gloo ranks on the CPU, but --device "
                f"{args.device} was asked for; initialize a process group over the cards "
                f"(torch.distributed.init_process_group) to shard across them")
        args.device = "cpu"
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_spawned_rank, args=(args.devices, os.path.join(tmp, "store"), args),
                     nprocs=args.devices, join=True)
        return None
    with contextlib.ExitStack() as stack:
        stack.enter_context(local_process_group(resolve_device(args.device)))
        return run(args)


if __name__ == "__main__":
    main()
