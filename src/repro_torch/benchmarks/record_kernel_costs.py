"""Record cost-table rows for the fused-kernel sweep backend, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.record_kernel_costs \\
        [--device cpu] [--dry-run] [--table results/cost_table_h100.json]

Counterpart of the reference's `benchmarks/record_kernel_costs.py`. The
DispatchPlanner prices only the variants its table has samples for. This
times `sweep_segment_batch` with `formulation="kernel"` (on the card, one
launch each of B1 and B2) on synthetic batches at the (s_bucket, capacity)
points of GRID, float and, at a few points, Table-1 quantized, and merges
the warm wall times under the `batched+kernel` backend
(`cost_table.backend_name`). A time is the host's clock around one sweep
that ends in a device synchronize: what a dispatch of that shape costs the
stream. `--dry-run` times one tiny point and writes nothing.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, sweep_segment_batch
from repro_torch.device import resolve_device
from repro_torch.profiling.cost_table import CostTable, VariantKey, backend_name

# the (s_bucket, capacity) points the reference's matmul rows cover
GRID = ((1, 4), (1, 8), (1, 12), (2, 8), (2, 12), (4, 8), (4, 12))


def synthetic_batch(s: int, c: int, e: int, cam: CameraModel, device,
                    seed: int = 0) -> SegmentBatch:
    rng = np.random.default_rng(seed)
    xy = rng.uniform((0, 0), (cam.width - 1, cam.height - 1), (s, c, e, 2)).astype(np.float32)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (s, c, 3, 3)).copy()
    t = np.zeros((s, c, 3), np.float32)
    t[..., 0] = np.linspace(0.0, 0.05 * c, c, dtype=np.float32)
    return SegmentBatch(*(torch.as_tensor(a).to(device) for a in (
        xy, np.ones((s, c, e), bool), np.ones((s, c), bool), R, t, R[:, 0], t[:, 0])))


def record(table: CostTable, *, events: int, repeats: int,
           quantized_points: tuple[tuple[int, int], ...],
           grid: tuple[tuple[int, int], ...] = GRID, device=None) -> list[str]:
    dev = resolve_device(device)
    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=32)
    backend = backend_name("batched", "kernel")
    rows = []
    jobs = [(s, c, False) for s, c in grid] + [(s, c, True) for s, c in quantized_points]
    for s, c, quantized in jobs:
        opts = EMVSOptions(voting="nearest", formulation="kernel", quantized=quantized)
        batch = synthetic_batch(s, c, events, cam, dev)
        key = VariantKey(s_bucket=s, capacity=c, backend=backend, interpolation="nearest",
                         quantized=quantized)

        def run_once():
            sweep_segment_batch(cam, dsi_cfg, batch, opts)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        run_once()  # the first call is never recorded
        for _ in range(repeats):
            t0 = time.perf_counter()
            run_once()
            table.record(key, time.perf_counter() - t0)
        stats = table.entry_stats(key)
        rows.append(f"{key.to_str()}: mean {1e3 * stats['mean_s']:.3f} ms over "
                    f"{stats['count']} warm run(s)")
        print(rows[-1], flush=True)
    return rows


def main(argv: list[str] | None = None) -> CostTable:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--dry-run", action="store_true",
                    help="one tiny grid point, few events; does NOT write the table")
    ap.add_argument("--table", default=None,
                    help="table to merge into (default results/cost_table_h100.json on "
                         "the card, results/cost_table_cpu.json on the CPU)")
    ap.add_argument("--events", type=int, default=1024, help="events per aggregated frame")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    table = CostTable()
    if args.dry_run:
        record(table, events=64, repeats=1, grid=((1, 4),), quantized_points=((1, 4),),
               device=dev)
        print("dry run: table not written")
        return table
    record(table, events=args.events, repeats=args.repeats,
           quantized_points=((1, 4), (1, 8), (1, 12)), device=dev)
    path = args.table or os.path.join(
        "results", "cost_table_h100.json" if dev.type == "cuda" else "cost_table_cpu.json")
    try:
        merged = CostTable.load(path)
    except FileNotFoundError:
        merged = CostTable()
    merged.merge(table)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    merged.save(path)
    print(f"merged {len(table)} kernel-backend variant(s) into {path} ({len(merged)} total)")
    return merged


if __name__ == "__main__":
    main()
