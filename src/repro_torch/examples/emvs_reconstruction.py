"""Full EMVS reconstruction demo on the port: every pipeline stage, all datapaths.

Walks A -> P -> R -> K -> D -> M on a synthetic sequence, compares the
three voting formulations and the quantized datapath, merges the segments'
point clouds into one global map, removes its outliers, and writes the
reconstruction (merged points, first depth map) to an .npz.

    PYTHONPATH=src python -m repro_torch.examples.emvs_reconstruction \
        [--scene simulation_3walls] [--camera davis346] [--device cpu] \
        [--out results/emvs_recon_torch.npz]

Runs on the CUDA card unless `--device cpu`; there the kernel variant runs
B1 and B2, on the CPU their plain versions. `--camera davis346` sweeps a
346x260 sensor, which B1 votes in two row bands.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.core.camera import CAMERAS
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, run_emvs
from repro_torch.core.pointcloud import concatenate, merge, radius_outlier_filter
from repro_torch.device import resolve_device
from repro_torch.events.aggregation import aggregate
from repro_torch.events.simulator import (
    SceneConfig,
    absrel,
    ground_truth_depth,
    make_scene,
    make_trajectory,
    simulate_events,
)

MERGED_VARIANT = "matmul/nearest + Table-1 quantization"


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the results per variant, their mean AbsRel,
    and the merged global map before and after the outlier filter."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="simulation_3planes",
                    choices=["simulation_3planes", "simulation_3walls",
                             "slider_close", "slider_far"])
    ap.add_argument("--camera", default="davis240", choices=sorted(CAMERAS))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--points", type=int, default=400)
    ap.add_argument("--planes", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join("results", "emvs_recon_torch.npz"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cam = CAMERAS[args.camera]
    scene = make_scene(SceneConfig(name=args.scene, points_per_plane=args.points))
    traj = make_trajectory(args.scene, args.steps, device=dev)
    events = simulate_events(cam, scene, traj, noise_fraction=0.02, device=dev)
    frames = aggregate(cam, events, traj, device=dev)
    z = (0.5, 1.8) if args.scene == "slider_close" else (0.6, 4.5)
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=args.planes, z_min=z[0], z_max=z[1])
    print(f"scene={args.scene} camera={args.camera} on {dev}: "
          f"{int(events.valid.sum())} events, {frames.xy.shape[0]} frames, "
          f"DSI {dsi_cfg.shape}")

    kernels = "CUDA kernels B1+B2" if dev.type == "cuda" else "B1+B2 plain versions (CPU)"
    variants = {
        "scatter/float (original EMVS)": EMVSOptions(
            voting="bilinear", formulation="scatter"),
        "matmul/nearest (Eventor reformulation)": EMVSOptions(
            voting="nearest", formulation="matmul"),
        MERGED_VARIANT: EMVSOptions(
            voting="nearest", formulation="matmul", quantized=True),
        f"{kernels} + quantization": EMVSOptions(
            voting="nearest", formulation="kernel", quantized=True),
    }
    results, mean_absrel = {}, {}
    for name, opts in variants.items():
        t0 = time.perf_counter()
        res = run_emvs(cam, dsi_cfg, frames, opts, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        errs, px = [], 0
        for seg in res.segments:
            gt, gtm = ground_truth_depth(cam, scene, seg.T_w_ref)
            errs.append(float(absrel(seg.depth_map.depth, seg.depth_map.mask, gt, gtm)))
            px += int(seg.depth_map.mask.sum())
        results[name] = res
        mean_absrel[name] = float(np.mean(errs)) if errs else float("nan")
        print(f"{name:44s} AbsRel {mean_absrel[name]:.4f}  "
              f"{px:6d} px  {dt:6.2f}s  ({len(res.segments)} keyframes)")

    # merge + filter the map of the reformulated variant (stage M)
    res = results[MERGED_VARIANT]
    global_map: list = []
    for cloud in res.clouds:
        merge(global_map, cloud)
    merged = concatenate(global_map)
    filtered = radius_outlier_filter(merged, radius=0.08, min_neighbors=2)
    keep = filtered.valid.cpu().numpy()
    print(f"merged global map: {int(merged.valid.sum())} points, "
          f"{int(keep.sum())} after outlier filtering")

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(
        args.out,
        points=filtered.points.cpu().numpy()[keep],
        weights=filtered.weights.cpu().numpy()[keep],
        depth0=res.segments[0].depth_map.depth.cpu().numpy(),
        mask0=res.segments[0].depth_map.mask.cpu().numpy(),
    )
    print(f"wrote {args.out}")
    return {"results": results, "absrel": mean_absrel, "merged": merged,
            "filtered": filtered, "out": args.out}


if __name__ == "__main__":
    main()
