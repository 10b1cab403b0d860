"""Quickstart: event-based multi-view stereo on the port, in about 30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Simulates a DAVIS240 camera moving past three textured planes, aggregates
1024-event frames, runs `run_emvs` through the CUDA kernels B1 and B2
(their plain versions with `--device cpu`) on the paper's Table-1
datapath, and prints each key-frame segment's AbsRel against the
simulator's ground truth. Runs on the CUDA card unless `--device cpu`.
"""
from __future__ import annotations

import argparse

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, run_emvs
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


def main(argv: list[str] | None = None) -> list[float]:
    """Run the quickstart; returns each segment's AbsRel."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=32, help="trajectory steps")
    ap.add_argument("--points", type=int, default=300, help="scene points per plane")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a DAVIS240-like camera observing three textured planes
    cam = CameraModel()
    scene = make_scene(SceneConfig(name="simulation_3planes", points_per_plane=args.points))
    traj = make_trajectory("simulation_3planes", num_steps=args.steps, device=dev)

    # 2. simulate the event stream + aggregate into 1024-event frames
    events = simulate_events(cam, scene, traj, noise_fraction=0.02, device=dev)
    frames = aggregate(cam, events, traj, device=dev)
    print(f"{int(events.valid.sum())} events -> {frames.xy.shape[0]} frames on {dev}")

    # 3. run EMVS: back-project, vote the DSI, detect structure, build the map
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=64, z_min=0.6, z_max=4.5)
    result = run_emvs(cam, dsi_cfg, frames,
                      EMVSOptions(voting="nearest", formulation="kernel",
                                  quantized=True),  # paper Table-1 datapath
                      device=dev)

    # 4. evaluate against ground truth
    errs = []
    for seg in result.segments:
        gt, gt_mask = ground_truth_depth(cam, scene, seg.T_w_ref)
        dm = seg.depth_map
        errs.append(float(absrel(dm.depth, dm.mask, gt, gt_mask)))
        print(f"segment frames {seg.frame_range}: "
              f"{int(dm.mask.sum())} semi-dense px, AbsRel {errs[-1]:.4f}")
    return errs


if __name__ == "__main__":
    main()
