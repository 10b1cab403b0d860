#!/usr/bin/env python3
"""Device time of the sweep kernel (B1) and the depth max/argmax (B2) at the
EMVS main path's shapes, for the checkout this file sits in.

    python3 bench_sweep.py

Builds the inputs `run_emvs` gives B1 on the main path (the
simulation_3planes scene over a 96-step arc, 1024-event frames, the
DAVIS240 camera, 128 planes, Table-1 quantized; the capacity bucket with
most segments: S=2 segments of C=40 frames) and its first segment alone
(S=1). At each, B1 is first held bitwise against its plain version, then
B1 and B2 are timed as device time (`chip_smoke.graph_ms`: a CUDA graph of
20 calls replayed between CUDA events) beside the host-inclusive eager
time (`chip_smoke.cuda_ms`). Uses only the package's public functions and
the `chip_smoke.py` beside it, so a copy of this file at the root of
another commit's tree (`git archive`, PR 13 or later) times that commit's
kernels, built into that tree's own `build/`.

Prints one JSON line per bucket and last the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))


def main_bucket():
    """`(xy0, valid, phi, cam, nz)`: B1's inputs for the main path's bucket
    with most segments, as `run_emvs` builds them."""
    import torch

    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.geometry import SE3
    from repro_torch.core.pipeline import (
        EMVSOptions,
        bucket_capacity,
        pad_segments,
        plan_segments,
        precompute_batch_geometry,
    )
    from repro_torch.events.aggregation import aggregate
    from repro_torch.events.simulator import (
        SceneConfig,
        make_scene,
        make_trajectory,
        simulate_events,
    )
    from repro_torch.kernels.backproject_vote.ops import canonical_inputs

    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=128, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True,
                       keyframe_dist_frac=0.05)
    scene = make_scene(SceneConfig(name="simulation_3planes"))
    traj = make_trajectory("simulation_3planes", 96)
    frames = aggregate(cam, simulate_events(cam, scene, traj), traj, events_per_frame=1024)
    by_cap: dict[int, list] = {}
    for seg in plan_segments(frames, dsi_cfg, opts):
        by_cap.setdefault(bucket_capacity(seg[1] - seg[0]), []).append(seg)
    cap = max(by_cap, key=lambda c: len(by_cap[c]))
    batch = pad_segments(frames, by_cap[cap], cap)
    planes = dsi_cfg.planes(device=frames.xy.device)
    geoms = precompute_batch_geometry(
        cam, batch.poses_R, batch.poses_t,
        SE3(batch.ref_R[:, None], batch.ref_t[:, None]), planes,
        planes[dsi_cfg.num_planes // 2])
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], -1)
    # bool masks; the validity reaches the kernel as this tree's
    # `canonical_inputs` hands it on
    xy0, valid, phi = canonical_inputs(batch.xy, batch.valid.bool(), geoms.H, phi,
                                       quantized=True, frame_valid=batch.frame_valid.bool())
    return xy0, valid, phi, cam, dsi_cfg.num_planes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_sweep: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import card_line, cuda_ms, graph_ms
    from repro_torch.core.dsi import to_storage
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda

    card = card_line()
    xy0, valid, phi, cam, nz = main_bucket()
    w, h = cam.width, cam.height
    for rows in (slice(None), slice(0, 1)):
        x0, y0 = xy0[rows, ..., 0].contiguous(), xy0[rows, ..., 1].contiguous()
        v, p = valid[rows].contiguous(), phi[rows].contiguous()

        def b1(x0=x0, y0=y0, v=v, p=p):
            return backproject_vote_cuda(x0, y0, v, p, cx=cam.cx, cy=cam.cy, w=w, h=h,
                                         quantized=True)

        stored = b1()
        want = to_storage(backproject_vote_ref(xy0[rows], valid[rows], phi[rows], cx=cam.cx,
                                               cy=cam.cy, w=w, h=h, quantize_plane_coords=True))
        assert torch.equal(stored, want), "B1 differs from its plain version"
        s, c, e = v.shape
        print(json.dumps({
            "root": ROOT, "S": s, "C": c, "E": e, "Nz": nz, "w": w, "h": h,
            "b1_device_ms": graph_ms(b1), "b1_eager_ms": cuda_ms(b1, reps=7, inner=5),
            "b2_device_ms": graph_ms(lambda: depth_argmax_cuda(stored)),
            "b2_eager_ms": cuda_ms(lambda: depth_argmax_cuda(stored), reps=7, inner=5)}),
              flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
