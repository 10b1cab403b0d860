#!/usr/bin/env python3
"""Device time of the sweep kernel (B1), the depth max/argmax (B2) and the
detection tail at the EMVS main path's shapes, for the checkout this file
sits in.

    python3 bench_sweep.py

Builds the inputs `run_emvs` gives B1 on the main path (the
simulation_3planes scene over a 96-step arc, 1024-event frames, the
DAVIS240 camera, 128 planes, Table-1 quantized; the capacity bucket with
most segments: S=2 segments of C=40 frames) and its first segment alone
(S=1). At each, B1 is first held bitwise against its plain version, then
B1 and B2 are timed as device time (`chip_smoke.graph_ms`: a CUDA graph of
20 calls replayed between CUDA events) beside the host-inclusive eager
time (`chip_smoke.cuda_ms`). The detection tail (threshold, depth, 3x3
median) is timed on B2's output and, for DAVIS346, on seeded vote counts,
as the eager PyTorch code of `core/detection.py` run on the card and, where
the checkout has it, as the `detect_filter` kernel (held bitwise to the
CPU path first). Uses only the package's public functions and
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
    """`(xy0, valid, phi, cam, nz, planes)`: B1's inputs for the main path's
    bucket with most segments, as `run_emvs` builds them, and the planes."""
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
    return xy0, valid, phi, cam, dsi_cfg.num_planes, planes


def eager_tail(conf, zf, planes):
    """`core/detection.py`'s CPU code for the tail, run on the card's tensors
    as eager PyTorch launches."""
    import torch

    from repro_torch.core.detection import gaussian_blur, median_filter3

    mask = (conf > gaussian_blur(conf, 2.5, 5) + 6.0) & (conf >= 3.0)
    nz = planes.shape[0]
    z_lo = torch.clamp(torch.floor(zf).to(torch.int64), 0, nz - 1)
    z_hi = torch.clamp(z_lo + 1, 0, nz - 1)
    frac = zf - z_lo.to(torch.float32)
    depth = torch.addcmul(planes[z_lo] * (1.0 - frac), planes[z_hi], frac)
    return median_filter3(depth, mask), mask


def time_tail(conf, zf, planes) -> dict:
    """Eager and (where the checkout has it) kernel times of the tail."""
    import torch

    from chip_smoke import cuda_ms, graph_ms
    from repro_torch.core import detection

    out = {"tail_eager_device_ms": graph_ms(lambda: eager_tail(conf, zf, planes)),
           "tail_eager_ms": cuda_ms(lambda: eager_tail(conf, zf, planes), reps=7, inner=5)}
    try:
        from repro_torch.kernels.detect_filter.ops import detect_filter
    except ImportError:
        return out

    taps = getattr(detection, "_gaussian_taps", None)  # older trees' wrapper takes the taps

    def kernel():
        if taps is not None:
            return detect_filter(conf, zf, planes, taps(2.5, 5), threshold_c=6.0,
                                 min_votes=3.0, median_filter=True)
        return detect_filter(conf, zf, planes, threshold_c=6.0, min_votes=3.0,
                             median_filter=True)[:2]

    depth, mask = kernel()
    want = detection.detect_and_filter_from(conf.cpu(), zf.cpu(), planes.cpu())
    assert torch.equal(depth.cpu(), want.depth) and torch.equal(mask.cpu(), want.mask), \
        "the detection tail differs from the CPU path"
    out.update(tail_device_ms=graph_ms(kernel), tail_ms=cuda_ms(kernel, reps=7, inner=5))
    return out


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
    xy0, valid, phi, cam, nz, planes = main_bucket()
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
        conf, zf = depth_argmax_cuda(stored)
        print(json.dumps({
            "root": ROOT, "S": s, "C": c, "E": e, "Nz": nz, "w": w, "h": h,
            "b1_device_ms": graph_ms(b1), "b1_eager_ms": cuda_ms(b1, reps=7, inner=5),
            "b2_device_ms": graph_ms(lambda: depth_argmax_cuda(stored)),
            "b2_eager_ms": cuda_ms(lambda: depth_argmax_cuda(stored), reps=7, inner=5),
            **time_tail(conf, zf, planes)}), flush=True)
    gen = torch.Generator().manual_seed(346)
    for s in (2, 1):  # DAVIS346: vote counts with tall peaks, refined indices
        conf = (torch.poisson(torch.full((s, 260, 346), 2.0), generator=gen)
                + 40.0 * (torch.rand((s, 260, 346), generator=gen) < 0.05)).cuda()
        zf = (torch.rand((s, 260, 346), generator=gen) * nz - 0.5).cuda()
        print(json.dumps({"root": ROOT, "S": s, "Nz": nz, "w": 346, "h": 260,
                          **time_tail(conf, zf, planes)}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
