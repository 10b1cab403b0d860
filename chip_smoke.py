#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each asserting, none caught:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. builds every CUDA kernel from `src/repro_torch/csrc` (one nvcc per
     source, all started together);
  3. holds each kernel against its plain PyTorch version on the card:
     random nearest/bilinear, float/quantized cases and the boundary grid
     (events on w-1/h-1, half-integer coords, fully padded frames,
     non-finite coords). Nearest is bitwise on dsi, conf and zf; bilinear
     dsi within BILINEAR_ATOL/RTOL (f32 atomics reorder the sum of
     fractional weights); the depth max/argmax kernel is bitwise on any DSI;
  4. drives the main path at the paper's width: the simulator's
     simulation_3planes scene (SceneConfig defaults), 96 trajectory steps,
     `aggregate` at 1024 events per frame, `run_emvs` on the 240x180
     DAVIS240 camera with 128 planes and the fused-kernel formulation
     (nearest, Table-1 quantized). Launch counts are zeroed just before
     and read just after; both kernels must have launched. The same run
     with the plain scatter formulation must agree bitwise on dsi, depth
     and mask, and AbsRel against the ground truth must stay below 0.25;
  5. times each kernel and its plain version at the main path's shapes
     (CUDA events, warm, median) and the run_emvs wall time, and profiles
     one warm run_emvs (device-kernel time, busy share, top device ops).

The line before the last is one JSON object per the kernels; the last line
is `{"ok": true, "device": {...}}`. Exits non-zero, printing neither, when
there is no CUDA device or the repository's `src/` is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BILINEAR_ATOL, BILINEAR_RTOL = 1e-4, 1e-5
# float32 operations per (valid event, plane) in the sweep kernel: per
# coordinate a subtract, an FMA (2) and an add, then the vote's add
B1_OPS_PER_PROJECTION = 9
# per (pixel, plane) in the depth max/argmax: a compare and a select
B2_OPS_PER_VOXEL = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median over `reps` of the mean ms of `inner` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / inner)
    return statistics.median(times)


def device_breakdown(fn, top: int = 8) -> tuple[float, float, list[tuple[str, float, int]]]:
    """Profile one call of `fn`: (wall ms, summed device-kernel ms, the
    `top` device kernels by time as (name, ms, calls)). Only the kernel
    events count: the CPU-side operator rows carry their kernels' time
    again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return 1e3 * wall, sum(r[1] for r in rows), rows[:top]


def assert_equal(a, b, what: str) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    bad = int((a != b).sum())
    assert bad == 0, f"{what}: {bad} of {a.numel()} elements differ"


def compare_b1_b2(xy0, valid, phi, *, cam, mode: str, quantized: bool, what: str):
    """Hold both kernels against their plain versions on one input.

    Returns (B1 max abs error, B2 max abs error)."""
    import torch

    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_detect_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
    from repro_torch.kernels.local_max.ref import depth_argmax_ref

    dsi = backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi, cx=cam.cx,
                                cy=cam.cy, w=cam.width, h=cam.height, mode=mode,
                                quantized=quantized)
    conf, zf = depth_argmax_cuda(dsi)
    torch.cuda.synchronize()
    dsi_r, conf_r, zf_r = backproject_vote_detect_ref(
        xy0, valid, phi, cx=cam.cx, cy=cam.cy, w=cam.width, h=cam.height,
        mode=mode, quantized=quantized)
    err1 = float((dsi.float() - dsi_r.float()).abs().max())
    if mode == "nearest":
        assert_equal(dsi, dsi_r, f"{what}: dsi")
        assert_equal(conf, conf_r, f"{what}: conf")
        assert_equal(zf, zf_r, f"{what}: zf")
    else:
        assert dsi.dtype == dsi_r.dtype
        ok = torch.allclose(dsi.float(), dsi_r.float(), atol=BILINEAR_ATOL,
                            rtol=BILINEAR_RTOL)
        assert ok, f"{what}: bilinear dsi max abs err {err1}"
    # the reduction on the kernel's own stored DSI: bitwise for any input
    conf_p, zf_p = depth_argmax_ref(dsi)
    assert_equal(conf, conf_p, f"{what}: depth_argmax conf")
    assert_equal(zf, zf_p, f"{what}: depth_argmax zf")
    err2 = max(float((conf - conf_p).abs().max()), float((zf - zf_p).abs().max()))
    return err1, err2


def kernel_cases(cam, dev) -> None:
    """Phase 3: random cases and the boundary grid, kernel vs plain."""
    import numpy as np
    import torch

    w, h = cam.width, cam.height
    rng = np.random.default_rng(0)
    s, f, e, nz = 2, 4, 1024, 128
    xy0 = rng.uniform((-8, -8), (w + 8, h + 8), (s, f, e, 2)).astype(np.float32)
    valid = (rng.random((s, f, e)) > 0.2).astype(np.float32)
    valid[1, 2] = 0.0  # one fully padded frame
    phi = np.concatenate([rng.uniform(0.7, 1.3, (s, f, nz, 1)),
                          rng.uniform(-6, 6, (s, f, nz, 2))], -1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (xy0, valid, phi)]
    for mode in ("nearest", "bilinear"):
        for quantized in (False, True):
            what = f"random {mode} quantized={quantized}"
            err1, err2 = compare_b1_b2(*args, cam=cam, mode=mode,
                                       quantized=quantized, what=what)
            log(f"  {what}: ok (sweep max abs err {err1:.3g}, argmax {err2:.3g})")

    # boundary grid: alpha = 1, beta = 0, so plane coords = canonical coords
    specials = np.array([
        [w - 1.0, h - 1.0], [w - 1.0, 0.0], [0.0, h - 1.0],
        [w - 0.5, h - 0.5], [w - 1.5, h - 1.5], [0.5, 0.5], [-0.5, -0.5],
        [-0.51, 7.0], [0.49, 0.51], [w + 100.0, 3.0], [3.0, h + 100.0],
        [7.25, 7.75], [w - 1.25, h - 1.75], [13.5, 2.5], [2.5, 13.5],
        [0.0, 0.0], [np.nan, 5.0], [5.0, np.inf], [-np.inf, 5.0],
        [255.5, 3.0], [3.0, 255.5], [-1e30, 1e30],
    ], dtype=np.float32)
    f, nz = 4, 8
    xy0 = np.tile(specials[None, None], (1, f, 1, 1))
    valid = np.ones(xy0.shape[:-1], np.float32)
    valid[0, 3] = 0.0  # fully padded frame
    phi = np.concatenate([np.ones((1, f, nz, 1)), np.zeros((1, f, nz, 2))],
                         -1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (xy0, valid, phi)]
    for mode in ("nearest", "bilinear"):
        for quantized in (False, True):
            what = f"boundary {mode} quantized={quantized}"
            compare_b1_b2(*args, cam=cam, mode=mode, quantized=quantized, what=what)
            log(f"  {what}: ok")
    # non-finite coefficients as well as coordinates
    phi_bad = phi.copy()
    phi_bad[0, 1, 2, 0] = np.nan
    phi_bad[0, 2, 5, 1] = np.inf
    args[2] = torch.from_numpy(phi_bad).to(dev)
    for quantized in (False, True):
        what = f"non-finite phi nearest quantized={quantized}"
        compare_b1_b2(*args, cam=cam, mode="nearest", quantized=quantized, what=what)
        log(f"  {what}: ok")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found: run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()

    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig, to_storage
    from repro_torch.core.geometry import SE3
    from repro_torch.core.pipeline import (
        EMVSOptions,
        bucket_capacity,
        pad_segments,
        plan_segments,
        precompute_batch_geometry,
        run_emvs,
    )
    from repro_torch.events.aggregation import aggregate
    from repro_torch.events.simulator import (
        SceneConfig,
        absrel,
        ground_truth_depth,
        make_scene,
        make_trajectory,
        simulate_events,
    )
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
    from repro_torch.kernels.backproject_vote.ops import canonical_inputs
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
    from repro_torch.kernels.local_max.ref import depth_argmax_ref

    # 1. the card
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build every kernel from source, in parallel
    t0 = time.perf_counter()
    builds = cuda.build_all(force=True)
    log(f"build: {time.perf_counter() - t0:.2f} s for {len(builds)} sources "
        + ", ".join(f"{k} {v[0]:.2f} s" for k, v in builds.items()))
    for name, (_, text) in builds.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels vs plain versions on the card
    cam = CameraModel()
    log("kernel vs plain:")
    kernel_cases(cam, dev)

    # 4. the main path at the paper's width
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=128, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True,
                       keyframe_dist_frac=0.05)
    scene = make_scene(SceneConfig(name="simulation_3planes"))
    torch.cuda.synchronize()
    cuda.launch_counts.clear()
    t0 = time.perf_counter()
    traj = make_trajectory("simulation_3planes", 96)
    events = simulate_events(cam, scene, traj)
    frames = aggregate(cam, events, traj, events_per_frame=1024)
    result = run_emvs(cam, dsi_cfg, frames, opts)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = dict(cuda.launch_counts)
    log(f"main path: {int(events.valid.sum())} valid events -> "
        f"{frames.xy.shape[0]} frames -> {len(result.segments)} segments in "
        f"{t_main:.3f} s (cold), launches {launches}")
    assert len(result.segments) >= 2, f"expected >= 2 segments, got {len(result.segments)}"
    for name in ("backproject_vote", "depth_argmax"):
        assert launches.get(name, 0) > 0, f"the main path never launched {name}"

    plain = run_emvs(cam, dsi_cfg, frames, dataclasses.replace(opts, formulation="scatter"))
    assert len(plain.segments) == len(result.segments)
    errs = []
    for k, (seg, ref) in enumerate(zip(result.segments, plain.segments)):
        assert seg.frame_range == ref.frame_range
        assert seg.dsi.shape == dsi_cfg.shape and seg.dsi.dtype == torch.int32
        assert seg.depth_map.depth.shape == (cam.height, cam.width)
        assert bool(torch.isfinite(seg.depth_map.depth).all())
        assert_equal(seg.dsi, ref.dsi, f"segment {k}: kernel vs scatter dsi")
        assert_equal(seg.depth_map.depth, ref.depth_map.depth, f"segment {k}: depth")
        assert_equal(seg.depth_map.mask, ref.depth_map.mask, f"segment {k}: mask")
        cloud = result.clouds[k]
        assert int(cloud.valid.sum()) == int(seg.depth_map.mask.sum())
        assert bool(torch.isfinite(cloud.points[cloud.valid]).all())
        gt, gtm = ground_truth_depth(cam, scene, seg.T_w_ref)
        err = float(absrel(seg.depth_map.depth, seg.depth_map.mask, gt, gtm))
        errs.append(err)
        log(f"  segment {seg.frame_range}: {int(seg.depth_map.mask.sum())} "
            f"semi-dense px, AbsRel {err:.4f}")
    mean_err = sum(errs) / len(errs)
    log(f"kernel == scatter bitwise on dsi, depth, mask; mean AbsRel {mean_err:.4f}")
    assert mean_err < 0.25, f"mean AbsRel {mean_err} too high"

    # 5. timings at the main path's shapes: the bucket with most segments
    segs = plan_segments(frames, dsi_cfg, opts)
    by_cap: dict[int, list] = {}
    for seg in segs:
        by_cap.setdefault(bucket_capacity(seg[1] - seg[0]), []).append(seg)
    cap = max(by_cap, key=lambda c: len(by_cap[c]))
    batch = pad_segments(frames, by_cap[cap], cap)
    planes = dsi_cfg.planes(device=dev)
    geoms = precompute_batch_geometry(
        cam, batch.poses_R, batch.poses_t,
        SE3(batch.ref_R[:, None], batch.ref_t[:, None]), planes,
        planes[dsi_cfg.num_planes // 2])
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], -1)
    xy0, valid, phi = canonical_inputs(batch.xy, batch.valid, geoms.H, phi,
                                       quantized=True, frame_valid=batch.frame_valid)
    s, c, e = valid.shape
    nz, h, w = dsi_cfg.shape
    shape_note = f"S={s} C={c} E={e} Nz={nz} {w}x{h}"
    err1, err2 = compare_b1_b2(xy0, valid, phi, cam=cam, mode="nearest",
                               quantized=True, what=f"main-path bucket {shape_note}")
    log(f"main-path bucket {shape_note}: kernels bitwise with plain versions")

    x0, y0 = xy0[..., 0].contiguous(), xy0[..., 1].contiguous()

    def b1():
        return backproject_vote_cuda(x0, y0, valid, phi, cx=cam.cx, cy=cam.cy,
                                     w=w, h=h, quantized=True)

    def b1_plain():
        return to_storage(backproject_vote_ref(xy0, valid, phi, cx=cam.cx, cy=cam.cy,
                                               w=w, h=h, quantize_plane_coords=True))

    stored = b1()
    b1_ms = cuda_ms(b1, reps=7, inner=5)
    b1_plain_ms = cuda_ms(b1_plain, reps=3, inner=1)
    b2_ms = cuda_ms(lambda: depth_argmax_cuda(stored), reps=7, inner=5)
    b2_plain_ms = cuda_ms(lambda: depth_argmax_ref(stored), reps=7, inner=5)

    n_valid = int((valid != 0).sum())
    b1_bytes = 4 * (3 * s * c * e + s * c * nz * 3) + 2 * s * nz * h * w
    b1_ops = B1_OPS_PER_PROJECTION * n_valid * nz
    b2_bytes = 2 * s * nz * h * w + 8 * s * h * w
    b2_ops = B2_OPS_PER_VOXEL * s * nz * h * w

    def bound(nbytes: int, nops: int) -> tuple[float, str]:
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")

    b1_bound, b1_by = bound(b1_bytes, b1_ops)
    b2_bound, b2_by = bound(b2_bytes, b2_ops)

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_emvs(cam, dsi_cfg, frames, opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    prof_wall, busy, top_ops = device_breakdown(lambda: run_emvs(cam, dsi_cfg, frames, opts))

    log(f"[{card}] backproject_vote at {shape_note}: kernel {b1_ms:.4f} ms, "
        f"plain {b1_plain_ms:.2f} ms, bound {b1_bound:.4f} ms ({b1_by})")
    log(f"[{card}] depth_argmax at S={s} Nz={nz} {w}x{h} int16: kernel "
        f"{b2_ms:.4f} ms, plain {b2_plain_ms:.4f} ms, bound {b2_bound:.4f} ms ({b2_by})")
    log(f"[{card}] run_emvs (kernel, nearest, quantized) warm wall "
        f"{1e3 * wall:.1f} ms median of {len(walls)} ({len(result.segments)} "
        f"segments, {frames.xy.shape[0]} frames); whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    log(f"[{card}] run_emvs under torch.profiler: wall {prof_wall:.1f} ms, device "
        f"kernels {busy:.2f} ms (busy share {busy / prof_wall:.3f}); top device ops:")
    for name, ms, calls in top_ops:
        log(f"  {ms:9.3f} ms  {calls:5d} calls  {name[:90]}")

    kernels = [
        {"name": "backproject_vote", "route": "cuda",
         "source": "src/repro_torch/csrc/backproject_vote.cu",
         "replaces": "src/repro/kernels/backproject_vote/kernel.py:241",
         "launches": launches["backproject_vote"], "max_abs_err": err1,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None},
        {"name": "depth_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/local_max.cu",
         "replaces": "src/repro/kernels/local_max/kernel.py:74",
         "launches": launches["depth_argmax"], "max_abs_err": err2,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
