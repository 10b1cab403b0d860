"""Shared scaffolding of the port's paper benchmarks: the four evaluation
sequences of the paper (simulation_3planes, simulation_3walls,
slider_close, slider_far) at the reference's sizes, the AbsRel of one
key-frame segment, a stage timer, and the `BENCH_emvs_torch.json` writer.

Sizes follow the reference's `benchmarks/_emvs_common.py`: DAVIS240, 400
scene points per plane, 48 trajectory steps, 2% noise events, 1024-event
frames, 64 inverse-depth planes, and the first 24 frames as one segment.
Everything runs on the CUDA card unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import statistics
import subprocess
import tempfile
import time

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import EMVSOptions, process_segment
from repro_torch.device import resolve_device
from repro_torch.events.aggregation import EventFrames, aggregate
from repro_torch.events.simulator import (
    SceneConfig,
    absrel,
    ground_truth_depth,
    make_scene,
    make_trajectory,
    simulate_events,
)

SEQUENCES = ("simulation_3planes", "simulation_3walls", "slider_close", "slider_far")
MAX_FRAMES = 24  # frames of the one key-frame segment each AbsRel is taken on
BENCH_JSON = "BENCH_emvs_torch.json"


@functools.cache
def sequence(name: str, device: str = "cuda", points_per_plane: int = 400,
             steps: int = 48):
    """`(cam, scene, frames, dsi_cfg)` for one evaluation sequence."""
    dev = resolve_device(device)
    cam = CameraModel()
    scene = make_scene(SceneConfig(name=name, points_per_plane=points_per_plane))
    traj = make_trajectory(name, steps, device=dev)
    ev = simulate_events(cam, scene, traj, noise_fraction=0.02, seed=0, device=dev)
    frames = aggregate(cam, ev, traj, events_per_frame=1024, device=dev)
    z_rng = (0.5, 1.8) if name == "slider_close" else (0.6, 4.5)
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=64, z_min=z_rng[0], z_max=z_rng[1])
    return cam, scene, frames, dsi_cfg


def segment_absrel(cam: CameraModel, scene, frames: EventFrames, dsi_cfg: DSIConfig,
                   opts: EMVSOptions, max_frames: int = MAX_FRAMES) -> float:
    """AbsRel of the depth map of one segment: the first `max_frames`
    frames, referenced to the first frame's pose."""
    frames = EventFrames(*(t[:max_frames] for t in frames[:3]),
                         SE3(frames.poses.R[:max_frames], frames.poses.t[:max_frames]))
    T_w_ref = SE3(frames.poses.R[0], frames.poses.t[0])
    _, dm = process_segment(cam, dsi_cfg, frames, T_w_ref, opts)
    gt, gtm = ground_truth_depth(cam, scene, T_w_ref)
    return float(absrel(dm.depth, dm.mask, gt, gtm))


def absrel_for(name: str, opts: EMVSOptions, device: str = "cuda",
               max_frames: int = MAX_FRAMES) -> float:
    cam, scene, frames, dsi_cfg = sequence(name, device)
    return segment_absrel(cam, scene, frames, dsi_cfg, opts, max_frames)


def table_rows(rows: dict[str, EMVSOptions], device: str = "cuda",
               max_frames: int = MAX_FRAMES) -> dict[str, dict[str, float]]:
    """AbsRel of every named option set on every sequence, plus a
    `<name>_kernel` row in the kernel formulation beside each nearest row.

    A kernel row counts every vote exactly as the matmul formulation does,
    so it must give the same AbsRel; RuntimeError if it does not."""
    out = {}
    for seq in SEQUENCES:
        r = {}
        for name, opts in rows.items():
            r[name] = absrel_for(seq, opts, device, max_frames)
            if opts.voting == "nearest":
                r[f"{name}_kernel"] = absrel_for(
                    seq, dataclasses.replace(opts, formulation="kernel"), device, max_frames)
                if opts.formulation == "matmul" and r[f"{name}_kernel"] != r[name]:
                    raise RuntimeError(f"{seq} {name}: kernel AbsRel {r[f'{name}_kernel']} "
                                       f"!= matmul AbsRel {r[name]}")
        out[seq] = r
    return out


def device_label(device: str = "cuda") -> dict[str, str | None]:
    """Where a record was measured: torch's device name and, on the card,
    its name and power limit as nvidia-smi prints them."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return {"device": torch.cuda.get_device_name(dev),
            "card": out.stdout.strip().splitlines()[0]}


def stage_ms(fn, device: str = "cuda", calls: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of `fn`. On the card: device time, `calls`
    calls captured in one CUDA graph and replayed between two
    `torch.cuda.Event`s, the median of `reps` replays. On the CPU: the host
    clock over `calls` calls, the median of `reps`."""
    dev = resolve_device(device)
    fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / calls)
        return statistics.median(times)
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def update_bench_json(section: str, record: dict, path: str | None = None) -> str:
    """Merge one benchmark's record into `BENCH_emvs_torch.json` (written
    whole to a temporary file, then moved over the old one)."""
    path = path or BENCH_JSON
    data: dict = {}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    data[section] = record
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               prefix=".bench_emvs_torch_", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path
