#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases, each asserting, none caught:
  1. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
  2. builds every CUDA kernel from `src/repro_torch/csrc` (one nvcc per
     source, all started together), counts the HGMMA (wgmma) instructions
     in the flash-attention library's SASS and the bulk copies
     (B1_BULK_COPY_SASS) in the sweep kernel's: none fails;
  3. holds the EMVS kernels against their plain PyTorch versions on the
     card: random nearest/bilinear, float/quantized cases, the boundary
     grid (events on w-1/h-1, half-integer coords, fully padded frames,
     non-finite coords) and the sweep kernel's edges (B1_EDGE_CASES: event
     counts off the ring stage, E off the 16-event granule, one event, C=1,
     odd Nz, Nz=2, S=3, frames past the phi window, a 37x23 plane); then
     (3b) B1's row bands (B1_BAND_CASES: 346x260 and 400x300 on their
     band plans, 240x180 with forced bands of 7 and 45 rows) and the
     boundary grid at 346x260 with rows either side of its band edge,
     each case one launch of each kernel, with its band plan logged.
     Nearest is bitwise on dsi, conf and zf; bilinear dsi within
     BILINEAR_ATOL/RTOL (f32 atomics reorder the sum of fractional
     weights); the depth max/argmax kernel is bitwise on any DSI;
  4. drives the EMVS main path at the paper's width: the simulator's
     simulation_3planes scene (SceneConfig defaults), 96 trajectory steps,
     `aggregate` at 1024 events per frame, `run_emvs` on the 240x180
     DAVIS240 camera with 128 planes and the fused-kernel formulation
     (nearest, Table-1 quantized). Launch counts are zeroed just before
     and read just after; both kernels must have launched. The same run
     with the plain scatter formulation must agree bitwise on dsi, depth
     and mask, and AbsRel against the ground truth must stay below 0.25;
  5. times each EMVS kernel at the main path's largest bucket and at its
     first segment alone (S=1) as device time (a CUDA graph of GRAPH_CALLS
     calls) beside host-inclusive eager times, with the bound and the bound
     share, cross-checks B1's device time against the profiler's, times
     the plain versions, prints B1's band plan and shared memory per CTA,
     the run_emvs wall time, and profiles one warm run_emvs (device-kernel
     time, busy share, top ops);
  4b. drives the same scene, trajectory and options through a DAVIS346
     (346x260, MVSEC intrinsics; B1 in two row bands): launch counts
     zeroed before and read after each run, kernel == scatter bitwise on
     dsi, depth and mask, float and quantized, mean AbsRel on the float
     datapath below 0.25, the warm wall and a profile of one warm run,
     and B1's device time at the bucket with most segments beside its
     bound;
  4c. runs the paper's Fig 4a, 4b and 7a (`repro_torch.benchmarks`, the
     reference's sequences and sizes) and Table 3 on the card: every
     kernel row equals its matmul row and every claim holds;
  4d. runs both examples (`repro_torch.examples`) at 24 trajectory steps,
     `emvs_reconstruction` on DAVIS240 and DAVIS346: the merged map's
     outlier filter on the card keeps the points the CPU's filter keeps;
  4e. drives the streaming engine (`repro_torch.serving.emvs_stream`) on
     phase 4's events and trajectory, handed to it on the host: pose-gated
     streams in event chunks of 4096 and 997 with the tracker's poses in
     chunks of 8 samples, under the latency, throughput and adaptive
     policies (max_inflight 2), and two sessions (the whole stream and its
     first 110 frames) on one MultiStreamEngine, round_robin and
     throughput, under the balanced and starved schedules. Every result equals `run_emvs` on the
     card over host-aggregated frames bitwise (dsi, depth, mask), each
     session its dedicated engine; B1 and B2 launch once per dispatch
     (counts zeroed before and read after each run); `_dispatch` runs under
     torch.cuda.set_sync_debug_mode("error"); B1 and B2 are held against
     their plain versions on one streamed dispatch's batch. Prints the
     first-depth-map latency, the warm stream wall against the offline
     one, dispatch counts, device ms per sweep (CUDA events), the
     sweep-time histogram, a profile of one warm stream, the frame store's
     peak bytes and the H100 cost table a SweepProfiler recorded (written
     to results/cost_table_h100.json);
  6. holds the flash-attention kernels against their plain version on the
     card, within the reference's tolerances (FLASH_TOL): the serving
     shapes (1, 32, S, 128) over (1, 8, S, 128) for S in 32, 128, 512,
     2048 as the model passes them ((B, S, H, D) views), head dims 16-256,
     ragged S (100, 2047), Sq < Skv, GQA 1, 4 and 8, causal and not, bf16
     and float32. Each case must take the route `kernel.route` names and
     count one launch on it, and the output keeps q's layout;
  7. drives the LM serving path at full width: qwen3-8b (36 layers, d 4096,
     32/8 heads, vocab 151,936) with random bf16 weights from
     torch.Generator seed 0, an Engine of 4 slots, max_len 1024 and
     prefill buckets 32/128/512, serving 8 requests of 5-500 prompt tokens
     (numpy seed 0, every bucket used) for 16 new tokens each. Launch
     counts are zeroed just before and read just after: flash_attention
     must launch 36 times per request, all on the tensor-core route. Every
     request must finish with 16 tokens and every sampled logit row must
     be finite. One request's prefill logits with the kernel are held
     against prefill with the plain attention, at relative L2 <=
     PREFILL_REL_L2 with the bf16 weights and with a float32 copy of
     them; in bf16 both are also set beside prefill with float64
     attention (the rounding floor), and the kernel's distance from it
     may be at most PREFILL_FLOOR_RATIO times the plain version's;
  8. times each flash-attention route (bf16: tensor cores; float32: CUDA
     cores), its plain version and PyTorch's scaled_dot_product_attention
     (the yardstick, never called by the port) at S = 32, 128, 512, 2048
     as device time (a CUDA graph of GRAPH_CALLS calls replayed between
     CUDA events), beside host-inclusive eager times, with the bound and
     the bound share; cross-checks one device time against the
     profiler's kernel time; prefill per bucket; a warm decode step of
     the 4 slots against the weight-streaming bound; tokens/s of the
     serving run; and profiles one prefill of the largest bucket (at most
     PREFILL_MAX_LAUNCHES launches) and one decode step.

At the end it prints, each on a line of its own: one JSON object for the
kernels (all three), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing none of these,
when there is no CUDA device or the repository's `src/` is not beside it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import types

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
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor cores
# the reference's flash-attention tolerances (tests/test_kernels.py)
FLASH_TOL = {"torch.bfloat16": 2e-2, "torch.float32": 2e-5}
# prefill logits, kernel vs plain attention, relative L2. In float32 the
# two differ by summation order only (about 1e-5 at qwen3-8b). In bf16
# each layer's attention output can round the other way in its last bit
# and 36 layers of random weights amplify that to about 0.04; the script
# prints how far the plain version itself lands from float64 attention.
PREFILL_REL_L2 = {"torch.float32": 1e-3, "torch.bfloat16": 0.1}
# the bf16 kernel's prefill logits against float64 attention, at most this
# multiple of the plain version's distance (the tensor-core route rounds
# the probabilities to bf16 before their product with V)
PREFILL_FLOOR_RATIO = 2.0
LM_ARCH = "qwen3-8b"
LM_SLOTS, LM_MAX_LEN, LM_BUCKETS = 4, 1024, (32, 128, 512)
LM_REQUESTS, LM_NEW_TOKENS = 8, 16
FLASH_TIMED_S = (32, 128, 512, 2048)
GRAPH_CALLS = 20  # calls captured in one CUDA graph for a device time
PROFILER_TRACES = 3  # traces of a profiler cross-check that may return no records
# launches in one profiled prefill of bucket 512: 3,001 with the q/k/v and
# output copies around the attention kernel, 144 fewer without them
PREFILL_MAX_LAUNCHES = 2857
CUOBJDUMP_DEFAULT = "/usr/local/cuda/bin/cuobjdump"
# the SASS of the 1-D bulk copy (cp.async.bulk) that feeds the sweep kernel's ring
B1_BULK_COPY_SASS = "UBLKCP"
# (S, F, E, Nz, w, h, what) inputs that reach the sweep kernel's edges; the
# ring stage is 1,984 events, the phi window 512 frames
B1_EDGE_CASES = (
    (1, 3, 1000, 8, 240, 180, "events not a multiple of the stage"),
    (2, 3, 1023, 8, 240, 180, "E not a multiple of 16"),
    (1, 1, 1, 4, 240, 180, "a single event"),
    (2, 1, 1024, 8, 240, 180, "C=1"),
    (1, 4, 512, 7, 240, 180, "odd Nz"),
    (1, 4, 256, 2, 240, 180, "Nz=2"),
    (3, 4, 700, 12, 240, 180, "S=3"),
    (1, 600, 4, 4, 240, 180, "frames past the phi window"),
    (2, 4, 64, 6, 37, 23, "a 37 x 23 plane, no multiple of 16 bytes"),
)
# (w, h, forced band rows or None for the band plan): planes past one CTA's
# shared memory (DAVIS346: 2 bands, 400x300: 3) and forced band edges at
# 240x180, where bilinear votes straddle two bands
B1_BAND_CASES = ((346, 260, None), (400, 300, None), (240, 180, 7), (240, 180, 45))
B1_BAND_PLANES = 32
# phase 4e: event chunkings of the streamed runs, pose samples per tracker
# chunk, the second session's cut (frames) and where the cost table goes
STREAM_CHUNKS = (4096, 997)
STREAM_POSE_CHUNK = 8
STREAM_CUT_FRAMES = 110
STREAM_COST_TABLE = os.path.join(ROOT, "results", "cost_table_h100.json")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5, inner: int = 3) -> float:
    """Median over `reps` of the mean ms of `inner` back-to-back eager calls
    between CUDA events: host-inclusive, since a call that is faster on the
    card than the host can enqueue it is timed at the host's pace."""
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


def graph_ms(fn, calls: int = GRAPH_CALLS, reps: int = 5) -> float:
    """Device ms per call of `fn`: `calls` calls captured in one CUDA graph,
    replayed between two CUDA events; median of `reps` replays. The host
    enqueues one graph, so its speed drops out."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    del graph
    return statistics.median(times)


def profiled_kernel_ms(fn, name_part: str, counter: str,
                       calls: int = GRAPH_CALLS) -> tuple[float, int]:
    """Mean device ms of the kernels whose name holds `name_part`, from
    torch.profiler over `calls` eager calls of `fn`, and the number of
    kernel records the profiler returned.

    That `fn` launched its kernel `calls` times is checked on the launch
    counter `counter`. The profiler's tracing may drop kernel records now
    and then (19 of 20 returned in one H100 run, none in another, where an
    earlier trace in the same process had returned 20 of 20), so the mean
    is taken over the records it returned, which must be at least one and
    at most `calls`; a trace that returned none is taken again, up to
    PROFILER_TRACES times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda

    fn()
    torch.cuda.synchronize()
    for trace in range(1, PROFILER_TRACES + 1):
        before = cuda.launch_counts[counter]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launched = cuda.launch_counts[counter] - before
        assert launched == calls, f"{calls} calls launched {launched} {counter} kernels"
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if ev.device_type == DeviceType.CUDA and name_part in ev.key:
                total += getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
                count += ev.count
        if count:
            break
        log(f"  the profiler returned no {name_part} kernel records (trace {trace})")
    assert 1 <= count <= calls, f"the profiler returned {count} {name_part} kernels of {calls}"
    return total / 1e3 / count, count


def sass_count(lib, mnemonic: str) -> int:
    """Lines of the SASS of a built library that hold `mnemonic`."""
    import shutil

    tool = shutil.which("cuobjdump") or CUOBJDUMP_DEFAULT
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return sum(mnemonic in line for line in sass.splitlines())


def log_breakdown(card: str, what: str, fn, top: int = 8) -> int:
    """Profile one call of `fn` and print its wall ms, the summed ms and
    number of its device kernels, the busy share and the `top` device
    kernels by time; returns the number of launches. Only the kernel
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
        wall = 1e3 * (time.perf_counter() - t0)
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
    busy = sum(r[1] for r in rows)
    log(f"[{card}] {what} under torch.profiler: wall {wall:.2f} ms, device kernels "
        f"{busy:.2f} ms in {sum(r[2] for r in rows)} launches (busy share "
        f"{busy / wall:.3f}); top device ops:")
    for name, ms, calls in rows[:top]:
        log(f"  {ms:9.3f} ms  {calls:5d} calls  {name[:90]}")
    return sum(r[2] for r in rows)


def assert_equal(a, b, what: str) -> None:
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.shape, b.shape, a.dtype, b.dtype)
    bad = int((a != b).sum())
    assert bad == 0, f"{what}: {bad} of {a.numel()} elements differ"


def compare_b1_b2(xy0, valid, phi, *, cam, mode: str, quantized: bool, what: str,
                  band_rows: int | None = None):
    """Hold both kernels against their plain versions on one input, B1 with
    `band_rows` rows a band (None: its band plan), each launched once.

    Returns (B1 max abs error, B2 max abs error)."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_detect_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
    from repro_torch.kernels.local_max.ref import depth_argmax_ref

    before = dict(cuda.launch_counts)
    dsi = backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi, cx=cam.cx,
                                cy=cam.cy, w=cam.width, h=cam.height, mode=mode,
                                quantized=quantized, band_rows=band_rows)
    conf, zf = depth_argmax_cuda(dsi)
    torch.cuda.synchronize()
    for name in ("backproject_vote", "depth_argmax"):
        assert cuda.launch_counts[name] == before.get(name, 0) + 1, (what, name)
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


def kernel_cases_input(rng, w: int, h: int, nz: int = 128):
    """The random case: S=2, F=4, E=1024, Nz planes, one fully padded frame."""
    import numpy as np

    s, f, e = 2, 4, 1024
    xy0 = rng.uniform((-8, -8), (w + 8, h + 8), (s, f, e, 2)).astype(np.float32)
    valid = rng.random((s, f, e)) > 0.2
    valid[1, 2] = False  # one fully padded frame
    phi = np.concatenate([rng.uniform(0.7, 1.3, (s, f, nz, 1)),
                          rng.uniform(-6, 6, (s, f, nz, 2))], -1).astype(np.float32)
    return xy0, valid, phi


def kernel_cases(cam, dev) -> None:
    """Phase 3: random cases and the boundary grid, kernel vs plain."""
    import numpy as np
    import torch

    w, h = cam.width, cam.height
    args = [torch.from_numpy(a).to(dev) for a in
            kernel_cases_input(np.random.default_rng(0), w, h)]
    for mode in ("nearest", "bilinear"):
        for quantized in (False, True):
            what = f"random {mode} quantized={quantized}"
            err1, err2 = compare_b1_b2(*args, cam=cam, mode=mode,
                                       quantized=quantized, what=what)
            log(f"  {what}: ok (sweep max abs err {err1:.3g}, argmax {err2:.3g})")

    boundary_cases(cam, dev)

    # the sweep kernel's edges: ring stages, padding, phi window
    for seed, (s, f, e, nz, pw, ph, what) in enumerate(B1_EDGE_CASES):
        plane = types.SimpleNamespace(width=pw, height=ph, cx=pw / 2 + 0.3, cy=ph / 2 - 0.2)
        rng = np.random.default_rng(100 + seed)
        xy0 = rng.uniform((-8, -8), (pw + 8, ph + 8), (s, f, e, 2)).astype(np.float32)
        valid = rng.random((s, f, e)) > 0.2
        phi = np.concatenate([rng.uniform(0.7, 1.3, (s, f, nz, 1)),
                              rng.uniform(-6, 6, (s, f, nz, 2))], -1).astype(np.float32)
        args = [torch.from_numpy(a).to(dev) for a in (xy0, valid, phi)]
        label = f"edge {what} (S={s} F={f} E={e} Nz={nz} {pw}x{ph})"
        for mode in ("nearest", "bilinear"):
            for quantized in (False, True):
                compare_b1_b2(*args, cam=plane, mode=mode, quantized=quantized,
                              what=f"{label} {mode} quantized={quantized}")
        log(f"  {label}: ok in both modes, float and quantized")


def boundary_cases(cam, dev) -> None:
    """The boundary grid on `cam`'s plane: events on w-1/h-1, half-integer
    coords, fully padded frames, non-finite coords and coefficients."""
    import numpy as np
    import torch

    w, h = cam.width, cam.height
    # boundary grid: alpha = 1, beta = 0, so plane coords = canonical coords
    specials = np.array([
        [w - 1.0, h - 1.0], [w - 1.0, 0.0], [0.0, h - 1.0],
        [w - 0.5, h - 0.5], [w - 1.5, h - 1.5], [0.5, 0.5], [-0.5, -0.5],
        [-0.51, 7.0], [0.49, 0.51], [w + 100.0, 3.0], [3.0, h + 100.0],
        [7.25, 7.75], [w - 1.25, h - 1.75], [13.5, 2.5], [2.5, 13.5],
        [0.0, 0.0], [np.nan, 5.0], [5.0, np.inf], [-np.inf, 5.0],
        [255.5, 3.0], [3.0, 255.5], [-1e30, 1e30],
    ], dtype=np.float32)
    # rows either side of every edge of the plane's row bands
    rows = band_rows_of(w, h)
    n_bands = -(-h // rows)
    edges = [b * rows + d for b in range(1, n_bands) for d in (-1.0, -0.5, 0.25)]
    specials = np.concatenate([specials, np.array([[w / 3, y] for y in edges],
                                                  np.float32).reshape(-1, 2)])
    f, nz = 4, 8
    xy0 = np.tile(specials[None, None], (1, f, 1, 1))
    valid = np.ones(xy0.shape[:-1], bool)
    valid[0, 3] = False  # fully padded frame
    phi = np.concatenate([np.ones((1, f, nz, 1)), np.zeros((1, f, nz, 2))],
                         -1).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (xy0, valid, phi)]
    plan = f"{w}x{h}, {n_bands} band(s) of {rows} rows"
    for mode in ("nearest", "bilinear"):
        for quantized in (False, True):
            what = f"boundary {mode} quantized={quantized} ({plan})"
            compare_b1_b2(*args, cam=cam, mode=mode, quantized=quantized, what=what)
            log(f"  {what}: ok")
    # non-finite coefficients as well as coordinates
    phi_bad = phi.copy()
    phi_bad[0, 1, 2, 0] = np.nan
    phi_bad[0, 2, 5, 1] = np.inf
    args[2] = torch.from_numpy(phi_bad).to(dev)
    for quantized in (False, True):
        what = f"non-finite phi nearest quantized={quantized} ({plan})"
        compare_b1_b2(*args, cam=cam, mode="nearest", quantized=quantized, what=what)
        log(f"  {what}: ok")


def band_rows_of(w: int, h: int) -> int:
    """B1's band height for a w x h plane on this card."""
    import torch

    from repro_torch.kernels.backproject_vote.kernel import band_plan

    return band_plan(w, h, torch.cuda.get_device_properties(0).shared_memory_per_block_optin)[0]


def band_cases(dev) -> None:
    """Phase 3b: B1 at sizes that need row bands, and forced bands at
    240x180, against the plain versions; the band plan at each size."""
    import numpy as np
    import torch

    from repro_torch.core.camera import CAMERAS
    from repro_torch.kernels.backproject_vote.kernel import kernel_smem_bytes, smem_bytes

    for w, h, rows in B1_BAND_CASES:
        plane = types.SimpleNamespace(width=w, height=h, cx=w / 2 + 0.3, cy=h / 2 - 0.2)
        args = [torch.from_numpy(a).to(dev) for a in
                kernel_cases_input(np.random.default_rng(w + h + (rows or 0)), w, h,
                                   B1_BAND_PLANES)]
        planned = band_rows_of(w, h)
        used = rows or planned
        assert kernel_smem_bytes(w, used) == smem_bytes(w, used), (w, used)
        plan = (f"{w}x{h}: {-(-h // used)} bands of {used} rows "
                f"({'forced' if rows else 'planned'}; the plan: {planned}), "
                f"{smem_bytes(w, used)} B of shared memory per CTA")
        for mode in ("nearest", "bilinear"):
            for quantized in (False, True):
                err1, _ = compare_b1_b2(*args, cam=plane, mode=mode, quantized=quantized,
                                        what=f"bands {plan} {mode} quantized={quantized}",
                                        band_rows=rows)
                log(f"  bands {plan} {mode} quantized={quantized}: ok "
                    f"(sweep max abs err {err1:.3g})")
    boundary_cases(CAMERAS["davis346"], dev)


def flash_inputs(g, dev, dtype, b, hq, hkv, sq, skv, d, layout: str):
    """Random q, k, v as (B, H, S, D) tensors; "bshd" makes them the
    transposed views of (B, S, H, D) tensors that the model passes."""
    import torch

    def make(h, s):
        if layout == "bshd":
            return torch.randn((b, s, h, d), generator=g, device=dev).to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=g, device=dev).to(dtype)

    return make(hq, sq), make(hkv, skv), make(hkv, skv)


def flash_cases(dev) -> float:
    """Phase 6: the flash-attention kernels against their plain version.

    Every case asserts the route `kernel.route` names and one launch counted
    on it. Returns the max abs error over the bf16 causal GQA cases at the
    serving path's prefill shapes."""
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    bf16, f32 = torch.bfloat16, torch.float32
    g = torch.Generator(device=dev).manual_seed(0)
    # (dtype, B, Hq, Hkv, Sq, Skv, D, causal, layout)
    cases = [(dt, 1, 32, 8, s, s, 128, True, "bshd") for dt in (bf16, f32)
             for s in (32, 128, 512, 2048)]
    cases += [(dt, *c) for dt in (bf16, f32) for c in (
        (1, 32, 8, 128, 512, 128, True, "bhsd"),  # Sq < Skv
        (1, 32, 8, 512, 512, 128, False, "bshd"),
        (1, 8, 8, 256, 256, 64, True, "bhsd"),  # GQA 1
        (1, 8, 8, 256, 256, 64, False, "bshd"),
        (2, 16, 2, 100, 100, 80, True, "bshd"),  # GQA 8, ragged
        (1, 8, 2, 2047, 2047, 80, True, "bhsd"),  # ragged
        (1, 4, 4, 40, 72, 256, True, "bshd"),  # widest heads, Sq < Skv
        (1, 4, 4, 40, 72, 256, False, "bhsd"),
        (2, 4, 2, 100, 300, 16, True, "bhsd"),
        (1, 4, 2, 128, 128, 32, False, "bshd"),
    )]
    cases += [(bf16, 1, 2, 2, 8, 8, 8, True, "bhsd"),  # bf16 off the tensor-core route
              (bf16, 1, 4, 2, 100, 100, 24, True, "bshd")]
    main_err = 0.0
    for dtype, b, hq, hkv, sq, skv, d, causal, layout in cases:
        tol = FLASH_TOL[str(dtype)]
        q, k, v = flash_inputs(g, dev, dtype, b, hq, hkv, sq, skv, d, layout)
        r = route(dtype, d)
        before = dict(cuda.launch_counts)
        got = flash_attention(q, k, v, causal=causal, block_q=sq, block_k=skv)
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        what = (f"flash {r} {str(dtype)[6:]} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                f"D={d} causal={causal} {layout}")
        for key, n in (("flash_attention", 1), (f"flash_attention_{r}", 1)):
            assert cuda.launch_counts[key] == before.get(key, 0) + n, (what, key)
        assert got.dtype == dtype and bool(torch.isfinite(got).all()), what
        assert got.stride() == q.stride(), f"{what}: output strides {got.stride()}"
        assert err <= tol, f"{what}: max abs err {err} > {tol}"
        log(f"  {what}: ok (max abs err {err:.3g}, tol {tol:g})")
        if dtype == bf16 and causal and (hq, hkv, d) == (32, 8, 128) and sq == skv <= 512:
            main_err = max(main_err, err)
    return main_err


def lm_prompts(vocab: int) -> list:
    """8 prompts of 5-500 tokens, numpy seed 0: 3, 3 and 2 in the three
    prefill buckets, in shuffled order."""
    import numpy as np

    rng = np.random.default_rng(0)
    lens = np.concatenate([rng.integers(5, 33, 3), rng.integers(33, 129, 3),
                           rng.integers(129, 501, 2)])
    rng.shuffle(lens)
    return [rng.integers(1, vocab, int(n)).astype(np.int32) for n in lens]


def tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tensors(v)]
    return [tree]


def serve_phase(dev, card: str) -> dict:
    """Phase 7: qwen3-8b served at full width through the Engine."""
    from unittest import mock

    import numpy as np
    import torch

    import repro_torch.models.attention as attention
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine, EngineConfig, Request

    class CheckedEngine(Engine):
        """The port's Engine, asserting every logit row it samples is finite
        and timing admission (prefill + splice) apart from decode."""

        admit_s = 0.0

        def _admit(self):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super()._admit()
            torch.cuda.synchronize()
            self.admit_s += time.perf_counter() - t0

        def _sample_host(self, logits):
            assert np.isfinite(logits).all(), "non-finite logits"
            return super()._sample_host(logits)

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    log(f"{LM_ARCH}: {M.param_count(params) / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    ecfg = EngineConfig(slots=LM_SLOTS, max_len=LM_MAX_LEN, prefill_buckets=LM_BUCKETS)

    # warm-up (cuBLAS handles, allocator): one short request per bucket
    warm = CheckedEngine(cfg, params, ecfg, eos_id=-1)
    for b in LM_BUCKETS:
        warm.submit(Request(rid=-1, prompt=np.ones(b, np.int32), max_new_tokens=2))
    warm.run_until_done()
    del warm

    prompts = lm_prompts(cfg.vocab_size)
    eng = CheckedEngine(cfg, params, ecfg, eos_id=-1)
    assert {eng.bucket_for(len(p)) for p in prompts} == set(LM_BUCKETS)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda.launch_counts.clear()
    t0 = time.perf_counter()
    eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.launch_counts)
    n_tokens = sum(len(r.generated) for r in reqs)
    log(f"serve: {len(reqs)} requests (prompts {sorted(len(p) for p in prompts)}) "
        f"-> {n_tokens} tokens in {eng.step_count} engine steps, "
        f"{1e3 * wall:.1f} ms, launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    for r in reqs:
        assert r.done and len(r.generated) == LM_NEW_TOKENS, (r.rid, r.generated)
    want = cfg.n_layers * len(reqs)
    assert launches.get("flash_attention", 0) == want, (launches, want)
    assert launches.get("flash_attention_tc", 0) == want, (launches, want)
    decode_steps = eng.step_count
    log(f"[{card}] serve {LM_ARCH} bf16: {n_tokens / wall:.1f} tokens/s over the run "
        f"({n_tokens} tokens incl. {len(reqs)} from prefill, {1e3 * wall:.1f} ms: "
        f"admission {1e3 * eng.admit_s:.1f} ms for {len(reqs)} prefills, decode "
        f"{1e3 * (wall - eng.admit_s):.1f} ms for {decode_steps} steps)")

    # one request's prefill logits: the kernel against the plain attention,
    # with the bf16 weights and with a float32 copy of them
    p = max(prompts, key=len)
    toks = torch.zeros((1, eng.bucket_for(len(p))), dtype=torch.long, device=dev)
    toks[0, :len(p)] = torch.as_tensor(p, device=dev)

    def plain(q, k, v, *, causal, block_q, block_k):
        return attention_ref(q, k, v, causal=causal)

    def float64(q, k, v, *, causal, block_q, block_k):
        """The plain version's arithmetic in float64, rounded once to q's
        dtype: how far an exact attention would land from the plain one."""
        g = q.shape[1] // k.shape[1]
        kd, vd = (t.double().repeat_interleave(g, 1) for t in (k, v))
        s = q.double() @ kd.transpose(-1, -2) / q.shape[-1] ** 0.5
        sq, skv = q.shape[2], k.shape[2]
        if causal:
            qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
            s = s.masked_fill(torch.arange(skv, device=q.device)[None, :] > qpos,
                              float("-inf"))
        return (torch.softmax(s, dim=-1) @ vd).to(q.dtype)

    def rel_l2(a, b) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))

    def as_float32(tree):
        if isinstance(tree, dict):
            return {k: as_float32(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [as_float32(v) for v in tree]
        return tree.to(torch.float32)

    for make in (lambda: params, lambda: as_float32(params)):
        weights = make()
        dtype = str(weights["lm_head"].dtype)
        lk, _ = M.prefill(weights, toks, cfg, LM_MAX_LEN, logit_index=len(p) - 1)
        with mock.patch.object(attention, "flash_attention", plain):
            lp, _ = M.prefill(weights, toks, cfg, LM_MAX_LEN, logit_index=len(p) - 1)
        assert bool(torch.isfinite(lk).all()) and lk.shape == (1, 1, cfg.vocab_size)
        rel = rel_l2(lk, lp)
        log(f"prefill logits, {dtype[6:]} weights ({len(p)} tokens, bucket "
            f"{toks.shape[1]}): kernel vs plain attention relative L2 {rel:.3g}, "
            f"max abs {float((lk - lp).abs().max()):.3g}, limit {PREFILL_REL_L2[dtype]:g}")
        assert rel <= PREFILL_REL_L2[dtype], f"prefill logits relative L2 {rel}"
        if dtype == "torch.bfloat16":
            with mock.patch.object(attention, "flash_attention", float64):
                l64, _ = M.prefill(weights, toks, cfg, LM_MAX_LEN,
                                   logit_index=len(p) - 1)
            floor_k, floor_p = rel_l2(lk, l64), rel_l2(lp, l64)
            log(f"  rounding floor: against float64 attention the kernel's logits "
                f"are at relative L2 {floor_k:.3g}, the plain version's at "
                f"{floor_p:.3g} (ratio {floor_k / floor_p:.3g}, limit "
                f"{PREFILL_FLOOR_RATIO:g})")
            assert floor_k <= PREFILL_FLOOR_RATIO * floor_p, (floor_k, floor_p)
            del l64
        del weights, lk, lp
    torch.cuda.empty_cache()
    return {"cfg": cfg, "params": params, "launches": launches,
            "weight_bytes": weight_bytes}


def flash_bound(s: int, dtype) -> tuple[float, str]:
    """Least ms for causal (1, 32, s, 128) over (1, 8, s, 128): q, k, v read
    once and o written once, against the causal FLOPs of both products at
    the card's peak for the dtype (bf16 tensor cores, float32 CUDA cores)."""
    import torch

    hq, hkv, d = 32, 8, 128
    size = torch.finfo(dtype).bits // 8
    nbytes = size * (2 * hq * s * d + 2 * hkv * s * d)
    flops = 4 * hq * d * s * (s + 1) // 2
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def lm_timings(dev, card: str, lm: dict) -> list[dict]:
    """Phase 8: each B3 route beside its plain version and SDPA (device and
    host-inclusive times); prefill per bucket; a warm decode step; profiles
    of one prefill and one decode step."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import model as M

    g = torch.Generator(device=dev).manual_seed(1)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        r = route(dtype, 128)
        for s in FLASH_TIMED_S:
            q, k, v = flash_inputs(g, dev, dtype, 1, 32, 8, s, s, 128, "bshd")
            calls = {
                "kernel": lambda: flash_attention(q, k, v, causal=True, block_q=s, block_k=s),
                "plain": lambda: attention_ref(q, k, v, causal=True),
                "sdpa": lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
            }
            dev_ms = {name: graph_ms(fn) for name, fn in calls.items()}
            eager_ms = {name: cuda_ms(fn, reps=7, inner=10) for name, fn in calls.items()}
            bound_ms, bound_by = flash_bound(s, dtype)
            row = {"route": r, "dtype": str(dtype)[6:], "S": s, "ms": dev_ms["kernel"],
                   "plain_ms": dev_ms["plain"], "library_ms": dev_ms["sdpa"],
                   "bound_ms": bound_ms, "bound_by": bound_by,
                   "bound_share": bound_ms / dev_ms["kernel"],
                   "eager_ms": eager_ms["kernel"], "eager_plain_ms": eager_ms["plain"],
                   "eager_library_ms": eager_ms["sdpa"]}
            if dtype == torch.bfloat16 and s == 512:
                row["profiler_ms"], row["profiler_records"] = profiled_kernel_ms(
                    calls["kernel"], "flash_tc", "flash_attention_tc")
            rows.append(row)
            cross = (f", profiler {row['profiler_ms']:.4f} ms per kernel over "
                     f"{row['profiler_records']} of {GRAPH_CALLS} records"
                     if "profiler_ms" in row else "")
            log(f"[{card}] flash_attention {r} {row['dtype']} causal (1, 32, {s}, 128) over "
                f"(1, 8, {s}, 128), device ms (CUDA graph of {GRAPH_CALLS}): kernel "
                f"{dev_ms['kernel']:.4f}{cross}, plain {dev_ms['plain']:.4f}, SDPA "
                f"{dev_ms['sdpa']:.4f}; bound {bound_ms:.5f} ms ({bound_by}), bound share "
                f"{row['bound_share']:.3f}; host-inclusive eager ms: kernel "
                f"{eager_ms['kernel']:.4f}, plain {eager_ms['plain']:.4f}, SDPA "
                f"{eager_ms['sdpa']:.4f}")

    cfg, params = lm["cfg"], lm["params"]
    for b in LM_BUCKETS:
        toks = torch.randint(1, cfg.vocab_size, (1, b), generator=g, device=dev)
        ms = cuda_ms(lambda: M.prefill(params, toks, cfg, LM_MAX_LEN), reps=3, inner=2)
        log(f"[{card}] prefill {LM_ARCH} bucket {b}: {ms:.2f} ms")
    n = log_breakdown(card, f"prefill bucket {LM_BUCKETS[-1]}",
                      lambda: M.prefill(params, toks, cfg, LM_MAX_LEN), top=10)
    assert n <= PREFILL_MAX_LAUNCHES, f"prefill launched {n} kernels"

    state = M.init_decode_state(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (LM_SLOTS, 1), generator=g, device=dev)
    lengths = torch.tensor([37, 120, 480, 300][:LM_SLOTS], device=dev)

    def step():
        return M.decode_step_batched(params, state, tokens, lengths, cfg)

    ms = cuda_ms(step, reps=5, inner=3)
    bound = 1e3 * lm["weight_bytes"] / HBM_BYTES_PER_S
    log(f"[{card}] decode step {LM_ARCH} {LM_SLOTS} slots: {ms:.2f} ms warm, bound "
        f"{bound:.2f} ms ({lm['weight_bytes'] / 1e9:.2f} GB of weights at 3.35 TB/s)")
    log_breakdown(card, "decode step", step, top=10)
    return rows


def emvs_config():
    """The EMVS main path's camera (DAVIS240), DSI (128 planes over
    0.6-4.5 m), options (fused kernel, nearest, Table-1 quantized) and scene."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import EMVSOptions
    from repro_torch.events.simulator import SceneConfig, make_scene

    cam = CameraModel()
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=128, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", voting="nearest", quantized=True,
                       keyframe_dist_frac=0.05)
    return cam, dsi_cfg, opts, make_scene(SceneConfig(name="simulation_3planes"))


def emvs_frames(cam, scene):
    """The simulated events of a 96-step arc, their 1024-event frames and
    the trajectory."""
    from repro_torch.events.aggregation import aggregate
    from repro_torch.events.simulator import make_trajectory, simulate_events

    traj = make_trajectory("simulation_3planes", 96)
    events = simulate_events(cam, scene, traj)
    return events, aggregate(cam, events, traj, events_per_frame=1024), traj


def main_bucket(cam, dsi_cfg, frames, opts):
    """The sweep kernel's inputs `(xy0, valid, phi)` for the capacity bucket
    with most segments, as `run_emvs` builds them."""
    import torch

    from repro_torch.core.geometry import SE3
    from repro_torch.core.pipeline import (
        bucket_capacity,
        pad_segments,
        plan_segments,
        precompute_batch_geometry,
    )
    from repro_torch.kernels.backproject_vote.ops import canonical_inputs

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
    return canonical_inputs(batch.xy, batch.valid, geoms.H, phi,
                            quantized=opts.quantized, frame_valid=batch.frame_valid)


def sweep_bound(s: int, c: int, e: int, nz: int, w: int, h: int, n_valid: int):
    """B1's least ms for S segments of C frames of E events onto Nz planes
    of w x h, int16 store: x0, y0 (float32) and the bool mask per event,
    phi, the int16 DSI; 9 float32 operations per valid (event, plane)."""
    return emvs_bound(9 * s * c * e + 12 * s * c * nz + 2 * s * nz * h * w,
                      B1_OPS_PER_PROJECTION * n_valid * nz)


def davis346_phase(card: str, scene, main_cfg, opts) -> dict:
    """Phase 4b: the main path on a DAVIS346 (346x260, two row bands in
    B1), with phase 4's scene, trajectory and options: kernel == scatter
    bitwise, float and quantized; AbsRel on the float datapath (Table 1's
    8-bit plane coordinates park off-range columns at 255, a real column
    past 256 pixels, so the quantized AbsRel is logged, not held); the
    warm wall; B1's device time at the bucket with most segments."""
    import torch

    from repro_torch.core.camera import CAMERAS
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import run_emvs
    from repro_torch.events.simulator import absrel, ground_truth_depth
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda

    cam = CAMERAS["davis346"]
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=main_cfg.num_planes,
                                   z_min=main_cfg.z_min, z_max=main_cfg.z_max)
    _, frames, _ = emvs_frames(cam, scene)
    absrels, launches = {}, {}
    for quantized in (False, True):
        o = dataclasses.replace(opts, quantized=quantized)
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        result = run_emvs(cam, dsi_cfg, frames, o)
        torch.cuda.synchronize()
        launches[quantized] = dict(cuda.launch_counts)
        for name in ("backproject_vote", "depth_argmax"):
            assert launches[quantized].get(name, 0) > 0, f"DAVIS346 never launched {name}"
        plain = run_emvs(cam, dsi_cfg, frames, dataclasses.replace(o, formulation="scatter"))
        assert len(plain.segments) == len(result.segments) >= 2
        errs = []
        for k, (seg, ref) in enumerate(zip(result.segments, plain.segments)):
            what = f"DAVIS346 quantized={quantized} segment {k}"
            assert seg.frame_range == ref.frame_range
            assert seg.depth_map.depth.shape == (cam.height, cam.width)
            assert bool(torch.isfinite(seg.depth_map.depth).all())
            # the kernel formulation stores float32 votes on the float
            # datapath, scatter int32 counts (exact in float32)
            assert_equal(seg.dsi.float(), ref.dsi.float(), f"{what}: kernel vs scatter dsi")
            assert_equal(seg.depth_map.depth, ref.depth_map.depth, f"{what}: depth")
            assert_equal(seg.depth_map.mask, ref.depth_map.mask, f"{what}: mask")
            gt, gtm = ground_truth_depth(cam, scene, seg.T_w_ref)
            errs.append(float(absrel(seg.depth_map.depth, seg.depth_map.mask, gt, gtm)))
        absrels[quantized] = sum(errs) / len(errs)
        log(f"DAVIS346 {cam.width}x{cam.height} quantized={quantized}: "
            f"{frames.xy.shape[0]} frames -> {len(result.segments)} segments, launches "
            f"{launches[quantized]}; kernel == scatter bitwise on dsi, depth, mask; "
            f"AbsRel per segment {[round(x, 4) for x in errs]}, mean {absrels[quantized]:.4f}")
    assert absrels[False] < 0.25, f"DAVIS346 float mean AbsRel {absrels[False]} too high"

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_emvs(cam, dsi_cfg, frames, opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log_breakdown(card, "DAVIS346 run_emvs", lambda: run_emvs(cam, dsi_cfg, frames, opts))

    xy0, valid, phi = main_bucket(cam, dsi_cfg, frames, opts)
    s, c, e = valid.shape
    nz, h, w = dsi_cfg.shape
    shape_note = f"S={s} C={c} E={e} Nz={nz} {w}x{h}"
    compare_b1_b2(xy0, valid, phi, cam=cam, mode="nearest", quantized=True,
                  what=f"DAVIS346 bucket {shape_note}")
    x0, y0 = xy0[..., 0].contiguous(), xy0[..., 1].contiguous()
    device_ms = graph_ms(lambda: backproject_vote_cuda(x0, y0, valid, phi, cx=cam.cx,
                                                       cy=cam.cy, w=w, h=h, quantized=True))
    bound, by = sweep_bound(s, c, e, nz, w, h, int(valid.sum()))
    rows = band_rows_of(w, h)
    n_bands = -(-h // rows)
    log(f"[{card}] DAVIS346 run_emvs (kernel, nearest, quantized) warm wall "
        f"{1e3 * wall:.1f} ms median of {len(walls)}; backproject_vote at {shape_note} "
        f"int16 in {n_bands} bands of {rows} rows: device {device_ms:.4f} ms (CUDA graph of "
        f"{GRAPH_CALLS}), bound {bound:.4f} ms ({by}), bound share {bound / device_ms:.3f}")
    return {"device_ms": device_ms, "bound_ms": bound, "n_bands": n_bands, "wall_ms": 1e3 * wall,
            "absrel": absrels, "launches": launches[True], "shape": shape_note}


def paper_tables(card: str) -> dict:
    """Phase 4c: the paper's Fig 4a, 4b and 7a at the reference's sizes and
    Table 3, on the card. Each kernel row equals its matmul row (the
    benchmarks raise otherwise, and it is asserted again here) and every
    figure's claim holds."""
    import torch

    from repro_torch.benchmarks import fig4a_voting, fig4b_quant, fig7a_accuracy, table3_runtime
    from repro_torch.kernels import cuda

    torch.cuda.synchronize()
    cuda.launch_counts.clear()
    figs = {"4a": fig4a_voting.run(), "4b": fig4b_quant.run(), "7a": fig7a_accuracy.run()}
    torch.cuda.synchronize()
    launches = dict(cuda.launch_counts)
    for name in ("backproject_vote", "depth_argmax"):
        assert launches.get(name, 0) > 0, f"the paper tables never launched {name}"
    for fig, out in figs.items():
        log(f"[{card}] Fig {fig} AbsRel on {out['device']}:")
        for seq, row in out["rows"].items():
            for key, value in row.items():
                if key.endswith("_kernel"):
                    assert value == row[key[:-len("_kernel")]], (fig, seq, key)
            log(f"  {seq:20s} " + "  ".join(f"{k} {v:.4f}" for k, v in row.items()))
        gap_key = next(k for k in out if k.startswith("max_"))
        log(f"  {gap_key} {out[gap_key]:.4f} (paper "
            f"{out.get('paper_claim_max_gap', out.get('paper_claim_max_diff'))}), "
            f"claim_ok {out['claim_ok']}; kernel rows == matmul rows")
        assert out["claim_ok"], f"Fig {fig}: the paper's claim does not hold"
    log(f"paper tables: launches {launches}")
    t3 = table3_runtime.run()
    log(f"[{card}] Table 3 per 1024-event frame ({t3['timer']}):")
    for name in ("software_scatter", "matmul", "b1_eventor_analogue"):
        r = t3[name]
        log(f"  {name:22s} P(Z0) {r['P(Z0) us']:.3f} us, P(Z0->Zi)&R "
            f"{r['P(Z0->Zi)&R us']:.3f} us, normal {r['normal Mev/s']:.1f} Mev/s, "
            f"key {r['key Mev/s']:.1f} Mev/s")
    return {"figs": figs, "table3": t3, "launches": launches}


def examples_phase(card: str) -> None:
    """Phase 4d: the two examples on the card at reduced steps. The merged
    map's outlier filter keeps exactly the points the filter keeps on the
    CPU from the same cloud, and the kernel variant's AbsRel equals the
    matmul variant's."""
    import tempfile

    import torch

    from repro_torch.core.pointcloud import PointCloud, radius_outlier_filter
    from repro_torch.examples import emvs_reconstruction, quickstart
    from repro_torch.kernels import cuda

    torch.cuda.synchronize()
    cuda.launch_counts.clear()
    errs = quickstart.main(["--steps", "24"])
    launches = dict(cuda.launch_counts)
    assert launches.get("backproject_vote", 0) > 0, "quickstart never launched B1"
    assert errs and all(0 < e < 0.25 for e in errs), errs
    with tempfile.TemporaryDirectory() as tmp:
        for camera in ("davis240", "davis346"):
            cuda.launch_counts.clear()
            res = emvs_reconstruction.main(["--camera", camera, "--steps", "24",
                                            "--out", os.path.join(tmp, f"{camera}.npz")])
            launches = dict(cuda.launch_counts)
            assert launches.get("backproject_vote", 0) > 0, "the example never launched B1"
            kernel = next(k for k in res["absrel"] if k.startswith("CUDA kernels"))
            assert res["absrel"][kernel] == res["absrel"][emvs_reconstruction.MERGED_VARIANT]
            merged, filtered = res["merged"], res["filtered"]
            assert filtered.valid.is_cuda
            on_cpu = radius_outlier_filter(PointCloud(*(t.cpu() for t in merged)),
                                           radius=0.08, min_neighbors=2)
            assert_equal(filtered.valid.cpu(), on_cpu.valid, f"{camera}: filtered map")
            assert 0 < int(filtered.valid.sum()) < int(merged.valid.sum())
            log(f"[{card}] emvs_reconstruction {camera}: launches {launches}; merged map "
                f"{int(merged.valid.sum())} points, {int(filtered.valid.sum())} after the "
                f"filter, the same points as the CPU's filter")

def stream_feed(engine, events, traj, chunk: int, *, gated: bool):
    """Drive one stream: event chunks of `chunk`; when `gated`, the pose
    stream in chunks of STREAM_POSE_CHUNK samples, each pushed once the
    event front has passed its last sample (a tracker trailing the
    sensor). Returns (result, ms from the first push to the first
    SegmentResult, ms from the first push to the end of flush)."""
    import torch

    from repro_torch.events.simulator import iter_trajectory_chunks
    from repro_torch.serving.emvs_stream import iter_event_chunks

    poses = list(iter_trajectory_chunks(traj, STREAM_POSE_CHUNK)) if gated else []
    ends = [float(p.times[-1]) for p in poses]
    t0 = time.perf_counter()
    first = None
    for c in iter_event_chunks(events, chunk):
        out = engine.push(c)
        front = float(c.t[-1])
        while poses and ends[0] <= front:
            ends.pop(0)
            out += engine.push_poses(poses.pop(0))
        if out and first is None:
            first = time.perf_counter()
    if gated:
        for p in poses:
            engine.push_poses(p)
        engine.finalize_poses()
    result = engine.flush()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    if first is None:
        first = t1
    return result, 1e3 * (first - t0), 1e3 * (t1 - t0)


def assert_same_results(got, want, what: str) -> None:
    assert [s.frame_range for s in got.segments] == [s.frame_range for s in want.segments], what
    for k, (a, b) in enumerate(zip(got.segments, want.segments)):
        assert_equal(a.dsi, b.dsi, f"{what} segment {k}: dsi")
        assert_equal(a.depth_map.depth, b.depth_map.depth, f"{what} segment {k}: depth")
        assert_equal(a.depth_map.mask, b.depth_map.mask, f"{what} segment {k}: mask")


def streaming_phase(card: str, cam, dsi_cfg, opts, events, traj) -> dict:
    """Phase 4e: the streaming engine on the card at the main path's width.

    The offline baseline is `run_emvs` on the card over frames aggregated on
    the host (the engine's sessions aggregate there). Every streamed result
    must equal it bitwise on dsi, depth and mask: one pose-gated stream per
    chunking (STREAM_CHUNKS) and dispatch policy, and two sessions on one
    MultiStreamEngine (the full stream and its first STREAM_CUT_FRAMES
    frames, round_robin, throughput) under the balanced and starved schedules, each
    session equal to its dedicated engine. B1 and B2 launch once per
    dispatch; `_dispatch` runs under torch.cuda.set_sync_debug_mode("error")
    in one adaptive stream; B1 is held against its plain version on one
    streamed dispatch's batch. Prints the first-depth-map latency, the warm
    walls, dispatch counts, device ms per sweep, the sweep-time histogram,
    a profile of one warm stream, the frame store's peak bytes and the cost
    table a SweepProfiler recorded (written to STREAM_COST_TABLE)."""
    import torch

    from repro_torch.core.geometry import SE3
    from repro_torch.core.pipeline import precompute_batch_geometry, run_emvs
    from repro_torch.events.aggregation import aggregate
    from repro_torch.events.simulator import EventStream, Trajectory
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote.ops import canonical_inputs
    from repro_torch.profiling import SweepProfiler
    from repro_torch.serving import sweep_dispatcher
    from repro_torch.serving.emvs_stream import (
        EMVSStreamEngine,
        MultiStreamEngine,
        StreamConfig,
        iter_event_chunks,
    )

    t_phase = time.perf_counter()
    # a camera's events and a tracker's poses reach the host first
    events_card = events
    events = EventStream(*(a.cpu() for a in events))
    traj = Trajectory(traj.times.cpu(), SE3(traj.poses.R.cpu(), traj.poses.t.cpu()))
    host_frames = aggregate(cam, events, traj, events_per_frame=1024, device="cpu")
    base = run_emvs(cam, dsi_cfg, host_frames, opts)
    assert len(base.segments) >= 2
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_emvs(cam, dsi_cfg, aggregate(cam, events, traj, events_per_frame=1024,
                                         device="cpu"), opts)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    offline_ms = statistics.median(walls)

    def engine(policy="adaptive", gated=True, **kw):
        return EMVSStreamEngine(cam, dsi_cfg, None if gated else traj, opts,
                                StreamConfig(dispatch_policy=policy, max_inflight=2), **kw)

    # the pose-gated single stream: every chunking x policy, bitwise
    counts = {}
    for chunk in STREAM_CHUNKS:
        for policy in ("latency", "throughput", "adaptive"):
            e = engine(policy)
            torch.cuda.synchronize()
            cuda.launch_counts.clear()
            result, first_ms, wall_ms = stream_feed(e, events, traj, chunk, gated=True)
            launches = dict(cuda.launch_counts)
            st = e.stats
            assert_same_results(result, base, f"stream {policy} chunk {chunk}")
            for name in ("backproject_vote", "depth_argmax"):
                assert launches.get(name, 0) == st["dispatches"], (policy, chunk, name, launches)
            counts[(chunk, policy)] = (st["dispatches"], st["coalesced_segments"],
                                       st["padded_segments"], st["segments"])
    log(f"stream (pose-gated, pose chunks of {STREAM_POSE_CHUNK}, max_inflight 2): every "
        f"chunking x policy bitwise run_emvs on host-aggregated frames; "
        f"(dispatches, coalesced segments, padded segments, segments): "
        + ", ".join(f"{c}/{p} {v}" for (c, p), v in counts.items()))

    # warm timings of the main streamed run (adaptive, the first chunking)
    # and the launches of that run
    chunk = STREAM_CHUNKS[0]
    firsts, stream_walls = [], []
    for _ in range(3):
        e = engine("adaptive")
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        result, first_ms, wall_ms = stream_feed(e, events, traj, chunk, gated=True)
        launches = dict(cuda.launch_counts)
        firsts.append(first_ms)
        stream_walls.append(wall_ms)
    st = e.stats
    main_launches = launches
    dev_hist = e._dispatcher.device_time_s.snapshot()
    assert dev_hist["count"] == st["dispatches"] == launches["backproject_vote"]
    log(f"[{card}] stream adaptive, {chunk}-event chunks, {len(result.segments)} segments in "
        f"{st['dispatches']} dispatches: first depth map {statistics.median(firsts):.2f} ms "
        f"after the first push (runs {[round(x, 2) for x in firsts]}); warm wall "
        f"{statistics.median(stream_walls):.2f} ms (runs {[round(x, 2) for x in stream_walls]}) "
        f"against offline aggregate + run_emvs {offline_ms:.2f} ms (runs "
        f"{[round(x, 2) for x in walls]}); launches {launches}")
    log(f"[{card}] stream device span per sweep (its start and done CUDA events, which "
        f"include the card's idle time while the host enqueues): mean "
        f"{1e3 * dev_hist['total_s'] / dev_hist['count']:.4f} ms, max "
        f"{1e3 * dev_hist['max_s']:.4f} ms over {dev_hist['count']} sweeps; sweep_time_s "
        f"(host, dispatch to harvest): count "
        f"{st['sweep_time_s']['count']}, mean "
        f"{1e3 * st['sweep_time_s']['total_s'] / st['sweep_time_s']['count']:.3f} ms, max "
        f"{1e3 * st['sweep_time_s']['max_s']:.3f} ms, bins {st['sweep_time_s']['bins']} over "
        f"edges {st['sweep_time_s']['bin_edges_s']} s; frame store peak "
        f"{st['frame_store_peak_bytes']} B")
    log_breakdown(card, f"stream (adaptive, {chunk}-event chunks)",
                  lambda: stream_feed(engine("adaptive"), events, traj, chunk, gated=True))

    # no host sync in _dispatch; B1 against its plain version on one
    # streamed dispatch's batch
    e = engine("adaptive")
    dispatcher = e._dispatcher
    dispatch, sweep = dispatcher._dispatch, sweep_dispatcher.process_segments_batched
    batches = []

    def strict(group, cap):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(group, cap)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def keep_batch(cam_, cfg_, batch, opts_):
        batches.append(batch)
        return sweep(cam_, cfg_, batch, opts_)

    dispatcher._dispatch = strict
    sweep_dispatcher.process_segments_batched = keep_batch
    try:
        result, _, _ = stream_feed(e, events, traj, chunk, gated=True)
    finally:
        sweep_dispatcher.process_segments_batched = sweep
    assert_same_results(result, base, "stream under sync_debug_mode('error')")
    assert len(batches) == dispatcher.stats["dispatches"]
    batch = batches[0]
    planes = dsi_cfg.planes(device=batch.xy.device)
    geoms = precompute_batch_geometry(cam, batch.poses_R, batch.poses_t,
                                      SE3(batch.ref_R[:, None], batch.ref_t[:, None]), planes,
                                      planes[dsi_cfg.num_planes // 2])
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], -1)
    xy0, valid, phi = canonical_inputs(batch.xy, batch.valid, geoms.H, phi,
                                       quantized=opts.quantized, frame_valid=batch.frame_valid)
    s_, c_, e_ = valid.shape
    err1, _ = compare_b1_b2(xy0, valid, phi, cam=cam, mode=opts.voting,
                            quantized=opts.quantized,
                            what=f"streamed dispatch S={s_} C={c_} E={e_}")
    log(f"stream: {dispatcher.stats['dispatches']} dispatches under "
        f"set_sync_debug_mode('error'), no host sync; B1 and B2 bitwise their plain versions "
        f"on one streamed dispatch's batch (S={s_} C={c_} E={e_})")

    # two sessions on one MultiStreamEngine, round_robin; "throughput" lets
    # same-capacity segments of the two sessions share a dispatch
    cut = STREAM_CUT_FRAMES * 1024 + 517
    ev_b = EventStream(*(a[:cut] for a in events))
    # session a is fed the events where the simulator made them, on the
    # card: a session copies each chunk to the host once
    dedicated_b = EMVSStreamEngine(cam, dsi_cfg, traj, opts, StreamConfig())
    want_b, _, _ = stream_feed(dedicated_b, ev_b, traj, chunk, gated=False)
    for schedule in ("balanced", "starved"):
        multi = MultiStreamEngine(cam, dsi_cfg, opts, StreamConfig(
            fairness="round_robin", dispatch_policy="throughput"))
        a = multi.add_session("a", traj=traj)
        b = multi.add_session("b", traj=traj if schedule == "balanced" else None)
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        chunks_a = list(iter_event_chunks(events_card, chunk))
        chunks_b = list(iter_event_chunks(ev_b, chunk))
        if schedule == "balanced":
            for k in range(max(len(chunks_a), len(chunks_b))):
                if k < len(chunks_a):
                    a.push(chunks_a[k])
                if k < len(chunks_b):
                    b.push(chunks_b[k])
            res = {"a": a.flush(), "b": b.flush()}
        else:
            for c in chunks_b:
                b.push(c)  # every frame of b stalls: no poses yet
            for c in chunks_a:
                a.push(c)
            res = {"a": a.flush()}
            b.push_poses(traj)
            b.finalize_poses()
            res["b"] = b.flush()
        d = multi.stats["dispatcher"]
        launches = dict(cuda.launch_counts)
        assert launches.get("backproject_vote", 0) == d["dispatches"]
        assert_same_results(res["a"], base, f"multi {schedule} session a")
        assert_same_results(res["b"], want_b, f"multi {schedule} session b")
        log(f"multi-stream {schedule} (round_robin, throughput, sessions of {len(base.segments)} and "
            f"{len(want_b.segments)} segments): each session bitwise its dedicated engine; "
            f"dispatches {d['dispatches']}, cross_stream_dispatches "
            f"{d['cross_stream_dispatches']}, coalesced segments {d['coalesced_segments']}")

    # the cost table a SweepProfiler records on the card
    profiler = SweepProfiler()
    for policy in ("latency", "throughput", "adaptive"):
        for _ in range(2):
            stream_feed(engine(policy, profiler=profiler), events, traj, chunk, gated=True)
    os.makedirs(os.path.dirname(STREAM_COST_TABLE), exist_ok=True)
    profiler.table.save(STREAM_COST_TABLE)
    log(f"[{card}] SweepProfiler cost table ({len(profiler.table)} variants, "
        f"{profiler.skipped_cold} cold and {profiler.skipped_shadowed} shadowed sweeps "
        f"skipped), written to {os.path.relpath(STREAM_COST_TABLE, ROOT)}: "
        + json.dumps(profiler.table.to_json()["entries"]))
    log(f"streaming phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": main_launches, "max_abs_err": err1}


def emvs_bound(nbytes: int, nops: int) -> tuple[float, str]:
    """Least ms for `nbytes` of device memory traffic and `nops` float32
    operations on the card, and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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

    from repro_torch.core.dsi import to_storage
    from repro_torch.core.pipeline import run_emvs
    from repro_torch.events.simulator import absrel, ground_truth_depth
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote import kernel as b1_kernel
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
    n_hgmma = sass_count(cuda.library_path("flash_attention"), "HGMMA")
    log(f"flash_attention SASS: {n_hgmma} HGMMA instructions")
    assert n_hgmma > 0, "no wgmma in the flash-attention library"
    n_bulk = sass_count(cuda.library_path("backproject_vote"), B1_BULK_COPY_SASS)
    log(f"backproject_vote SASS: {n_bulk} {B1_BULK_COPY_SASS} (bulk copy) instructions")
    assert n_bulk > 0, "no bulk copy in the sweep kernel's library"

    # 3. kernels vs plain versions on the card
    cam, dsi_cfg, opts, scene = emvs_config()
    log("kernel vs plain:")
    kernel_cases(cam, dev)
    log("row bands, kernel vs plain:")
    band_cases(dev)

    # 4. the main path at the paper's width
    torch.cuda.synchronize()
    cuda.launch_counts.clear()
    t0 = time.perf_counter()
    events, frames, traj = emvs_frames(cam, scene)
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

    # 5. timings at the main path's shapes: the bucket with most segments,
    # and its first segment alone (S=1)
    xy0, valid, phi = main_bucket(cam, dsi_cfg, frames, opts)
    s, c, e = valid.shape
    nz, h, w = dsi_cfg.shape
    shape_note = f"S={s} C={c} E={e} Nz={nz} {w}x{h}"
    err1, err2 = compare_b1_b2(xy0, valid, phi, cam=cam, mode="nearest",
                               quantized=True, what=f"main-path bucket {shape_note}")
    log(f"main-path bucket {shape_note}: kernels bitwise with plain versions")
    band_rows = band_rows_of(w, h)
    n_bands = -(-h // band_rows)
    smem = b1_kernel.smem_bytes(w, band_rows)
    assert b1_kernel.kernel_smem_bytes(w, band_rows) == smem, "the wrapper's shared-memory plan"
    log(f"backproject_vote: {n_bands} band(s) of {band_rows} rows, {smem} B of shared "
        f"memory per CTA")

    timed = {}
    for label, rows in (("main", slice(None)), ("S=1", slice(0, 1))):
        x0 = xy0[rows, ..., 0].contiguous()
        y0 = xy0[rows, ..., 1].contiguous()
        v, p = valid[rows].contiguous(), phi[rows].contiguous()
        stored = b1_kernel.backproject_vote_cuda(x0, y0, v, p, cx=cam.cx, cy=cam.cy,
                                                 w=w, h=h, quantized=True)

        def b1(x0=x0, y0=y0, v=v, p=p):
            return b1_kernel.backproject_vote_cuda(x0, y0, v, p, cx=cam.cx, cy=cam.cy,
                                                   w=w, h=h, quantized=True)

        def b2(stored=stored):
            return depth_argmax_cuda(stored)

        sb = v.shape[0]
        b1_bound, b1_by = sweep_bound(sb, c, e, nz, w, h, int(v.sum()))
        b2_bound, b2_by = emvs_bound(2 * sb * nz * h * w + 8 * sb * h * w,
                                     B2_OPS_PER_VOXEL * sb * nz * h * w)
        row = {"S": sb, "b1_device_ms": graph_ms(b1), "b1_eager_ms": cuda_ms(b1, reps=7, inner=5),
               "b1_bound_ms": b1_bound, "b1_bound_by": b1_by,
               "b2_device_ms": graph_ms(b2), "b2_eager_ms": cuda_ms(b2, reps=7, inner=5),
               "b2_bound_ms": b2_bound, "b2_bound_by": b2_by}
        if label == "main":
            row["b1_plain_ms"] = cuda_ms(lambda: to_storage(backproject_vote_ref(
                xy0, valid, phi, cx=cam.cx, cy=cam.cy, w=w, h=h,
                quantize_plane_coords=True)), reps=3, inner=1)
            row["b2_plain_ms"] = cuda_ms(lambda: depth_argmax_ref(stored), reps=7, inner=5)
            row["b1_profiler_ms"], row["b1_profiler_records"] = profiled_kernel_ms(
                b1, "backproject_vote", "backproject_vote")
        timed[label] = row
        log(f"[{card}] backproject_vote at S={sb} C={c} E={e} Nz={nz} {w}x{h} int16: "
            f"device {row['b1_device_ms']:.4f} ms (CUDA graph of "
            f"{GRAPH_CALLS}), host-inclusive eager {row['b1_eager_ms']:.4f} ms; bound "
            f"{b1_bound:.4f} ms ({b1_by}), bound share {b1_bound / row['b1_device_ms']:.3f}"
            + (f"; profiler {row['b1_profiler_ms']:.4f} ms over {row['b1_profiler_records']} "
               f"of {GRAPH_CALLS} records; plain {row['b1_plain_ms']:.2f} ms"
               if label == "main" else ""))
        log(f"[{card}] depth_argmax at S={sb} Nz={nz} {w}x{h} int16: device "
            f"{row['b2_device_ms']:.4f} ms, host-inclusive eager {row['b2_eager_ms']:.4f} ms; "
            f"bound {b2_bound:.4f} ms ({b2_by}), bound share "
            f"{b2_bound / row['b2_device_ms']:.3f}"
            + (f"; plain {row['b2_plain_ms']:.4f} ms" if label == "main" else ""))
    main_row = timed["main"]

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_emvs(cam, dsi_cfg, frames, opts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    log(f"[{card}] run_emvs (kernel, nearest, quantized) warm wall "
        f"{1e3 * wall:.1f} ms median of {len(walls)} ({len(result.segments)} "
        f"segments, {frames.xy.shape[0]} frames); whole script "
        f"{time.perf_counter() - t_start:.1f} s")
    log_breakdown(card, "run_emvs", lambda: run_emvs(cam, dsi_cfg, frames, opts))

    # 4b-4e. DAVIS346, the paper's tables, the examples, the streaming engine
    t0 = time.perf_counter()
    d346 = davis346_phase(card, scene, dsi_cfg, opts)
    paper_tables(card)
    examples_phase(card)
    log(f"DAVIS346, paper tables and examples: {time.perf_counter() - t0:.1f} s")
    stream = streaming_phase(card, cam, dsi_cfg, opts, events, traj)

    # 6. the flash-attention kernel vs its plain version
    log("flash attention kernel vs plain:")
    b3_err = flash_cases(dev)

    # 7. the LM serving path at full width; 8. its timings
    lm = serve_phase(dev, card)
    b3_rows = lm_timings(dev, card, lm)
    b3 = next(r for r in b3_rows if r["route"] == "tc" and r["S"] == LM_BUCKETS[-1])
    log(f"whole script {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "backproject_vote", "route": "cuda",
         "source": "src/repro_torch/csrc/backproject_vote.cu",
         "replaces": "src/repro/kernels/backproject_vote/kernel.py:241",
         "launches": launches["backproject_vote"], "max_abs_err": err1,
         "launches_streaming": stream["launches"]["backproject_vote"],
         "max_abs_err_streaming": stream["max_abs_err"],
         "ms": main_row["b1_eager_ms"], "plain_ms": main_row["b1_plain_ms"],
         "bound_ms": main_row["b1_bound_ms"], "bound_by": main_row["b1_bound_by"],
         "library_ms": None, "device_ms": main_row["b1_device_ms"],
         "device_ms_s1": timed["S=1"]["b1_device_ms"], "smem_bytes": smem,
         "n_bands": n_bands, "device_ms_davis346": d346["device_ms"],
         "bound_ms_davis346": d346["bound_ms"], "n_bands_davis346": d346["n_bands"],
         "bulk_copy_instructions": n_bulk,
         "shape": f"{shape_note} int16; ms host-inclusive eager, device_ms a CUDA graph",
         "shape_davis346": f"{d346['shape']} int16, device time"},
        {"name": "depth_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/local_max.cu",
         "replaces": "src/repro/kernels/local_max/kernel.py:74",
         "launches": launches["depth_argmax"], "max_abs_err": err2,
         "launches_streaming": stream["launches"]["depth_argmax"],
         "ms": main_row["b2_eager_ms"], "plain_ms": main_row["b2_plain_ms"],
         "bound_ms": main_row["b2_bound_ms"], "bound_by": main_row["b2_bound_by"],
         "library_ms": None, "device_ms": main_row["b2_device_ms"],
         "device_ms_s1": timed["S=1"]["b2_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
         "launches": lm["launches"]["flash_attention"], "max_abs_err": b3_err,
         "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": b3["library_ms"],
         "shape": "bf16 causal (1, 32, S, 128) over (1, 8, S, 128), S = 512, "
                  "tensor-core route, device time",
         "launches_by_route": {r: lm["launches"].get(f"flash_attention_{r}", 0)
                               for r in ("tc", "fma")},
         "hgmma_instructions": n_hgmma,
         "per_shape": b3_rows},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
