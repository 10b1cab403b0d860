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
  4f. the segment-sharded backend (`repro_torch.distributed.emvs`) at the
     main path's width, over a world-size-1 NCCL process group from a
     FileStore in a temporary directory (destroyed at the phase's end):
     `run_emvs(sweep="sharded", mesh=make_segment_mesh())` equals the
     batched backend bitwise on dsi, depth and mask for every segment, B1
     and B2 launch once per bucket sweep (counts zeroed before and read
     after), the quantized DSI's int16 store comes back exact from the
     byte-view gather; an EMVSStreamEngine with StreamConfig(sweep=
     "sharded") equals `run_emvs` over host-aggregated frames bitwise
     under every policy with B1 and B2 once per dispatch, and `_dispatch`
     runs under torch.cuda.set_sync_debug_mode("error"); `make_emvs_step`
     on a (1, 1) ("data", "model") mesh against `process_segment(
     formulation="matmul")` on the first segment: nearest exact and the
     mask equal, bilinear dsi within STEP_BILINEAR_ATOL. Prints the
     sharded and batched run_emvs walls in turns and a profile of one
     sharded run_emvs, the sharded stream's first depth map and wall; then
     runs `repro_torch.benchmarks.streaming_latency --main-path` in
     4096-event chunks, which records the port's own cost table
     (results/cost_table_h100.json), prints its rows and fails unless
     `dispatch_replay.check_slo_burst` passes on it, and prints the
     calibration report of `repro_torch.profiling.calibrate` on that table.
     The benchmark runs at the reference's default of one 1024-event frame
     per chunk; its headline gate (first depth map below the offline wall)
     holds there since the oracle's poses are interpolated on the host
     (`events.trajectory_stream.PoseInterpolator`), and the phase prints
     the host ingest per push. `--main-path`
     holds the dispatch-policy gate at the smoke's min_ratio 0.85 and 3
     sessions, not the reference's full-size 1.0 and 4: its bursts of 6
     segments save one dispatch, less than the wall's jitter between runs;
  9. (after 4f) the port's tooling on the card: the EMVS fusion ladder
     (`repro_torch.benchmarks.roofline_report`) at the main path's largest
     bucket, every rung's bound from `repro_torch.launch.roofline` beside
     the measured device time of the unfused rung (the scatter
     formulation's float32 votes, the int16 storage round trip, B2; its
     conf and zf must equal the fused rung's) and of the fused-store rung
     (B1 then B2), CUDA graphs between events; the dry run
     (`repro_torch.launch.dryrun.run_cell`) of eventor-davis240's emvs_rt
     and emvs_seg and qwen3-8b's prefill_32k and decode_32k on fake CUDA
     tensors: `torch.cuda.memory_allocated()` must not move, and emvs_seg's
     B1 call must count the bytes of `roofline.sweep_bound`; the linter's
     quick grid (`python -m repro_torch.analysis.lint --grid quick`) on
     fake CUDA tensors must report no new finding against the port's
     baseline; B1 at the linter's proof capacity (64 frames x 1024 events,
     every event on one voxel of every plane: 65,536 votes) must equal its
     plain version bitwise, float (65,536) and quantized (saturated at
     32,767); a warm run_emvs launches B1 and B2 once per bucket;
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
     serving run; and profiles one prefill of the largest bucket (the
     most launches of PREFILL_LAUNCH_TRACES traces at most
     PREFILL_MAX_LAUNCHES) and one decode step;
  10. frees phase 7's weights and serves the MoE, SSM and hybrid families
     through the same Engine (4 slots, max_len 1024, 8 requests of
     `lm_prompts`, 16 new tokens each; launch counts zeroed just before each
     run and read just after; every request done and every sampled logit
     row finite): (a) deepseek-moe-16b at full width (28 layers, 64 routed
     experts top-6 + 2 shared, random bf16 weights drawn on the card),
     flash_attention launched 28 times per request, all on the tensor-core
     route; the largest prompt's prefill logits with the kernel within
     PREFILL_REL_L2 (bf16) of the plain attention, and the q, k, v of each
     of its 28 attention layers through the kernel (one tensor-core launch
     each) against the plain version within FLASH_TOL; the same on
     MOE_F32_LAYERS layers in float32; layer 0's MoE on MOE_CHECK_TOKENS
     bf16 tokens on the card against the CPU (top-k sets equal except at
     router near-ties below ROUTER_NEAR_TIE, outputs within MOE_BF16_ULPS
     bf16 ulps and MOE_BF16_REL_L2); (b) mamba2-2.7b at full width, each
     prompt prefilled at its exact length, no flash_attention launch; a
     one-slot engine's greedy tokens equal a direct prefill +
     decode_step's; prefill + decode equals forward within 1e-3 x
     max|logits| on SSM_CHECK_LAYERS full-width layers in float32; (c)
     jamba-1.5-large-398b at its reduced width, flash_attention once per
     super-block per request; the largest prompt's prefill and its
     attention layer's q, k, v, kernel vs plain, as in (a). For each:
     tokens/s, prefill ms per bucket or prompt length, one warm
     decode_step_batched under torch.cuda.set_sync_debug_mode("error") (no
     host sync), its ms against the weight-streaming bound, its launches
     and busy share under the profiler, peak memory and the phase's
     seconds.

At the end it prints, each on a line of its own: one JSON object for the
kernels (all three; flash_attention's launches count phases 7 and 10's
serve runs), the card's name and power limit, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing none of these,
when there is no CUDA device or the repository's `src/` is not beside it.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# the card's peaks and every kernel's bound live in
# src/repro_torch/launch/roofline.py (H100 SXM datasheet figures)
BILINEAR_ATOL, BILINEAR_RTOL = 1e-4, 1e-5
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
# phase 10: MoE, SSM and hybrid serving
MOE_ARCH, SSM_ARCH, HYBRID_ARCH = "deepseek-moe-16b", "mamba2-2.7b", "jamba-1.5-large-398b"
# a full-width MoE layer on the card against the CPU in bf16: each output
# within MOE_BF16_ULPS bf16 ulps of its own magnitude plus as many of the
# output's rms (both sides round the expert matmuls' outputs to bf16, then
# the sum), and the relative L2 within MOE_BF16_REL_L2 (6.03e-4 measured);
# the CPU tests hold the reduced layer to the same ulp rule
# (tests/test_torch_moe.py). A token may take another top-k set only where
# its k-th and (k+1)-th router probabilities lie within ROUTER_NEAR_TIE
MOE_BF16_ULPS, MOE_BF16_REL_L2 = 2, 2e-3
ROUTER_NEAR_TIE = 1e-5
MOE_CHECK_TOKENS = 512
# mamba2-2.7b prefill lengths timed; its float32 prefill + decode vs
# forward check: layers kept, prompt tokens (two chunks of 256), decode steps
SSM_TIMED_LENS = (32, 128, 512)
# deepseek-moe-16b layers kept for its float32 prefill, kernel vs plain
MOE_F32_LAYERS = 2
SSM_CHECK_LAYERS, SSM_CHECK_PROMPT, SSM_CHECK_STEPS = 2, 300, 16
GRAPH_CALLS = 20  # calls captured in one CUDA graph for a device time
PROFILER_TRACES = 3  # traces of a profiler cross-check that may return no records
# launches in one profiled prefill of bucket 512 on an H100, in every trace
# that lost no record: 2,858; copies of q/k/v and of the output around the
# attention kernel would add 144
PREFILL_MAX_LAUNCHES = 2858
PREFILL_LAUNCH_TRACES = 3  # profiled prefills whose most launches the gate reads
TRACER_WARM_KERNELS = 32  # kernels run in the profiler's dropped warm-up step
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
# phase 4f: make_emvs_step's bilinear dsi against process_segment's
STEP_BILINEAR_ATOL = 1e-3


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


def profile_once(fn) -> tuple[float, list]:
    """One call of `fn` under torch.profiler: its wall ms and its device
    kernels as (name, device ms, launches), the longest first. A trace
    that starts with `fn` often loses the records of its first kernels
    (the embedding gather and 3 cache fills of a qwen3-8b prefill on an
    H100), so a step of TRACER_WARM_KERNELS small kernels, whose records
    are dropped, runs first; a trace may still lose records now and then.
    Only the kernel events count: the CPU-side operator rows carry their
    kernels' time again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    traced = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        warm = torch.zeros(1, device="cuda")
        for _ in range(TRACER_WARM_KERNELS):
            warm.add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        prof.step()
    rows = []
    for ev in traced[0]:
        # the step's own span is a device-side row too
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("ProfilerStep"):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((ev.key, dev_us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    return wall, rows


def log_breakdown(card: str, what: str, fn, top: int = 8) -> dict[str, int]:
    """Profile one call of `fn` and print its wall ms, the summed ms and
    number of its device kernels, the busy share and the `top` device
    kernels by time; returns the launches of each kernel."""
    wall, rows = profile_once(fn)
    busy = sum(r[1] for r in rows)
    log(f"[{card}] {what} under torch.profiler: wall {wall:.2f} ms, device kernels "
        f"{busy:.2f} ms in {sum(r[2] for r in rows)} launches (busy share "
        f"{busy / wall:.3f}); top device ops:")
    for name, ms, calls in rows[:top]:
        log(f"  {ms:9.3f} ms  {calls:5d} calls  {name[:90]}")
    return {name: calls for name, _, calls in rows}


def check_launches(card: str, what: str, fn, traces: int, limit: int) -> int:
    """Asserts that the most launches that `traces` profiled calls of `fn`
    record (the first printed by log_breakdown) are at most `limit`, and
    returns them: a trace may lose records but adds none. Prints each
    trace's count, the kernels whose counts differ and, over the limit,
    every kernel of the fullest trace."""
    counts = [log_breakdown(card, what, fn, top=10)]
    counts += [{name: calls for name, _, calls in profile_once(fn)[1]}
               for _ in range(traces - 1)]
    totals = [sum(c.values()) for c in counts]
    differ = {name: [c.get(name, 0) for c in counts]
              for name in sorted(set().union(*counts))
              if len({c.get(name, 0) for c in counts}) > 1}
    log(f"[{card}] {what}: launches per trace {totals}"
        + (f"; kernels whose counts differ: {differ}" if differ else ""))
    n = max(totals)
    if n > limit:
        log(f"[{card}] {what}: launches of each kernel in the fullest trace: "
            f"{counts[totals.index(n)]}")
    assert n <= limit, f"{what} launched {n} kernels, more than {limit}"
    return n


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


def checked_engine_class():
    """The port's Engine, asserting every logit row it samples is finite
    and timing admission (prefill + splice) apart from decode."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine

    class CheckedEngine(Engine):
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

    return CheckedEngine


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
    from repro_torch.serving.engine import EngineConfig, Request

    CheckedEngine = checked_engine_class()
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


def lm_timings(dev, card: str, lm: dict) -> list[dict]:
    """Phase 8: each B3 route beside its plain version and SDPA (device and
    host-inclusive times); prefill per bucket; a warm decode step; profiles
    of one prefill and one decode step."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch.roofline import HBM_BW, flash_bound
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
    check_launches(card, f"prefill bucket {LM_BUCKETS[-1]}",
                   lambda: M.prefill(params, toks, cfg, LM_MAX_LEN),
                   PREFILL_LAUNCH_TRACES, PREFILL_MAX_LAUNCHES)

    state = M.init_decode_state(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (LM_SLOTS, 1), generator=g, device=dev)
    lengths = torch.tensor([37, 120, 480, 300][:LM_SLOTS], device=dev)

    def step():
        return M.decode_step_batched(params, state, tokens, lengths, cfg)

    ms = cuda_ms(step, reps=5, inner=3)
    bound = 1e3 * lm["weight_bytes"] / HBM_BW
    log(f"[{card}] decode step {LM_ARCH} {LM_SLOTS} slots: {ms:.2f} ms warm, bound "
        f"{bound:.2f} ms ({lm['weight_bytes'] / 1e9:.2f} GB of weights at 3.35 TB/s)")
    log_breakdown(card, "decode step", step, top=10)
    return rows


def served_run(dev, card: str, cfg, params, ecfg, prompts, what: str):
    """Serve one request per prompt (LM_NEW_TOKENS each) through a checked
    Engine after a short warm-up, with the launch counts zeroed just before
    the run and read just after. Returns (engine, requests, launches, wall s)."""
    import numpy as np
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.serving.engine import Request

    CheckedEngine = checked_engine_class()
    warm = CheckedEngine(cfg, params, ecfg, eos_id=-1)  # cuBLAS handles, allocator
    for n in LM_BUCKETS:
        warm.submit(Request(rid=-1, prompt=np.ones(n, np.int32), max_new_tokens=2))
    warm.run_until_done()
    del warm
    eng = CheckedEngine(cfg, params, ecfg, eos_id=-1)
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
    for r in reqs:
        assert r.done and len(r.generated) == LM_NEW_TOKENS, (what, r.rid, r.generated)
    n_tokens = sum(len(r.generated) for r in reqs)
    log(f"[{card}] serve {what}: {len(reqs)} requests (prompts "
        f"{sorted(len(p) for p in prompts)}, prefill lengths "
        f"{sorted(eng.bucket_for(len(p)) for p in prompts)}) -> {n_tokens} tokens in "
        f"{eng.step_count} engine steps, {1e3 * wall:.1f} ms, {n_tokens / wall:.1f} "
        f"tokens/s (admission {1e3 * eng.admit_s:.1f} ms for {len(reqs)} prefills, "
        f"decode {1e3 * (wall - eng.admit_s):.1f} ms), launches {launches}, peak "
        f"memory {torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    return eng, reqs, launches, wall


def decode_checks(dev, card: str, what: str, cfg, params, weight_bytes: int) -> None:
    """A warm decode_step_batched of LM_SLOTS slots: one call under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises), its
    host-inclusive ms against the weight-streaming bound, and its launches
    and busy share under the profiler."""
    import torch

    from repro_torch.launch.roofline import HBM_BW
    from repro_torch.models import model as M

    g = torch.Generator(device=dev).manual_seed(3)
    state = M.init_decode_state(cfg, LM_SLOTS, LM_MAX_LEN, device=dev)
    tokens = torch.randint(1, cfg.vocab_size, (LM_SLOTS, 1), generator=g, device=dev)
    lengths = torch.tensor([37, 120, 480, 300][:LM_SLOTS], device=dev)

    def step():
        return M.decode_step_batched(params, state, tokens, lengths, cfg)

    step()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    logits, _ = step()
    torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()), f"{what}: non-finite decode logits"
    log(f"{what}: a warm decode_step_batched made no host sync "
        "(set_sync_debug_mode('error'))")
    ms = cuda_ms(step, reps=5, inner=3)
    bound = 1e3 * weight_bytes / HBM_BW
    log(f"[{card}] decode step {what} {LM_SLOTS} slots: {ms:.2f} ms warm "
        f"(host-inclusive), weight-streaming bound {bound:.3f} ms "
        f"({weight_bytes / 1e9:.3f} GB of weights at 3.35 TB/s)")
    n = sum(log_breakdown(card, f"{what} decode step", step, top=8).values())
    log(f"[{card}] {what}: {n} launches per decode step")


def bf16_ulp(t):
    """The spacing of bfloat16 numbers at |t| (8 significant bits)."""
    import torch

    e = torch.frexp(t.float().abs().clamp_min(torch.finfo(torch.bfloat16).tiny)).exponent
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def moe_layer_check(dev, card: str, cfg, layer: dict) -> None:
    """One full-width MoE layer on MOE_CHECK_TOKENS bf16 tokens, on the card
    and on the CPU with the same weights: the top-k expert sets are equal
    except where a token's k-th and (k+1)-th router probabilities lie
    within ROUTER_NEAR_TIE (float32 sums in another order may then pick the
    other expert); the outputs of the tokens routed alike agree within
    MOE_BF16_ULPS bf16 ulps of their magnitude and of the output's rms."""
    import torch

    from repro_torch.models.moe import moe_apply, router_probs

    def to_cpu(tree):
        return ({k: to_cpu(v) for k, v in tree.items()} if isinstance(tree, dict)
                else tree.cpu())

    x = torch.randn((MOE_CHECK_TOKENS, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(torch.bfloat16)
    cpu_layer = to_cpu(layer)
    t0 = time.perf_counter()
    y_cpu, m_cpu = moe_apply(cpu_layer, x, cfg)
    cpu_s = time.perf_counter() - t0
    y_dev, m_dev = moe_apply(layer, x.to(dev), cfg)
    _, i_cpu, _ = router_probs(cpu_layer, x, cfg.moe)
    _, i_dev, _ = router_probs(layer, x.to(dev), cfg.moe)
    k = cfg.moe.top_k
    probs = torch.softmax(x.float() @ cpu_layer["router"]["w"].float(), dim=-1)
    top = torch.topk(probs, k + 1, dim=-1).values
    gap = top[:, k - 1] - top[:, k]
    differ = (torch.sort(i_cpu, -1).values != torch.sort(i_dev.cpu(), -1).values).any(-1)
    n_differ = int(differ.sum())
    log(f"MoE layer 0 ({MOE_CHECK_TOKENS} tokens, bf16): {n_differ} tokens with another "
        f"top-{k} set on the card than on the CPU"
        + (f", smallest top-k gap among them {float(gap[differ].min()):.3g}"
           if n_differ else "")
        + f"; smallest top-k gap over all tokens {float(gap.min()):.3g}; accepted only "
        f"below {ROUTER_NEAR_TIE:g}")
    assert bool((gap[differ] < ROUTER_NEAR_TIE).all()), "a routing difference off a near-tie"
    same = ~differ
    got, want = y_dev.cpu().float()[same], y_cpu.float()[same]
    diff = (got - want).abs()
    rms = torch.linalg.vector_norm(want) / want.numel() ** 0.5
    limit = MOE_BF16_ULPS * (bf16_ulp(want) + bf16_ulp(rms))
    worst = int((diff / limit).argmax())
    rel = float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))
    log(f"[{card}] MoE layer 0 card vs CPU: max abs {float(diff.max()):.3g}; worst "
        f"element off by {float(diff.flatten()[worst]):.3g} at |y| "
        f"{float(want.flatten()[worst].abs()):.3g}, {float((diff / limit).max()):.3g} of "
        f"its limit ({MOE_BF16_ULPS} bf16 ulps of |y| plus {MOE_BF16_ULPS} of the rms "
        f"{float(rms):.3g}); relative L2 {rel:.3g} (limit {MOE_BF16_REL_L2:g}); dropped "
        f"fraction {float(m_dev['moe_drop_frac']):.4f} card, "
        f"{float(m_cpu['moe_drop_frac']):.4f} CPU; the CPU took {cpu_s:.2f} s")
    assert bool((diff <= limit).all()) and rel <= MOE_BF16_REL_L2, (float(diff.max()), rel)
    if not n_differ:
        assert float(m_dev["moe_drop_frac"]) == float(m_cpu["moe_drop_frac"])


def prefill_attention_check(dev, what: str, cfg, params, p, n: int) -> float:
    """Prompt p's prefill at length n (the engine's for it) with the kernel
    and with the plain attention: the logits within PREFILL_REL_L2 of each
    other. q, k and v of every attention layer in the plain run are
    captured and each goes through the kernel and the plain version: one
    launch on the route `kernel.route` names, max abs error within
    FLASH_TOL. Returns that error."""
    from unittest import mock

    import torch

    import repro_torch.models.attention as attention
    from repro_torch.kernels import cuda
    from repro_torch.kernels.flash_attention.kernel import route
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import model as M

    toks = torch.zeros((1, n), dtype=torch.long, device=dev)
    toks[0, :len(p)] = torch.as_tensor(p, device=dev)
    calls = []

    def plain(q, k, v, *, causal, block_q, block_k):
        calls.append((q, k, v, dict(causal=causal, block_q=block_q, block_k=block_k)))
        return attention_ref(q, k, v, causal=causal)

    lk, _ = M.prefill(params, toks, cfg, LM_MAX_LEN, logit_index=len(p) - 1)
    with mock.patch.object(attention, "flash_attention", plain):
        lp, _ = M.prefill(params, toks, cfg, LM_MAX_LEN, logit_index=len(p) - 1)
    dtype = str(params["embed"]["table"].dtype)
    assert bool(torch.isfinite(lk).all()) and lk.shape == (1, 1, cfg.vocab_size)
    rel = float(torch.linalg.vector_norm(lk.float() - lp.float())
                / torch.linalg.vector_norm(lp.float()))
    log(f"{what} prefill logits, {dtype[6:]} ({len(p)} tokens, length {n}): kernel vs "
        f"plain attention relative L2 {rel:.3g}, max abs "
        f"{float((lk - lp).abs().max()):.3g}, limit {PREFILL_REL_L2[dtype]:g}")
    assert rel <= PREFILL_REL_L2[dtype], f"{what}: prefill logits relative L2 {rel}"
    assert len(calls) == cfg.n_superblocks() * cfg.pattern().count("attn"), len(calls)

    worst = 0.0
    for q, k, v, kw in calls:
        r = route(q.dtype, q.shape[-1])
        before = dict(cuda.launch_counts)
        got = flash_attention(q, k, v, **kw)
        want = attention_ref(q, k, v, causal=kw["causal"])
        torch.cuda.synchronize()
        for key in ("flash_attention", f"flash_attention_{r}"):
            assert cuda.launch_counts[key] == before.get(key, 0) + 1, (what, key)
        assert got.dtype == q.dtype and bool(torch.isfinite(got).all()), what
        worst = max(worst, float((got.float() - want.float()).abs().max()))
    tol = FLASH_TOL[str(q.dtype)]
    log(f"{what}: q, k, v of the {len(calls)} attention layers of that prefill, "
        f"{tuple(q.shape)} over {tuple(k.shape)} {str(q.dtype)[6:]} causal: kernel "
        f"(route {r}, one launch each) vs plain max abs {worst:.3g}, tol {tol:g}")
    assert worst <= tol, f"{what}: flash_attention max abs err {worst} > {tol}"
    return worst


def family_serve(dev, card: str, label: str, cfg, checks) -> dict:
    """One phase-10 family: random bf16 weights drawn on the card, the 8
    requests served (prefill at the bucket, or at the prompt's exact
    length where the arch has an SSM), flash_attention launched once per
    attention layer per request and all on the tensor-core route; then
    `checks(cfg, params, prompts, bucket_for)`, which returns a dict for
    the phase's result, and the warm decode step's checks."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig

    t_phase = time.perf_counter()
    params = M.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0),
                           dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(t.numel() * t.element_size() for t in tensors(params))
    log(f"[{card}] {cfg.name}: {M.param_count(params) / 1e9:.3f} B parameters, "
        f"{weight_bytes / 1e9:.2f} GB, drawn on the card in "
        f"{time.perf_counter() - t_phase:.2f} s")
    ecfg = EngineConfig(slots=LM_SLOTS, max_len=LM_MAX_LEN, prefill_buckets=LM_BUCKETS)
    prompts = lm_prompts(cfg.vocab_size)
    eng, reqs, launches, wall = served_run(dev, card, cfg, params, ecfg, prompts, cfg.name)
    lengths = {eng.bucket_for(len(p)) for p in prompts}
    assert lengths == ({len(p) for p in prompts} if cfg.ssm is not None
                       else set(LM_BUCKETS)), lengths
    want = cfg.n_superblocks() * cfg.pattern().count("attn") * len(reqs)
    assert launches.get("flash_attention", 0) == want, (launches, want)
    assert launches.get("flash_attention_tc", 0) == want, (launches, want)
    log(f"{cfg.name}: flash_attention launched {want} times "
        f"({want // len(reqs)} per request), all on the tensor-core route" if want
        else f"{cfg.name}: no flash_attention launch (attention-free)")
    out = checks(cfg, params, prompts, eng.bucket_for) or {}
    decode_checks(dev, card, cfg.name, cfg, params, weight_bytes)
    log(f"[{card}] phase {label} ({cfg.name}): peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB, "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches,
            "tokens_per_s": sum(len(r.generated) for r in reqs) / wall, **out}


def timed_prefills(dev, card: str, cfg, params, lengths, unit: str) -> None:
    import torch

    from repro_torch.models import model as M

    g = torch.Generator(device=dev).manual_seed(1)
    for s in lengths:
        t = torch.randint(1, cfg.vocab_size, (1, s), generator=g, device=dev)
        ms = cuda_ms(lambda: M.prefill(params, t, cfg, LM_MAX_LEN), reps=3, inner=2)
        log(f"[{card}] prefill {cfg.name} {unit} {s}: {ms:.2f} ms")


def moe_checks(dev, card: str):
    """Phase 10a's checks: the largest prompt's prefill and its attention
    layers, kernel vs plain, in bf16 and on MOE_F32_LAYERS layers in
    float32; layer 0's MoE on the card against the CPU; prefill per bucket."""
    import torch

    from repro_torch.models import model as M

    def checks(cfg, params, prompts, bucket_for):
        p = max(prompts, key=len)
        err = prefill_attention_check(dev, cfg.name, cfg, params, p, bucket_for(len(p)))
        cfg2 = dataclasses.replace(cfg, n_layers=MOE_F32_LAYERS)
        p32 = M.init_params(cfg2, generator=torch.Generator(device=dev).manual_seed(4),
                            dtype=torch.float32, device=dev)
        prefill_attention_check(dev, f"{cfg.name} float32, {MOE_F32_LAYERS} layers",
                                cfg2, p32, p, bucket_for(len(p)))
        del p32
        torch.cuda.empty_cache()
        moe_layer_check(dev, card, cfg, params["blocks"][0]["ffn"]["moe"])
        timed_prefills(dev, card, cfg, params, LM_BUCKETS, "bucket")
        return {"flash_max_abs_err": err}

    return checks


def ssm_checks(dev, card: str):
    """Phase 10b's checks: no flash_attention launch; a one-slot engine's
    greedy tokens equal a direct prefill + decode_step's; prefill + decode
    against forward on SSM_CHECK_LAYERS float32 layers; prefill per length."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serving.engine import EngineConfig, Request

    def checks(cfg, params, prompts, bucket_for):
        # one slot: the engine's decode runs the shapes of a direct
        # decode_step, so its greedy tokens must equal a direct prefill +
        # decode_step's (with 4 slots cuBLAS may sum the bf16 products in
        # another order)
        CheckedEngine = checked_engine_class()
        for p in (min(prompts, key=len), max(prompts, key=len)):
            one = CheckedEngine(cfg, params, EngineConfig(
                slots=1, max_len=LM_MAX_LEN, prefill_buckets=LM_BUCKETS), eos_id=-1)
            req = Request(rid=0, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            one.submit(req)
            one.run_until_done()
            toks = torch.as_tensor(p, device=dev)[None].long()
            logits, st = M.prefill(params, toks, cfg, LM_MAX_LEN)
            direct = [int(logits[0, -1].argmax())]
            for cur in range(len(p), len(p) + LM_NEW_TOKENS - 1):
                logits, st = M.decode_step(params, st,
                                           torch.tensor([[direct[-1]]], device=dev), cur, cfg)
                direct.append(int(logits[0, -1].argmax()))
            assert req.generated == direct, (len(p), req.generated, direct)
            log(f"{cfg.name}: a {len(p)}-token prompt served alone: the engine's "
                f"{LM_NEW_TOKENS} greedy tokens equal a direct prefill + decode_step's")

        # prefill then decode against one forward, float32, 2 full-width layers
        cfg2 = dataclasses.replace(cfg, n_layers=SSM_CHECK_LAYERS)
        p32 = M.init_params(cfg2, generator=torch.Generator(device=dev).manual_seed(4),
                            dtype=torch.float32, device=dev)
        n = SSM_CHECK_PROMPT + SSM_CHECK_STEPS
        toks = torch.randint(1, cfg.vocab_size, (1, n),
                             generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        full, _ = M.forward(p32, toks, cfg2)
        lp, st = M.prefill(p32, toks[:, :SSM_CHECK_PROMPT], cfg2, LM_MAX_LEN)
        errs = [float((lp[:, 0] - full[:, SSM_CHECK_PROMPT - 1]).abs().max())]
        for i in range(SSM_CHECK_PROMPT, n):
            ld, st = M.decode_step(p32, st, toks[:, i:i + 1], i, cfg2)
            errs.append(float((ld[:, 0] - full[:, i]).abs().max()))
        scale = float(full.abs().max())
        log(f"{cfg.name} float32, {SSM_CHECK_LAYERS} full-width layers: prefill of "
            f"{SSM_CHECK_PROMPT} tokens + {SSM_CHECK_STEPS} decode steps vs forward of "
            f"{n}: max abs {max(errs):.3g}, limit 1e-3 x max|logits| = "
            f"{1e-3 * max(scale, 1.0):.3g}")
        assert max(errs) < 1e-3 * max(scale, 1.0), (errs, scale)
        del p32, full, lp, st
        timed_prefills(dev, card, cfg, params, SSM_TIMED_LENS, "tokens")
        return {}

    return checks


def hybrid_checks(dev):
    """Phase 10c's checks: the largest prompt's exact-length prefill and
    its attention layer, kernel vs plain, in bf16."""

    def checks(cfg, params, prompts, bucket_for):
        p = max(prompts, key=len)
        return {"flash_max_abs_err": prefill_attention_check(
            dev, cfg.name, cfg, params, p, bucket_for(len(p)))}

    return checks


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
    from repro_torch.launch.roofline import sweep_bound

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


def sharded_phase(card: str, cam, dsi_cfg, opts, events, frames, traj) -> dict:
    """Phase 4f: the segment-sharded backend on the card at the main path's
    width over a world-size-1 NCCL group, the split step, and the streaming
    benchmark with its cost table (see the module docstring)."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.benchmarks import streaming_latency
    from repro_torch.core import dsi as dsi_lib
    from repro_torch.core.geometry import SE3
    from repro_torch.core.pipeline import (
        bucket_capacity,
        plan_segments,
        precompute_segment_geometry,
        process_segment,
        run_emvs,
    )
    from repro_torch.distributed.emvs import (
        all_gather_rows,
        local_process_group,
        make_emvs_step,
        make_segment_mesh,
    )
    from repro_torch.events.aggregation import EventFrames, aggregate
    from repro_torch.events.simulator import EventStream, Trajectory
    from repro_torch.kernels import cuda
    from repro_torch.profiling import calibrate
    from repro_torch.serving.emvs_stream import EMVSStreamEngine, StreamConfig

    t_phase = time.perf_counter()
    segs = plan_segments(frames, dsi_cfg, opts)
    n_buckets = len({bucket_capacity(b - a) for a, b in segs})
    host_events = EventStream(*(a.cpu() for a in events))
    host_traj = Trajectory(traj.times.cpu(), SE3(traj.poses.R.cpu(), traj.poses.t.cpu()))
    with local_process_group("cuda"):
        mesh = make_segment_mesh()
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1,), mesh
        batched = run_emvs(cam, dsi_cfg, frames, opts)
        run_emvs(cam, dsi_cfg, frames, opts, sweep="sharded", mesh=mesh)  # NCCL's first use
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        sharded = run_emvs(cam, dsi_cfg, frames, opts, sweep="sharded", mesh=mesh)
        torch.cuda.synchronize()
        launches = dict(cuda.launch_counts)
        for name in ("backproject_vote", "depth_argmax"):
            assert launches.get(name, 0) == n_buckets, (name, launches, n_buckets)
        assert_same_results(sharded, batched, "run_emvs sharded vs batched")
        stored = dsi_lib.to_storage(torch.stack([s.dsi for s in batched.segments]))
        gathered = all_gather_rows(stored, mesh.get_group("segments"))
        assert_equal(gathered, stored, "int16 DSI store through the byte-view gather")
        log(f"sharded run_emvs (1 NCCL rank): {len(sharded.segments)} segments in {n_buckets} "
            f"bucket sweeps bitwise the batched backend (dsi, depth, mask); launches "
            f"{launches}; the int16 store {tuple(stored.shape)} gathered exact")
        walls = {"batched": [], "sharded": []}
        for order in (("batched", "sharded"), ("sharded", "batched")) * 2:
            for which in order:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run_emvs(cam, dsi_cfg, frames, opts, **(
                    {"sweep": "sharded", "mesh": mesh} if which == "sharded" else {}))
                torch.cuda.synchronize()
                walls[which].append(1e3 * (time.perf_counter() - t0))
        log(f"[{card}] run_emvs warm walls in turns (b, s, s, b, b, s, s, b): batched "
            f"{[round(x, 2) for x in walls['batched']]} ms, median "
            f"{statistics.median(walls['batched']):.2f}; sharded "
            f"{[round(x, 2) for x in walls['sharded']]} ms, median "
            f"{statistics.median(walls['sharded']):.2f}")
        log_breakdown(card, "run_emvs sharded (1 NCCL rank)",
                      lambda: run_emvs(cam, dsi_cfg, frames, opts, sweep="sharded", mesh=mesh))

        # the sharded stream against run_emvs over host-aggregated frames
        base = run_emvs(cam, dsi_cfg, aggregate(cam, host_events, host_traj,
                                                events_per_frame=1024, device="cpu"), opts)

        def engine(policy="adaptive"):
            return EMVSStreamEngine(cam, dsi_cfg, None, opts, StreamConfig(
                sweep="sharded", dispatch_policy=policy, max_inflight=2), mesh=mesh)

        chunk = STREAM_CHUNKS[0]
        counts = {}
        for policy in ("latency", "throughput", "adaptive"):
            e = engine(policy)
            torch.cuda.synchronize()
            cuda.launch_counts.clear()
            result, _, _ = stream_feed(e, host_events, host_traj, chunk, gated=True)
            stream_launches = dict(cuda.launch_counts)
            assert_same_results(result, base, f"sharded stream {policy}")
            for name in ("backproject_vote", "depth_argmax"):
                assert stream_launches.get(name, 0) == e.stats["dispatches"], (
                    policy, name, stream_launches)
            counts[policy] = e.stats["dispatches"]
        firsts, stream_walls = [], []
        for _ in range(3):
            _, first_ms, wall_ms = stream_feed(engine(), host_events, host_traj, chunk,
                                               gated=True)
            firsts.append(first_ms)
            stream_walls.append(wall_ms)
        log(f"[{card}] sharded stream (pose-gated, {chunk}-event chunks): bitwise run_emvs "
            f"under every policy, dispatches {counts}; adaptive first depth map "
            f"{[round(x, 2) for x in firsts]} ms, wall {[round(x, 2) for x in stream_walls]} "
            f"ms (medians {statistics.median(firsts):.2f}, "
            f"{statistics.median(stream_walls):.2f})")
        e = engine()
        dispatch = e._dispatcher._dispatch
        n_strict = []

        def strict(group, cap):
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch(group, cap)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            n_strict.append(len(group))

        e._dispatcher._dispatch = strict
        result, _, _ = stream_feed(e, host_events, host_traj, chunk, gated=True)
        assert_same_results(result, base, "sharded stream under sync_debug_mode('error')")
        assert sum(n_strict) == len(result.segments)
        log(f"sharded stream: {len(n_strict)} dispatches under set_sync_debug_mode('error'), "
            f"no host sync")

        # the split step on a (1, 1) mesh against process_segment's matmul
        step_mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        a, b = segs[0]
        seg = EventFrames(frames.xy[a:b], frames.valid[a:b], frames.t_mid[a:b],
                          SE3(frames.poses.R[a:b], frames.poses.t[a:b]))
        T_w_ref = SE3(frames.poses.R[a], frames.poses.t[a])
        planes = dsi_cfg.planes(device=frames.xy.device)
        geom = precompute_segment_geometry(cam, seg, T_w_ref, planes,
                                           planes[dsi_cfg.num_planes // 2])
        phi = torch.stack([geom.phi.alpha, geom.phi.beta_x, geom.phi.beta_y], -1)
        ones = torch.ones(b - a, device=frames.xy.device)
        step_errs = {}
        for voting in ("nearest", "bilinear"):
            dsi_ref, dm_ref = process_segment(cam, dsi_cfg, seg, T_w_ref, dataclasses.replace(
                opts, formulation="matmul", voting=voting, quantized=False,
                median_filter=False))
            dsi, depth, mask, conf = make_emvs_step(cam, dsi_cfg, step_mesh, mode=voting)(
                seg.xy, seg.valid.float(), ones, geom.H, phi)
            torch.cuda.synchronize()
            err = float((dsi.float() - dsi_ref.float()).abs().max())
            flips = int((mask != dm_ref.mask).sum())
            step_errs[voting] = (err, flips)
            if voting == "nearest":
                assert dsi.dtype == torch.int32 and err == 0.0 and flips == 0, (err, flips)
            else:
                assert err < STEP_BILINEAR_ATOL, err
        log(f"make_emvs_step on a (1, 1) mesh, segment {segs[0]} ({b - a} frames): "
            f"(max |dsi - process_segment's|, mask pixels that differ) {step_errs}")

    # the streaming benchmark at the main path's size and the reference's
    # one 1024-event frame per chunk: its headline gate (first depth map
    # below the offline wall), the cost table, the burst replay gate, the
    # calibration report
    rec = streaming_latency.main([
        "--main-path", "--chunk-frames", "1", "--cost-table", STREAM_COST_TABLE])
    gates = rec["cost_model"]["slo_burst_gates"]
    assert gates and not any("failure" in g for g in gates), gates
    head = rec["streaming_latency"]
    assert head["chunk_events"] == 1024, head["chunk_events"]
    log(f"[{card}] streaming_latency --main-path --chunk-frames 1: first depth map "
        f"{1e3 * head['first_depth_latency_s']:.2f} ms, stream "
        f"{1e3 * head['streaming_end_to_end_s']:.2f} ms against offline "
        f"{1e3 * head['offline_end_to_end_s']:.2f} ms; host ingest per push "
        f"{head['ingest_ms_per_push']:.3f} ms; cost table rows "
        + json.dumps(rec["cost_model"]["entries"]))
    log("check_slo_burst on that table: " + "; ".join(
        f"[{g['backend']}] throughput {g['throughput']['dispatch_count']} dispatches, "
        f"SLO-adaptive {g['slo_adaptive']['dispatch_count']}, predicted p99 "
        f"{1e3 * g['slo_adaptive']['predicted_p99_s']:.3f} ms within the deadline "
        f"{1e3 * g['target_latency_s']:.3f} ms: pass" for g in gates))
    assert calibrate.main([STREAM_COST_TABLE]) == 0
    log(f"sharded phase: {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches}


def tooling_phase(card: str, cam, dsi_cfg, opts, frames) -> dict:
    """Phase 9: the port's tooling on the card (see the module docstring):
    the fusion ladder at the main bucket with two rungs measured, the dry
    run of four cells on fake CUDA tensors, the quick lint grid on fake
    CUDA tensors, B1's saturating store at the lint's proof capacity, and
    the launches of a warm run_emvs."""
    import torch

    from repro_torch.analysis import lint
    from repro_torch.benchmarks.roofline_report import (
        MAIN_BUCKET,
        MAIN_BUCKET_SEGMENTS,
        fusion_report,
    )
    from repro_torch.benchmarks.summarize_dryrun import fmt_row
    from repro_torch.core import dsi as dsi_lib
    from repro_torch.core.pipeline import bucket_capacity, plan_segments, run_emvs
    from repro_torch.core.voting import vote_scatter
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
    from repro_torch.launch import dryrun
    from repro_torch.launch import roofline as rf
    from repro_torch.quant.policies import TABLE1

    t_phase = time.perf_counter()
    out: dict = {}

    # 9a. the fusion ladder at the main bucket: every rung's bound; the
    # unfused rung (the scatter formulation's float32 votes, the int16
    # storage round trip, B2) and the fused-store rung (B1 then B2) measured
    xy0, valid, phi = main_bucket(cam, dsi_cfg, frames, opts)
    s, c, e = valid.shape
    nz, h, w = dsi_cfg.shape
    shape = dict(nz=nz, h=h, w=w, events=e, frames=c)
    assert (shape, s) == (MAIN_BUCKET, MAIN_BUCKET_SEGMENTS), (shape, s)
    rep = fusion_report(shape, s)
    assert not rep["violations"], rep["violations"]
    x0, y0 = xy0[..., 0].contiguous(), xy0[..., 1].contiguous()
    weights = valid.to(torch.float32)

    def fused_store():
        return depth_argmax_cuda(backproject_vote_cuda(
            x0, y0, valid, phi, cx=cam.cx, cy=cam.cy, w=w, h=h, quantized=True))

    def unfused():
        dsi = torch.zeros((s, nz, h, w), dtype=torch.float32, device=x0.device)
        for k in range(c):
            a, bx, by = phi[:, k, :, 0:1], phi[:, k, :, 1:2], phi[:, k, :, 2:3]
            x_i = torch.addcmul(bx, a, x0[:, k, None, :] - cam.cx) + cam.cx
            y_i = torch.addcmul(by, a, y0[:, k, None, :] - cam.cy) + cam.cy
            x_i, y_i = TABLE1.quantize_plane_coords(x_i, y_i)
            dsi = vote_scatter(dsi, x_i, y_i, w=w, h=h,
                               weights=weights[:, k, None, :].expand(x_i.shape))
        return depth_argmax_cuda(dsi_lib.to_storage(dsi))

    for got, want, name in zip(unfused(), fused_store(), ("conf", "zf")):
        assert_equal(got, want, f"fusion ladder: unfused {name} vs fused-store")
    measured = {"unfused": graph_ms(unfused, calls=2), "fused-store": graph_ms(fused_store)}
    ladder = []
    for st in rep["stages"]:
        name = st["name"]
        row = {"rung": name, "hbm_bytes": rep["hbm_bytes"][name],
               "bound_ms": 1e3 * rep["bound_s"][name], "bound_gap": st["bound_gap"],
               "device_ms": measured.get(name)}
        ladder.append(row)
        log(f"[{card}] fusion ladder at S={s} C={c} E={e} Nz={nz} {w}x{h}: {name:<12} "
            f"{row['hbm_bytes'] / 1e6:8.2f} MB, bound {row['bound_ms']:.4f} ms "
            f"(gap to the compute roof {row['bound_gap']:.2f})"
            + (f", device {row['device_ms']:.4f} ms (CUDA graph), bound share "
               f"{row['bound_ms'] / row['device_ms']:.3f}" if row["device_ms"] else
               ", not measured (detection is not folded into B1)"))
    out["ladder"] = ladder

    # 9b. the dry run of four cells on fake CUDA tensors: nothing allocated,
    # B1's bytes in emvs_seg those of launch/roofline.py::sweep_bound
    gc.collect()  # earlier phases' garbage must not be freed during the count
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    recs = {}
    for arch, cell in (("eventor-davis240", "emvs_rt"), ("eventor-davis240", "emvs_seg"),
                       ("qwen3-8b", "prefill_32k"), ("qwen3-8b", "decode_32k")):
        rec = dryrun.run_cell(arch, cell, "single")
        assert "skipped" not in rec and rec["device"] == "cuda", rec
        recs[cell] = rec
        log(f"dry run {fmt_row(rec)} kernels "
            f"{sorted({k['op'] for k in rec['kernels']})}")
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    assert after == before, f"the dry run allocated {after - before} B on the card"
    seg = recs["emvs_seg"]
    b1 = [k for k in seg["kernels"] if k["op"].startswith("repro_torch.backproject_vote")]
    want = rf.sweep_bytes(1, 256, 1024, 256, 240, 180)
    assert len(b1) == 1 and b1[0]["bytes"] == want, (b1, want)
    log(f"dry run: memory_allocated {before} B before and after; emvs_seg's B1 call "
        f"{b1[0]['bytes']} B == sweep_bound's bytes; emvs votes {seg['emvs_votes']}")
    out["dry_run"] = {cell: {"flops": r["roofline"]["flops"],
                             "bytes_hbm": r["roofline"]["bytes_hbm"],
                             "dominant": r["roofline"]["dominant"],
                             "peak_temp_bytes": r["memory"]["peak_temp_bytes"],
                             "trace_s": r["trace_s"]} for cell, r in recs.items()}

    # 9c. the linter's quick grid on fake CUDA tensors: no new finding
    lint_json = os.path.join(ROOT, "results", "lint_quick_cuda.json")
    os.makedirs(os.path.dirname(lint_json), exist_ok=True)
    t0 = time.perf_counter()
    rc = lint.main(["--grid", "quick", "--json", lint_json])
    with open(lint_json) as f:
        found = json.load(f)
    assert rc == 0 and not found["new"], found["new"]
    log(f"lint --grid quick on fake CUDA tensors: {len(found['report']['entries'])} programs, "
        f"no new finding, {len(found['suppressed'])} suppressed by the port's baseline, "
        f"{time.perf_counter() - t0:.1f} s")

    # 9d. the lint's proof case on the real kernel: a full capacity of frames
    # with every event on one voxel of every plane overflows int16, so the
    # int32 accumulator must saturate the store
    cap, ev = lint.PROOF_CAPACITY_FRAMES, 1024
    px, py = 100.0, 50.0
    dev = x0.device
    px0 = torch.full((1, cap, ev), px, device=dev)
    py0 = torch.full((1, cap, ev), py, device=dev)
    pvalid = torch.ones((1, cap, ev), dtype=torch.bool, device=dev)
    pphi = torch.zeros((1, cap, nz, 3), device=dev)
    pphi[..., 0] = 1.0
    pxy = torch.stack([px0, py0], -1)
    plain = backproject_vote_ref(pxy, pvalid, pphi, cx=cam.cx, cy=cam.cy, w=w, h=h,
                                 quantize_plane_coords=True)
    for quantized in (False, True):
        got = backproject_vote_cuda(px0, py0, pvalid, pphi, cx=cam.cx, cy=cam.cy, w=w,
                                    h=h, quantized=quantized)
        want = dsi_lib.to_storage(plain) if quantized else plain
        assert_equal(got, want, f"B1 saturation case, quantized={quantized}")
        peak = float(got[0, :, int(py), int(px)].float().min())
        assert peak == (32767.0 if quantized else float(cap * ev)), peak
    log(f"B1 at {cap} frames x {ev} events on one voxel of each of {nz} planes: "
        f"{cap * ev} votes; the float store holds {cap * ev}, the int16 store "
        "saturates at 32767; both bitwise the plain version")

    # 9e. a warm run_emvs launches B1 and B2 once per bucket (the custom
    # operations add no launch)
    n_buckets = len({bucket_capacity(b - a) for a, b in plan_segments(frames, dsi_cfg, opts)})
    run_emvs(cam, dsi_cfg, frames, opts)
    torch.cuda.synchronize()
    cuda.launch_counts.clear()
    run_emvs(cam, dsi_cfg, frames, opts)
    torch.cuda.synchronize()
    warm = dict(cuda.launch_counts)
    assert warm == {"backproject_vote": n_buckets, "depth_argmax": n_buckets}, warm
    log(f"warm run_emvs launches {warm} ({n_buckets} buckets)")
    out["warm_launches"] = warm
    log(f"tooling phase: {time.perf_counter() - t_phase:.1f} s")
    return out


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

    from repro_torch.configs import get_config
    from repro_torch.core.dsi import to_storage
    from repro_torch.core.pipeline import run_emvs
    from repro_torch.events.simulator import absrel, ground_truth_depth
    from repro_torch.kernels import cuda
    from repro_torch.kernels.backproject_vote import kernel as b1_kernel
    from repro_torch.kernels.backproject_vote.ref import backproject_vote_ref
    from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
    from repro_torch.kernels.local_max.ref import depth_argmax_ref
    from repro_torch.launch.roofline import depth_argmax_bound, sweep_bound

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
        b2_bound, b2_by = depth_argmax_bound(sb, nz, h, w)
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
    sharded = sharded_phase(card, cam, dsi_cfg, opts, events, frames, traj)
    tooling = tooling_phase(card, cam, dsi_cfg, opts, frames)

    # 6. the flash-attention kernel vs its plain version
    log("flash attention kernel vs plain:")
    b3_err = flash_cases(dev)

    # 7. the LM serving path at full width; 8. its timings
    lm = serve_phase(dev, card)
    b3_rows = lm_timings(dev, card, lm)
    b3 = next(r for r in b3_rows if r["route"] == "tc" and r["S"] == LM_BUCKETS[-1])

    # 10. MoE, SSM and hybrid serving; the card cannot hold qwen3-8b beside
    # deepseek-moe-16b
    del lm["params"]
    gc.collect()
    torch.cuda.empty_cache()
    served = {}
    for label, cfg, checks in (
            ("10a", get_config(MOE_ARCH), moe_checks(dev, card)),
            ("10b", get_config(SSM_ARCH), ssm_checks(dev, card)),
            ("10c", get_config(HYBRID_ARCH).reduced(), hybrid_checks(dev))):
        served[cfg.name] = family_serve(dev, card, label, cfg, checks)
        gc.collect()
        torch.cuda.empty_cache()
    b3_serve = {LM_ARCH: lm["launches"]}
    b3_serve.update({arch: run["launches"] for arch, run in served.items()})
    log(f"whole script {time.perf_counter() - t_start:.1f} s")

    kernels = [
        {"name": "backproject_vote", "route": "cuda",
         "source": "src/repro_torch/csrc/backproject_vote.cu",
         "replaces": "src/repro/kernels/backproject_vote/kernel.py:241",
         "launches": launches["backproject_vote"], "max_abs_err": err1,
         "launches_streaming": stream["launches"]["backproject_vote"],
         "launches_sharded": sharded["launches"]["backproject_vote"],
         "max_abs_err_streaming": stream["max_abs_err"],
         "ms": main_row["b1_eager_ms"], "plain_ms": main_row["b1_plain_ms"],
         "bound_ms": main_row["b1_bound_ms"], "bound_by": main_row["b1_bound_by"],
         "library_ms": None, "device_ms": main_row["b1_device_ms"],
         "device_ms_s1": timed["S=1"]["b1_device_ms"], "smem_bytes": smem,
         "n_bands": n_bands, "device_ms_davis346": d346["device_ms"],
         "bound_ms_davis346": d346["bound_ms"], "n_bands_davis346": d346["n_bands"],
         "bulk_copy_instructions": n_bulk,
         "launches_warm": tooling["warm_launches"]["backproject_vote"],
         "fusion_ladder": tooling["ladder"],
         "shape": f"{shape_note} int16; ms host-inclusive eager, device_ms a CUDA graph",
         "shape_davis346": f"{d346['shape']} int16, device time"},
        {"name": "depth_argmax", "route": "cuda",
         "source": "src/repro_torch/csrc/local_max.cu",
         "replaces": "src/repro/kernels/local_max/kernel.py:74",
         "launches": launches["depth_argmax"], "max_abs_err": err2,
         "launches_streaming": stream["launches"]["depth_argmax"],
         "launches_sharded": sharded["launches"]["depth_argmax"],
         "launches_warm": tooling["warm_launches"]["depth_argmax"],
         "ms": main_row["b2_eager_ms"], "plain_ms": main_row["b2_plain_ms"],
         "bound_ms": main_row["b2_bound_ms"], "bound_by": main_row["b2_bound_by"],
         "library_ms": None, "device_ms": main_row["b2_device_ms"],
         "device_ms_s1": timed["S=1"]["b2_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/kernel.py:101",
         "launches": sum(c.get("flash_attention", 0) for c in b3_serve.values()),
         "launches_per_serve_run": {arch: c.get("flash_attention", 0)
                                    for arch, c in b3_serve.items()},
         "max_abs_err": b3_err,
         "max_abs_err_serving": {arch: run["flash_max_abs_err"]
                                 for arch, run in served.items()
                                 if "flash_max_abs_err" in run},
         "ms": b3["ms"], "plain_ms": b3["plain_ms"], "bound_ms": b3["bound_ms"],
         "bound_by": b3["bound_by"], "library_ms": b3["library_ms"],
         "shape": "bf16 causal (1, 32, S, 128) over (1, 8, S, 128), S = 512, "
                  "tensor-core route, device time",
         "launches_by_route": {r: sum(c.get(f"flash_attention_{r}", 0)
                                      for c in b3_serve.values())
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
