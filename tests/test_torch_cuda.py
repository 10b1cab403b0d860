"""The port's CUDA kernels on a card, against their plain versions.

Every test here carries the `gpu` marker and skips without a CUDA device.
This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Nearest voting is bitwise on dsi, conf and zf; bilinear dsi within
BILINEAR_ATOL/RTOL (float atomics reorder the sum of fractional weights);
the depth max/argmax kernel is bitwise on any stored DSI. Flash attention
is held to its plain version within the reference's own tolerances
(`tests/test_kernels.py`): 2e-5 in float32, 2e-2 in bfloat16 (the sums
run in another order, the tensor-core route rounds the probabilities to
bf16 before their product with V; bf16 outputs round at 2^-8 relative).
Each flash-attention case also asserts the route it took (bf16 with D a
multiple of 16: tensor cores; otherwise CUDA cores) by its launch counter.
The streaming engine on the card equals `run_emvs` on host-aggregated
frames bitwise, launches B1 and B2 once per dispatch, stages each batch
from pinned memory and makes no host sync in `_dispatch`. The sharded
backend runs over a world-size-1 NCCL group (a `FileStore` in a temporary
directory): bitwise the batched backend, B1 and B2 once per bucket sweep,
int16 and bool gathered exactly, and the stream engine refuses a CUDA mesh
of more than one rank.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import pipeline as tp
from repro_torch.core.camera import CAMERAS, CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, run_emvs
from repro_torch.events.aggregation import aggregate
from repro_torch.events.simulator import (
    SceneConfig,
    make_scene,
    make_trajectory,
    simulate_events,
)
from repro_torch.kernels import cuda
from repro_torch.kernels.backproject_vote import ops
from repro_torch.kernels.backproject_vote.kernel import (
    backproject_vote_cuda,
    band_plan,
    kernel_smem_bytes,
    smem_bytes,
)
from repro_torch.kernels.flash_attention.kernel import route
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.local_max.ops import depth_argmax
from repro_torch.models import model as M
from repro_torch.serving.emvs_stream import EMVSStreamEngine, StreamConfig, iter_event_chunks
from repro_torch.serving.engine import Engine, EngineConfig, Request

BILINEAR_ATOL, BILINEAR_RTOL = 1e-4, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _inputs(seed: int, s: int, f: int, e: int, nz: int, w: int, h: int):
    rng = np.random.default_rng(seed)
    xy0 = rng.uniform((-8, -8), (w + 8, h + 8), (s, f, e, 2)).astype(np.float32)
    valid = rng.random((s, f, e)) > 0.2
    phi = np.concatenate([rng.uniform(0.7, 1.3, (s, f, nz, 1)),
                          rng.uniform(-6, 6, (s, f, nz, 2))], -1).astype(np.float32)
    return [torch.from_numpy(a) for a in (xy0, valid, phi)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_kernels_vs_plain(dev, mode, quantized):
    """Both kernels, one launch each, at the DAVIS240 width."""
    xy0, valid, phi = _inputs(17, 2, 4, 1024, 32, 240, 180)
    kw = dict(cx=132.0, cy=110.0, w=240, h=180, mode=mode, quantized=quantized)
    n0 = dict(cuda.launch_counts)
    dsi, conf, zf = ops.backproject_vote_detect(xy0.to(dev), valid.to(dev), phi.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda.launch_counts["backproject_vote"] == n0.get("backproject_vote", 0) + 1
    assert cuda.launch_counts["depth_argmax"] == n0.get("depth_argmax", 0) + 1
    dsi_p, conf_p, zf_p = ops.backproject_vote_detect(xy0, valid, phi, **kw)
    if mode == "nearest":
        assert torch.equal(dsi.cpu(), dsi_p)
        assert torch.equal(conf.cpu(), conf_p)
        assert torch.equal(zf.cpu(), zf_p)
    else:
        torch.testing.assert_close(dsi.cpu().float(), dsi_p.float(),
                                   atol=BILINEAR_ATOL, rtol=BILINEAR_RTOL)
    conf_r, zf_r = depth_argmax(dsi.cpu())
    assert torch.equal(conf.cpu(), conf_r)
    assert torch.equal(zf.cpu(), zf_r)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("S,F,E,NZ,W,H", [
    (1, 3, 1000, 8, 240, 180),  # 3,000 events: not a multiple of the 1,984-event stage
    (2, 3, 1023, 8, 240, 180),  # E not a multiple of 4: padded with zero weights
    (1, 1, 1, 4, 240, 180),  # a single event
    (2, 1, 1024, 8, 240, 180),  # C=1
    (1, 4, 512, 7, 240, 180),  # odd Nz
    (1, 4, 256, 2, 240, 180),  # Nz=2
    (3, 4, 700, 12, 240, 180),  # S=3
    (1, 600, 4, 4, 240, 180),  # frames past the 512-frame phi window
    (2, 4, 64, 6, 37, 23),  # a plane whose size is no multiple of 16 bytes
])
def test_cuda_sweep_edges(dev, mode, quantized, S, F, E, NZ, W, H):
    """The sweep kernel's edges (ring stages, padding, phi window, plane
    sizes), one launch each, against the plain version."""
    xy0, valid, phi = _inputs(S * 1000 + F + E + NZ, S, F, E, NZ, W, H)
    kw = dict(cx=W / 2 + 0.3, cy=H / 2 - 0.2, w=W, h=H, mode=mode, quantized=quantized)
    n0 = cuda.launch_counts["backproject_vote"]
    dsi, _, _ = ops.backproject_vote_detect(xy0.to(dev), valid.to(dev), phi.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda.launch_counts["backproject_vote"] == n0 + 1
    dsi_p, _, _ = ops.backproject_vote_detect(xy0, valid, phi, **kw)
    if mode == "nearest":
        assert torch.equal(dsi.cpu(), dsi_p)
    else:
        torch.testing.assert_close(dsi.cpu().float(), dsi_p.float(),
                                   atol=BILINEAR_ATOL, rtol=BILINEAR_RTOL)


@pytest.mark.gpu
def test_cuda_sweep_refuses_float_weights(dev):
    """On the card as on the CPU, validity must be a bool mask: a float
    weight (possibly fractional, which the int32 counts cannot hold) is
    refused before any launch."""
    xy0, valid, phi = (t.to(dev) for t in _inputs(5, 2, 4, 64, 8, 240, 180))
    kw = dict(cx=132.0, cy=110.0, w=240, h=180, quantized=True)
    n0 = cuda.launch_counts["backproject_vote"]
    half = valid.float() * 0.5
    with pytest.raises(ValueError, match="bool mask"):
        backproject_vote_cuda(xy0[..., 0], xy0[..., 1], half, phi, **kw)
    with pytest.raises(ValueError, match="bool mask"):
        ops.backproject_vote_detect(xy0, half, phi, **kw)
    assert cuda.launch_counts["backproject_vote"] == n0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int32])
def test_cuda_depth_argmax_dtypes(dev, dtype):
    g = torch.Generator().manual_seed(3)
    dsi = torch.randint(0, 40, (3, 16, 20, 30), generator=g).to(dtype)
    conf, zf = depth_argmax(dsi.to(dev))
    conf_r, zf_r = depth_argmax(dsi)
    assert torch.equal(conf.cpu(), conf_r)
    assert torch.equal(zf.cpu(), zf_r)


@pytest.mark.gpu
@pytest.mark.parametrize("W,H", [(400, 300), (346, 260)])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_plane_too_large_raises(dev, W, H, mode, quantized):
    """Planes past one CTA's shared memory no longer raise: B1 votes them in
    row bands (DAVIS346 two, 400x300 three) and matches its plain version."""
    xy0, valid, phi = _inputs(W + H, 2, 3, 700, 6, W, H)
    kw = dict(cx=W / 2 + 0.3, cy=H / 2 - 0.2, w=W, h=H, mode=mode, quantized=quantized)
    n0 = cuda.launch_counts["backproject_vote"]
    dsi, conf, zf = ops.backproject_vote_detect(xy0.to(dev), valid.to(dev), phi.to(dev), **kw)
    torch.cuda.synchronize()
    assert cuda.launch_counts["backproject_vote"] == n0 + 1
    dsi_p, conf_p, zf_p = ops.backproject_vote_detect(xy0, valid, phi, **kw)
    if mode == "nearest":
        assert torch.equal(dsi.cpu(), dsi_p)
        assert torch.equal(conf.cpu(), conf_p) and torch.equal(zf.cpu(), zf_p)
    else:
        torch.testing.assert_close(dsi.cpu().float(), dsi_p.float(),
                                   atol=BILINEAR_ATOL, rtol=BILINEAR_RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("band_rows", [1, 7, 45, 179, 180, 500])
@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_cuda_forced_bands(dev, band_rows, mode):
    """Forced band heights at 240x180 cross many band edges, bilinear votes
    that straddle two bands included; the result is the one-band result."""
    xy0, valid, phi = (t.to(dev) for t in _inputs(band_rows, 2, 4, 512, 5, 240, 180))
    kw = dict(cx=132.0, cy=110.0, w=240, h=180, mode=mode, quantized=False)
    got = backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi, band_rows=band_rows, **kw)
    want, _, _ = ops.backproject_vote_detect(xy0.cpu(), valid.cpu(), phi.cpu(), **kw)
    if mode == "nearest":
        assert torch.equal(got.cpu(), want)
    else:
        torch.testing.assert_close(got.cpu(), want, atol=BILINEAR_ATOL, rtol=BILINEAR_RTOL)


@pytest.mark.gpu
def test_cuda_band_plan_matches_the_kernel(dev):
    """The wrapper's shared-memory count is the kernel's own, and a band
    height of 0 is refused before any launch."""
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    for w, h in ((240, 180), (346, 260), (400, 300)):
        rows, _ = band_plan(w, h, limit)
        assert kernel_smem_bytes(w, rows) == smem_bytes(w, rows)
    xy0, valid, phi = (t.to(dev) for t in _inputs(1, 1, 1, 16, 2, 240, 180))
    with pytest.raises(ValueError, match="band_rows"):
        backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi, cx=1.0, cy=1.0,
                              w=240, h=180, band_rows=0)


@pytest.mark.gpu
def test_cuda_run_emvs_kernel_matches_scatter(dev):
    """A small end-to-end run on the card: the kernel formulation launches
    both kernels and agrees bitwise with the plain scatter formulation."""
    cam = CameraModel()
    scene = make_scene(SceneConfig(points_per_plane=150))
    traj = make_trajectory("simulation_3planes", 24, device=dev)
    frames = aggregate(cam, simulate_events(cam, scene, traj, device=dev), traj,
                       events_per_frame=1024, pose_extrapolation="clamp", device=dev)
    cfg = DSIConfig.for_camera(cam, num_planes=32, z_min=0.6, z_max=4.5)
    for quantized in (False, True):
        opts = EMVSOptions(formulation="kernel", quantized=quantized,
                           keyframe_dist_frac=0.05)
        cuda.launch_counts.clear()
        got = run_emvs(cam, cfg, frames, opts, device=dev)
        assert cuda.launch_counts["backproject_vote"] > 0
        assert cuda.launch_counts["depth_argmax"] > 0
        ref = run_emvs(cam, cfg, frames,
                       EMVSOptions(formulation="scatter", quantized=quantized,
                                   keyframe_dist_frac=0.05), device=dev)
        assert len(got.segments) == len(ref.segments) >= 1
        for a, b in zip(got.segments, ref.segments):
            assert torch.equal(a.dsi.float(), b.dsi.float())
            assert torch.equal(a.depth_map.depth, b.depth_map.depth)
            assert torch.equal(a.depth_map.mask, b.depth_map.mask)


@pytest.mark.gpu
def test_cuda_run_emvs_davis346_kernel_matches_scatter(dev):
    """DAVIS346 (346x260, two row bands in B1) end to end: the kernel
    formulation agrees bitwise with the scatter formulation."""
    cam = CAMERAS["davis346"]
    scene = make_scene(SceneConfig(points_per_plane=150))
    traj = make_trajectory("simulation_3planes", 24, device=dev)
    frames = aggregate(cam, simulate_events(cam, scene, traj, device=dev), traj,
                       events_per_frame=1024, pose_extrapolation="clamp", device=dev)
    cfg = DSIConfig.for_camera(cam, num_planes=32, z_min=0.6, z_max=4.5)
    for quantized in (False, True):
        opts = EMVSOptions(formulation="kernel", quantized=quantized, keyframe_dist_frac=0.05)
        got = run_emvs(cam, cfg, frames, opts, device=dev)
        ref = run_emvs(cam, cfg, frames, EMVSOptions(
            formulation="scatter", quantized=quantized, keyframe_dist_frac=0.05), device=dev)
        assert len(got.segments) == len(ref.segments) >= 1
        for a, b in zip(got.segments, ref.segments):
            assert torch.equal(a.dsi.float(), b.dsi.float())
            assert torch.equal(a.depth_map.depth, b.depth_map.depth)
            assert torch.equal(a.depth_map.mask, b.depth_map.mask)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 32, 8, 128, 128, 128),  # the serving path's heads, GQA 4:1
    (2, 4, 2, 128, 128, 16),  # GQA 2:1, narrow heads
    (1, 8, 2, 64, 256, 32),  # Sq < Skv, GQA 4:1
    (2, 3, 3, 100, 100, 64),  # MHA, ragged tiles
    (1, 2, 1, 40, 72, 256),  # widest heads, ragged, Sq < Skv
    (1, 2, 2, 8, 8, 8),  # narrowest heads, one partial tile
])
def test_cuda_flash_attention_vs_plain(dev, dtype, causal, B, Hq, Hkv, Sq, Skv, D):
    g = torch.Generator().manual_seed(B + Hq + Sq + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype) for shape in
               ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    n0 = cuda.launch_counts["flash_attention"]
    got = flash_attention(q.to(dev), k.to(dev), v.to(dev), causal=causal,
                          block_q=Sq, block_k=Skv)
    torch.cuda.synchronize()
    assert cuda.launch_counts["flash_attention"] == n0 + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = attention_ref(q.to(dev), k.to(dev), v.to(dev), causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [
    (1, 32, 8, 512, 512, 128),  # the serving path's prefill, GQA 4
    (1, 8, 8, 100, 100, 64),  # GQA 1, ragged
    (2, 16, 2, 100, 300, 80),  # GQA 8, Sq < Skv, D 80
    (1, 4, 1, 2047, 2047, 80),  # ragged, one tile short of 2048
    (1, 4, 4, 40, 72, 256),  # widest heads
    (1, 4, 2, 64, 64, 24),  # bf16 off the tensor-core route
])
def test_cuda_flash_attention_model_layout(dev, dtype, causal, B, Hq, Hkv, Sq, Skv, D):
    """(B, S, H, D) tensors transposed to (B, H, S, D), as the model passes
    them: read in place, the output in q's layout, one launch on the route
    `route` names."""
    g = torch.Generator().manual_seed(B + Hq + Sq + D)
    q, k, v = (torch.randn(shape, generator=g).to(dtype).to(dev).transpose(1, 2) for shape in
               ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))
    r = route(dtype, D)
    assert r == ("tc" if dtype == torch.bfloat16 and D % 16 == 0 else "fma")
    n0 = dict(cuda.launch_counts)
    got = flash_attention(q, k, v, causal=causal, block_q=Sq, block_k=Skv)
    torch.cuda.synchronize()
    for key in ("flash_attention", f"flash_attention_{r}"):
        assert cuda.launch_counts[key] == n0.get(key, 0) + 1, key
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    want = attention_ref(q, k, v, causal=causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)


@pytest.mark.gpu
def test_cuda_flash_attention_refuses(dev):
    q = torch.zeros((1, 2, 16, 12), device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention(q, q, q)
    q = torch.zeros((1, 2, 16, 16), device=dev)
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q.half(), q.half())
    with pytest.raises(ValueError, match="multiples of blocks"):
        flash_attention(torch.zeros((1, 2, 200, 16), device=dev), q, q)


@pytest.mark.gpu
def test_cuda_engine_reduced_matches_cpu(dev):
    """The reduced qwen3-8b served on the card in float32 weights: every
    prefill layer launches the kernel, and the greedy tokens equal the
    CPU engine's (plain attention)."""
    cfg = get_config("qwen3-8b").reduced()
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    params_dev = _to(params, dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=p).astype(np.int32)
               for p in (5, 9, 14, 7, 30)]
    ecfg = EngineConfig(slots=2, max_len=64, prefill_buckets=(16, 32))
    out = []
    for p in (params, params_dev):
        eng = Engine(cfg, p, ecfg, eos_id=-1)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        cuda.launch_counts.clear()
        eng.run_until_done(1000)
        out.append([r.generated for r in reqs])
    assert cuda.launch_counts["flash_attention"] == cfg.n_layers * len(prompts)
    assert cuda.launch_counts["flash_attention_fma"] == cfg.n_layers * len(prompts)
    assert out[0] == out[1]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b", "jamba-1.5-large-398b"])
def test_cuda_family_engine_reduced_matches_cpu(dev, arch):
    """The reduced MoE, SSM and hybrid archs served on the card in float32
    weights: B3 once per attention layer of every prefill (none for the
    SSM arch), SSM and hybrid prompts prefilled at their exact lengths, and
    the greedy tokens equal the CPU engine's."""
    cfg = get_config(arch).reduced()
    params = M.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    params_dev = _to(params, dev)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, size=p).astype(np.int32)
               for p in (5, 11, 30, 7)]
    ecfg = EngineConfig(slots=2, max_len=64, prefill_buckets=(16, 32))
    out = []
    for p in (params, params_dev):
        eng = Engine(cfg, p, ecfg, eos_id=-1)
        reqs = [Request(rid=i, prompt=pr, max_new_tokens=6) for i, pr in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        cuda.launch_counts.clear()
        eng.run_until_done(1000)
        out.append([r.generated for r in reqs])
    n_attn = cfg.pattern().count("attn") * cfg.n_superblocks()
    assert cuda.launch_counts["flash_attention"] == n_attn * len(prompts)
    assert out[0] == out[1]


def _stream_scene(n_planes: int = 32):
    """Events of a 24-step arc (on the host), their host-aggregated 1024-event
    frames, the trajectory, the DSI config and the kernel options."""
    cam = CameraModel()
    traj = make_trajectory("simulation_3planes", 24, device="cpu")
    events = simulate_events(cam, make_scene(SceneConfig(points_per_plane=150)), traj,
                             device="cpu")
    frames = aggregate(cam, events, traj, events_per_frame=1024,
                       pose_extrapolation="clamp", device="cpu")
    cfg = DSIConfig.for_camera(cam, num_planes=n_planes, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", quantized=True, keyframe_dist_frac=0.05)
    return cam, traj, events, frames, cfg, opts


def _stream_engine(dev, cam, traj, cfg, opts, **stream):
    return EMVSStreamEngine(cam, cfg, traj, opts,
                            StreamConfig(pose_extrapolation="clamp", **stream), device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["latency", "throughput", "adaptive"])
def test_cuda_stream_engine_matches_run_emvs(dev, policy):
    """The streaming engine on the card, nearest quantized on the kernel
    formulation: bitwise `run_emvs` on the same host-aggregated frames,
    and B1 and B2 launch once per dispatch."""
    cam, traj, events, frames, cfg, opts = _stream_scene()
    ref = run_emvs(cam, cfg, frames, opts, device=dev)
    for chunk in (997, 4096):
        engine = _stream_engine(dev, cam, traj, cfg, opts, dispatch_policy=policy)
        cuda.launch_counts.clear()
        for c in iter_event_chunks(events, chunk):
            engine.push(c)
        got = engine.flush()
        n = engine.stats["dispatches"]
        assert n >= 1 and cuda.launch_counts["backproject_vote"] == n
        assert cuda.launch_counts["depth_argmax"] == n
        assert [s.frame_range for s in got.segments] == [s.frame_range for s in ref.segments]
        for a, b in zip(got.segments, ref.segments):
            assert a.dsi.is_cuda
            assert torch.equal(a.dsi, b.dsi)
            assert torch.equal(a.depth_map.depth, b.depth_map.depth)
            assert torch.equal(a.depth_map.mask, b.depth_map.mask)
        assert engine._dispatcher.device_time_s.count == n


@pytest.mark.gpu
def test_cuda_dispatch_makes_no_host_sync(dev):
    """Staging, the sweep (B1, B2, detection), the point clouds, the
    saturation copy and the event record: no host sync in `_dispatch`."""
    cam, traj, events, frames, cfg, opts = _stream_scene()
    engine = _stream_engine(dev, cam, traj, cfg, opts, max_inflight=8)
    dispatcher = engine._dispatcher
    dispatch = dispatcher._dispatch
    calls = []

    def strict(group, cap):
        torch.cuda.set_sync_debug_mode("error")
        try:
            dispatch(group, cap)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        calls.append(len(group))

    dispatcher._dispatch = strict
    engine.push(events)  # cold: the first dispatch builds and loads the kernels
    got = engine.flush()
    assert calls and sum(calls) == len(got.segments)
    ref = run_emvs(cam, cfg, frames, opts, device=dev)
    for a, b in zip(got.segments, ref.segments):
        assert torch.equal(a.dsi, b.dsi)


@pytest.mark.gpu
def test_cuda_harvest_does_not_wait(dev):
    """Sweeps queued behind a long-running kernel are not complete: `push`
    and `poll` return at once without them, and they surface once the card
    has run them. (`max_inflight` above the dispatch count: the
    back-pressure on the oldest sweep waits by design.)"""
    cam, traj, events, frames, cfg, opts = _stream_scene()
    warm = _stream_engine(dev, cam, traj, cfg, opts, dispatch_policy="latency")
    warm.push(events)  # builds and loads the kernels
    warm.flush()
    engine = _stream_engine(dev, cam, traj, cfg, opts, dispatch_policy="latency",
                            max_inflight=16)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(3e9))  # about 1.5 s of the card's clock on this stream
    t0 = time.perf_counter()
    early = engine.push(events) + engine.poll()
    waited = time.perf_counter() - t0
    queued = len(engine._inflight)
    torch.cuda.synchronize()
    late = engine.poll()
    engine.flush()
    assert early == [] and queued >= 2, "a sweep the card has not run surfaced"
    assert waited < 0.5, f"push and poll waited {waited:.3f} s for the card"
    assert len(late) == queued


@pytest.mark.gpu
def test_cuda_batch_staged_from_pinned_memory(dev):
    """`pad_segment_rows`' batch reaches the card by non-blocking copies from
    pinned host tensors, which the in-flight entry keeps until harvest."""
    from repro_torch.core.pipeline import pad_segment_rows
    from repro_torch.serving.sweep_dispatcher import _stage

    cam, traj, events, frames, cfg, opts = _stream_scene()
    host = pad_segment_rows([(frames, (0, 3)), (frames, (3, 7))], 4)
    torch.cuda.set_sync_debug_mode("error")
    try:
        staged, pinned = _stage(host, dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(t.is_pinned() for t in pinned)
    assert all(t.is_cuda for t in staged)
    for a, b in zip(staged, host):
        assert torch.equal(a.cpu(), b)
    engine = _stream_engine(dev, cam, traj, cfg, opts, dispatch_policy="latency")
    dispatcher = engine._dispatcher
    dispatch, entries = dispatcher._dispatch, []

    def keep(group, cap):
        dispatch(group, cap)
        entries.append(dispatcher._inflight[-1])

    dispatcher._dispatch = keep
    engine.push(events)
    engine.flush()
    assert entries and len(entries) == engine.stats["dispatches"]
    for inf in entries:
        assert inf.staging is not None and all(t.is_pinned() for t in inf.staging)
        assert inf.staging.xy.shape[0] == inf.dsis.shape[0]
        assert inf.saturation.is_pinned() and inf.done is not None and inf.done.query()


def _buckets(frames, cfg, opts) -> int:
    return len({tp.bucket_capacity(b - a) for a, b in tp.plan_segments(frames, cfg, opts)})


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_run_emvs_sharded_matches_batched(dev, quantized):
    """`run_emvs(sweep="sharded")` over one NCCL rank equals the batched
    backend bitwise on dsi, depth, mask and the point clouds."""
    from repro_torch.distributed.emvs import local_process_group, make_segment_mesh

    cam, traj, events, frames, cfg, opts = _stream_scene()
    opts = dataclasses.replace(opts, quantized=quantized)
    want = run_emvs(cam, cfg, frames, opts, device=dev)
    with local_process_group(dev):
        mesh = make_segment_mesh()
        assert mesh.device_type == "cuda" and tuple(mesh.shape) == (1,)
        got = run_emvs(cam, cfg, frames, opts, sweep="sharded", mesh=mesh, device=dev)
    assert len(got.segments) == len(want.segments) >= 2
    for a, b, ca, cb in zip(got.segments, want.segments, got.clouds, want.clouds):
        assert a.frame_range == b.frame_range and a.dsi.dtype == b.dsi.dtype
        for x, y in ((a.dsi, b.dsi), (a.depth_map.depth, b.depth_map.depth),
                     (a.depth_map.mask, b.depth_map.mask),
                     (a.depth_map.confidence, b.depth_map.confidence),
                     (ca.points, cb.points), (ca.valid, cb.valid)):
            assert x.is_cuda and torch.equal(x, y)


@pytest.mark.gpu
def test_cuda_sharded_launches_b1_b2_once_per_bucket(dev):
    from repro_torch.distributed.emvs import local_process_group

    cam, traj, events, frames, cfg, opts = _stream_scene()
    with local_process_group(dev):
        run_emvs(cam, cfg, frames, opts, sweep="sharded", device=dev)  # loads the kernels
        torch.cuda.synchronize()
        cuda.launch_counts.clear()
        run_emvs(cam, cfg, frames, opts, sweep="sharded", device=dev)
        torch.cuda.synchronize()
    # one launch of each per bucket sweep, not one per segment
    n = _buckets(frames, cfg, opts)
    assert len(tp.plan_segments(frames, cfg, opts)) > n >= 1
    assert cuda.launch_counts["backproject_vote"] == cuda.launch_counts["depth_argmax"] == n


@pytest.mark.gpu
def test_cuda_gathers_int16_and_bool_exactly(dev):
    """NCCL carries no int16: it goes as bytes and comes back exact."""
    from repro_torch.distributed.emvs import all_gather_rows, local_process_group

    with local_process_group(dev):
        group = torch.distributed.group.WORLD
        x = torch.randint(-32768, 32767, (3, 5, 7), dtype=torch.int16, device=dev)
        m = torch.rand(3, 5, 7, device=dev) > 0.5
        for t in (x, m, x.float(), x[:, 1:]):
            got = all_gather_rows(t, group)
            assert got.dtype == t.dtype and torch.equal(got, t)


@pytest.mark.gpu
def test_cuda_sharded_stream_dispatch_makes_no_host_sync(dev):
    """`StreamConfig(sweep="sharded")` on one NCCL rank: the collectives are
    ordered on the stream like the sweep, `_dispatch` makes no host sync,
    and the results equal `run_emvs` bitwise."""
    from repro_torch.distributed.emvs import local_process_group

    cam, traj, events, frames, cfg, opts = _stream_scene()
    ref = run_emvs(cam, cfg, frames, opts, device=dev)
    with local_process_group(dev):
        warm = _stream_engine(dev, cam, traj, cfg, opts, sweep="sharded")
        warm.push(events)  # loads the kernels
        warm.flush()
        engine = _stream_engine(dev, cam, traj, cfg, opts, sweep="sharded", max_inflight=8)
        dispatcher = engine._dispatcher
        dispatch = dispatcher._dispatch
        calls = []

        def strict(group, cap):
            torch.cuda.set_sync_debug_mode("error")
            try:
                dispatch(group, cap)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            calls.append(len(group))

        dispatcher._dispatch = strict
        cuda.launch_counts.clear()
        for c in iter_event_chunks(events, 997):
            engine.push(c)
        got = engine.flush()
    assert calls and sum(calls) == len(got.segments)
    assert cuda.launch_counts["backproject_vote"] == engine.stats["dispatches"]
    for a, b in zip(got.segments, ref.segments):
        assert torch.equal(a.dsi, b.dsi)
        assert torch.equal(a.depth_map.mask, b.depth_map.mask)


@pytest.mark.gpu
def test_cuda_stream_engine_refuses_a_multi_rank_cuda_mesh(dev, monkeypatch):
    """With the segment axis reported as 2 ranks on a CUDA mesh, the
    stream engine raises: rank-local readiness could split the schedule."""
    from repro_torch.distributed import emvs as t_emvs

    cam, traj, events, frames, cfg, opts = _stream_scene()
    with t_emvs.local_process_group(dev):
        mesh = t_emvs.make_segment_mesh()
        monkeypatch.setattr(t_emvs, "segment_axis_size", lambda mesh, axis_name="segments": 2)
        with pytest.raises(NotImplementedError, match="readiness"):
            _stream_engine(dev, cam, traj, cfg, opts, sweep="sharded")
        monkeypatch.undo()
        assert _stream_engine(dev, cam, traj, cfg, opts, sweep="sharded").mesh is not None
        assert mesh.device_type == "cuda"


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)
