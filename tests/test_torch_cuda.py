"""The port's CUDA kernels on a card, against their plain versions.

Every test here carries the `gpu` marker and skips without a CUDA device.
This file imports neither JAX nor the reference, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Nearest voting is bitwise on dsi, conf and zf; bilinear dsi within
BILINEAR_ATOL/RTOL (float atomics reorder the sum of fractional weights);
the depth max/argmax kernel is bitwise on any stored DSI; the detection
tail kernel is bitwise the CPU path on depth, mask and confidence, at any
plane size and on a sweep at the offline cell's configuration; the front-end
kernel (frame geometry, Table 1, the homography) is bitwise the CPU's eager
front end on xy0, valid and phi, on both sensors, both datapaths and any
bucket shape, and a whole `run_emvs` with it equals one fed the eager front
end's outputs, one launch of it a bucket. The frame-pose kernel is bitwise
the card's eager `pose_at_times` (out-of-span queries, repeated sample times,
identity and near-pi rotations, two samples), and `aggregate` on the card is
bitwise the streaming aggregator's push and flush on the card, by one copy
and one launch. Flash attention
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
from repro_torch.core import detection
from repro_torch.core import pipeline as tp
from repro_torch.core.camera import CAMERAS, CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3, so3_exp
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, run_emvs
from repro_torch.events.aggregation import (
    PARKED_COORD,
    StreamingAggregator,
    aggregate,
    concat_event_frames,
)
from repro_torch.events.simulator import (
    EventStream,
    SceneConfig,
    Trajectory,
    make_scene,
    make_trajectory,
    simulate_events,
)
from repro_torch.events.trajectory_stream import TrajectoryBuffer, pose_at_times
from repro_torch.kernels import cuda
from repro_torch.kernels.backproject_vote import ops
from repro_torch.kernels.backproject_vote.kernel import (
    backproject_vote_cuda,
    band_plan,
    kernel_smem_bytes,
    smem_bytes,
)
from repro_torch.kernels.canonical_project.ops import canonical_project
from repro_torch.kernels.canonical_project.ref import canonical_project_ref
from repro_torch.kernels.detect_filter import ops as D
from repro_torch.kernels.detect_filter.kernel import detect_filter_cuda
from repro_torch.kernels.flash_attention.kernel import route
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.frame_poses.ops import frame_poses
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
@pytest.mark.parametrize("W,H,bands", [(240, 180, 1), (346, 260, 2)])
@pytest.mark.parametrize("quantized", [False, True])
def test_cuda_band_counter(dev, W, H, bands, quantized):
    """One B1 launch adds its row bands to `backproject_vote_bands`: one at
    DAVIS240, two at DAVIS346, whatever the store."""
    xy0, valid, phi = (t.to(dev) for t in _inputs(W, 2, 3, 256, 4, W, H))
    n0 = dict(cuda.launch_counts)
    backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi, cx=W / 2, cy=H / 2,
                          w=W, h=H, quantized=quantized)
    torch.cuda.synchronize()
    assert cuda.launch_counts["backproject_vote"] == n0.get("backproject_vote", 0) + 1
    assert cuda.launch_counts["backproject_vote_bands"] == (
        n0.get("backproject_vote_bands", 0) + bands)


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
        # one launch of the front end and of the detection tail a bucket, as B1's
        assert cuda.launch_counts["detect_filter"] == cuda.launch_counts["backproject_vote"]
        assert cuda.launch_counts["canonical_project"] == cuda.launch_counts["backproject_vote"]
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


def _tail_inputs(seed: int, s: int, h: int, w: int, nz: int = 16):
    """Vote counts with a few tall peaks and refined plane indices past both
    ends of the planes (the clamps)."""
    rng = np.random.default_rng(seed)
    conf = rng.poisson(2.0, (s, h, w)) + 40 * (rng.random((s, h, w)) < 0.05)
    conf = conf.astype(np.float32) + rng.choice([0.0, 0.25], (s, h, w)).astype(np.float32)
    zf = rng.uniform(-1.5, nz + 0.5, (s, h, w)).astype(np.float32)
    planes = np.sort(rng.uniform(0.6, 4.5, nz)).astype(np.float32)
    return [torch.from_numpy(a) for a in (conf, zf, planes)]


def _tail(conf, zf, planes, radius, median_filter, **kw):
    """The CPU's plain tail, from `core.detection`."""
    if radius == detection.ADAPTIVE_RADIUS:
        return detection.detect_and_filter_from(conf, zf, planes,
                                                median_filter=median_filter, **kw)
    dm = detection.detect_structure_from(conf, zf, planes, adaptive_radius=radius, **kw)
    return detection._median_tail(dm, median_filter)


def _assert_same_depth_map(got, want):
    assert torch.equal(got.mask.cpu(), want.mask)
    assert torch.equal(got.depth.cpu().view(torch.int32), want.depth.view(torch.int32))
    assert torch.equal(got.confidence.cpu(), want.confidence)


@pytest.mark.gpu
@pytest.mark.parametrize("radius", [5, 2])
@pytest.mark.parametrize("median_filter", [True, False])
@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("H,W", [(180, 240), (260, 346), (5, 7), (1, 1), (2, 3), (4, 6)])
def test_cuda_detect_filter_matches_cpu(dev, H, W, S, median_filter, radius):
    """The detection tail's wrapper, one launch, bitwise the CPU path on
    depth, mask and confidence: both sensors, a small plane, one pixel,
    planes smaller than the halo, the default radius and radius 2."""
    conf, zf, planes = _tail_inputs(H * 1000 + W * 10 + S, S, H, W)
    n0 = cuda.launch_counts["detect_filter"]
    got = D.detect_filter(conf.to(dev), zf.to(dev), planes.to(dev), median_filter=median_filter,
                          adaptive_radius=radius)
    torch.cuda.synchronize()
    assert cuda.launch_counts["detect_filter"] == n0 + 1
    _assert_same_depth_map(got, _tail(conf, zf, planes, radius, median_filter))


@pytest.mark.gpu
@pytest.mark.parametrize("median_filter", [True, False])
@pytest.mark.parametrize("threshold_c,min_votes", [(6.0, 3.0), (1.0, 1.0)])
def test_cuda_detect_filter_on_a_sweep(dev, median_filter, threshold_c, min_votes):
    """conf and zf from B1 and B2 at the offline cell's configuration
    (DAVIS240, 128 planes, nearest, Table-1 quantized): the tail on the card
    is bitwise the CPU path's."""
    cam = CameraModel()
    scene = make_scene(SceneConfig(points_per_plane=600))
    traj = make_trajectory("simulation_3planes", 48, device=dev)
    frames = aggregate(cam, simulate_events(cam, scene, traj, device=dev), traj,
                       events_per_frame=1024, pose_extrapolation="clamp", device=dev)
    cfg = DSIConfig.for_camera(cam, num_planes=128, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", quantized=True, keyframe_dist_frac=0.05)
    res = run_emvs(cam, cfg, frames, opts, device=dev)
    conf, zf = depth_argmax(torch.stack([seg.dsi for seg in res.segments]))
    planes = cfg.planes(device=dev)
    kw = dict(threshold_c=threshold_c, min_votes=min_votes, median_filter=median_filter)
    got = D.detect_filter(conf, zf, planes, **kw)
    want = detection.detect_and_filter_from(conf.cpu(), zf.cpu(), planes.cpu(), **kw)
    assert conf.shape[0] >= 2 and int(want.mask.sum()) > 100
    _assert_same_depth_map(got, want)


@pytest.mark.gpu
def test_cuda_detect_filter_refuses(dev):
    conf, zf, planes = (t.to(dev) for t in _tail_inputs(3, 1, 8, 8))
    taps = D._gaussian_taps(2.5, 5)
    kw = dict(threshold_c=6.0, min_votes=3.0, median_filter=True)
    with pytest.raises(ValueError, match="radius must be at most 8"):
        D.detect_filter(conf, zf, planes, adaptive_radius=9)
    with pytest.raises(TypeError, match="float32"):
        detect_filter_cuda(conf.double(), zf, planes, taps, **kw)
    with pytest.raises(TypeError, match="float32"):
        detect_filter_cuda(conf, zf, planes.double(), taps, **kw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        detect_filter_cuda(conf.cpu(), zf.cpu(), planes.cpu(), taps, **kw)


def _front_batch(seed: int, s: int, c: int, e: int, cam: CameraModel) -> SegmentBatch:
    """A bucket on the host: poses near each segment's key frame, events over
    the sensor and past its edges, some parked far outside and invalid, and
    every segment but the first padded after a random number of real frames
    (repeating its last real frame, as `pad_segments` does)."""
    rng = np.random.default_rng(seed)
    R = so3_exp(torch.from_numpy(rng.normal(0.0, 0.05, (s, c, 3)).astype(np.float32)))
    t = torch.from_numpy(rng.normal(0.0, 0.2, (s, c, 3)).astype(np.float32))
    xy = rng.uniform((-4.0, -4.0), (cam.width + 4.0, cam.height + 4.0),
                     (s, c, e, 2)).astype(np.float32)
    valid = rng.random((s, c, e)) > 0.1
    parked = rng.random((s, c, e)) < 0.05
    xy[parked] = PARKED_COORD
    valid[parked] = False
    n_real = np.array([c] + [int(rng.integers(1, c + 1)) for _ in range(s - 1)])
    idx = torch.from_numpy(np.minimum(np.arange(c)[None, :], n_real[:, None] - 1))
    rows = torch.arange(s)[:, None]
    R, t = R[rows, idx].contiguous(), t[rows, idx].contiguous()
    return SegmentBatch(
        xy=torch.from_numpy(xy)[rows, idx].contiguous(),
        valid=torch.from_numpy(valid)[rows, idx].contiguous(),
        frame_valid=torch.from_numpy(np.arange(c)[None, :] < n_real[:, None]),
        poses_R=R, poses_t=t, ref_R=R[:, 0].contiguous(), ref_t=t[:, 0].contiguous())


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.cpu().view(torch.int32) if t.dtype == torch.float32 else t.cpu()


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 20, 40, 80])
@pytest.mark.parametrize("S", [1, 2, 3])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("camera", ["davis240", "davis346"])
def test_cuda_canonical_project_matches_cpu(dev, camera, quantized, S, C):
    """The front end, one launch, bitwise its plain version on the CPU
    (`canonical_project_ref`: the frame geometry, then `canonical_inputs`) on
    xy0, valid and phi: both sensors, Table 1 and float32, padded frames,
    parked events."""
    cam = CAMERAS[camera]
    e = 1024 if C > 1 else 37
    batch = _front_batch(1000 * S + C + (7 if quantized else 0), S, C, e, cam)
    planes = DSIConfig.for_camera(cam, num_planes=128, z_min=0.6, z_max=4.5).planes(
        device="cpu")
    want = canonical_project_ref(cam, batch, planes, planes[64], quantized=quantized)
    planes_d = planes.to(dev)
    n0 = cuda.launch_counts["canonical_project"]
    got = canonical_project(cam, SegmentBatch(*(x.to(dev) for x in batch)), planes_d,
                            planes_d[64], quantized=quantized)
    torch.cuda.synchronize()
    assert cuda.launch_counts["canonical_project"] == n0 + 1
    for name, a, b in zip(("xy0", "valid", "phi"), got, want):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert bool(want[1].any()) and not bool(want[1].all())


@pytest.mark.gpu
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("camera", ["davis240", "davis346"])
def test_cuda_run_emvs_front_end_matches_eager(dev, monkeypatch, camera, quantized):
    """A whole `run_emvs` on the card with the front-end kernel equals the
    same run fed the eager front end's outputs (computed on the CPU, moved to
    the card) bitwise on every DSI, depth map and mask; the kernel launches
    once a bucket, as B1."""
    cam = CAMERAS[camera]
    scene = make_scene(SceneConfig())
    traj = make_trajectory("simulation_3planes", 96, device="cpu")
    frames = aggregate(cam, simulate_events(cam, scene, traj, device="cpu"), traj,
                       events_per_frame=1024, pose_extrapolation="clamp", device="cpu")
    cfg = DSIConfig.for_camera(cam, num_planes=64, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", quantized=quantized, keyframe_dist_frac=0.05)
    cuda.launch_counts.clear()
    got = run_emvs(cam, cfg, frames, opts, device=dev)
    torch.cuda.synchronize()
    n = _buckets(frames, cfg, opts)
    assert n >= 2
    assert cuda.launch_counts["canonical_project"] == cuda.launch_counts["backproject_vote"] == n

    def eager(cam_, batch, planes, z0, *, quantized):
        cpu = SegmentBatch(*(x.cpu() for x in batch))
        out = canonical_project_ref(cam_, cpu, planes.cpu(), z0.cpu(), quantized=quantized)
        return tuple(x.to(dev) for x in out)

    monkeypatch.setattr(tp, "canonical_project", eager)
    cuda.launch_counts.clear()
    want = run_emvs(cam, cfg, frames, opts, device=dev)
    assert cuda.launch_counts["canonical_project"] == 0
    assert len(got.segments) == len(want.segments) >= 2
    for a, b in zip(got.segments, want.segments):
        assert a.frame_range == b.frame_range
        assert torch.equal(a.dsi, b.dsi)
        assert torch.equal(_bits(a.depth_map.depth), _bits(b.depth_map.depth))
        assert torch.equal(a.depth_map.mask, b.depth_map.mask)


@pytest.mark.gpu
def test_cuda_canonical_project_refuses(dev):
    cam = CameraModel()
    batch = SegmentBatch(*(x.to(dev) for x in _front_batch(3, 2, 4, 32, cam)))
    planes = torch.linspace(0.6, 4.5, 16, device=dev)
    n0 = cuda.launch_counts["canonical_project"]
    with pytest.raises(ValueError, match="bool mask"):
        canonical_project(cam, batch._replace(valid=batch.valid.float()), planes, planes[8],
                          quantized=True)
    with pytest.raises(TypeError, match="float32"):
        canonical_project(cam, batch._replace(xy=batch.xy.double()), planes, planes[8],
                          quantized=True)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        canonical_project(cam, batch._replace(ref_t=batch.ref_t.cpu()), planes, planes[8],
                          quantized=True)
    assert cuda.launch_counts["canonical_project"] == n0


def _pose_trajectory(kind: str, seed: int) -> Trajectory:
    """A host trajectory: random rotations ("random"), with some sample times
    repeated ("repeated"), every other interval without rotation
    ("identity"), intervals turning by pi less 1e-2 to 0 ("near_pi"), or two
    samples ("two")."""
    rng = np.random.default_rng(seed)
    n = 2 if kind == "two" else 64
    times = np.sort(rng.uniform(0.0, 1.0, n)).astype(np.float32)
    if kind == "repeated":
        times[1::3] = times[0::3][:len(times[1::3])]
        times = np.sort(times)
    R = so3_exp(torch.from_numpy(rng.normal(0.0, 1.0, (n, 3)).astype(np.float32)))
    if kind == "identity":
        R[1::2] = R[0::2][:len(R[1::2])]
    if kind == "near_pi":
        axes = rng.normal(0.0, 1.0, (n, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        turn = np.pi - np.array([1e-2, 1e-4, 1e-6, 0.0])[np.arange(n) % 4]
        steps = so3_exp(torch.from_numpy((axes * turn[:, None]).astype(np.float32)))
        for k in range(1, n):
            R[k] = steps[k] @ R[k - 1]
    t = torch.from_numpy(rng.normal(0.0, 1.0, (n, 3)).astype(np.float32))
    return Trajectory(torch.from_numpy(times), SE3(R.contiguous(), t))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "repeated", "identity", "near_pi", "two"])
def test_cuda_frame_poses_matches_eager(dev, kind):
    """The frame-pose kernel, one launch, bitwise the eager `pose_at_times`
    on the card: queries before, inside and past the span, at the sample
    times and between them."""
    traj = _pose_trajectory(kind, len(kind))
    rng = np.random.default_rng(9)
    mids = (traj.times[1:] + traj.times[:-1]) * 0.5
    tq = torch.cat([torch.from_numpy(rng.uniform(-0.2, 1.2, 4000).astype(np.float32)),
                    traj.times, mids]).to(dev)
    td = Trajectory(traj.times.to(dev), SE3(traj.poses.R.to(dev), traj.poses.t.to(dev)))
    want = pose_at_times(td, tq)
    n0 = cuda.launch_counts["frame_poses"]
    got = frame_poses(td.times, td.poses.R, td.poses.t, tq)
    torch.cuda.synchronize()
    assert cuda.launch_counts["frame_poses"] == n0 + 1
    for name, a, b in zip(("R", "t"), got, want):
        assert a.is_cuda and a.dtype == b.dtype and a.shape == b.shape, name
        bad = int((_bits(a) != _bits(b)).sum())
        assert bad == 0, f"{kind}: {name} differs in {bad} of {a.numel()} values"


@pytest.fixture(scope="module")
def _agg_scene():
    cam = CameraModel()
    traj = make_trajectory("simulation_3planes", 24, device="cpu")
    events = simulate_events(cam, make_scene(SceneConfig()), traj, device="cpu")
    return cam, traj, events


@pytest.mark.gpu
@pytest.mark.parametrize("keep_tail", [True, False])
@pytest.mark.parametrize("cut", ["below_e", "multiple", "partial"])
@pytest.mark.parametrize("where", ["host", "card"])
def test_cuda_aggregate_matches_streaming_aggregator(dev, _agg_scene, where, cut, keep_tail):
    """`aggregate` on the card is bitwise, in all five fields, the streaming
    aggregator's push and flush on the card, and its poses bitwise the eager
    `pose_at_times` on the card: a stream on the host or on the card; fewer
    events than a frame, a multiple of the frame size, a partial tail; one
    `frame_poses` launch when there are frames."""
    cam, traj, events = _agg_scene
    e = 1024
    n = {"below_e": 700, "multiple": 20 * e, "partial": 20 * e + 333}[cut]
    assert events.t.shape[0] >= n
    part = EventStream(*(a[:n] for a in events))
    if where == "card":
        part = EventStream(*(a.to(dev) for a in part))
    agg = StreamingAggregator(cam, traj, e, pose_extrapolation="clamp", device=dev)
    want = concat_event_frames([agg.push(part)] + ([agg.flush()] if keep_tail else []))
    n0 = cuda.launch_counts["frame_poses"]
    got = aggregate(cam, part, traj, e, keep_tail, pose_extrapolation="clamp", device=dev)
    torch.cuda.synchronize()
    f = n // e + (keep_tail and n % e > 0)
    assert cuda.launch_counts["frame_poses"] == n0 + (f > 0)
    fields = ("xy", "valid", "t_mid", "R", "t")
    for name, a, b in zip(fields, (got.xy, got.valid, got.t_mid, *got.poses),
                          (want.xy, want.valid, want.t_mid, *want.poses)):
        assert a.is_cuda and a.dtype == b.dtype and a.shape[0] == f, name
        assert a.shape == b.shape and torch.equal(_bits(a), _bits(b)), name
    td = Trajectory(traj.times.to(dev), SE3(traj.poses.R.to(dev), traj.poses.t.to(dev)))
    for name, a, b in zip(("R", "t"), got.poses, pose_at_times(td, got.t_mid)):
        assert torch.equal(_bits(a), _bits(b)), f"{name} against the eager chain"


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["distorted", "gated"])
def test_cuda_streaming_aggregator_poses_by_the_kernel(dev, _agg_scene, source):
    """The streaming aggregator on the card poses by `frame_poses`, one launch
    a pose call (a push that completes frames, a flush with a tail), bitwise
    the eager `pose_at_times` on the card: `aggregate` with a distorted camera
    (which keeps the aggregator's path), and a pose-gated aggregator fed a
    `TrajectoryBuffer` chunk by chunk (each release posed from a slice of the
    buffer)."""
    cam, traj, events = _agg_scene
    e = 1024
    part = EventStream(*(a[:20 * e + 333].to(dev) for a in events))
    td = Trajectory(traj.times.to(dev), SE3(traj.poses.R.to(dev), traj.poses.t.to(dev)))
    n0 = cuda.launch_counts["frame_poses"]
    if source == "distorted":
        dcam = dataclasses.replace(cam, k1=-0.08, k2=0.01, p1=1e-3, p2=-5e-4)
        got = aggregate(dcam, part, traj, e, pose_extrapolation="clamp", device=dev)
        calls = 2  # the push's 20 full frames, the flush's tail
    else:
        agg = StreamingAggregator(cam, TrajectoryBuffer(), e, pose_extrapolation="clamp",
                                  device=dev)
        parts = []
        n_s, n_ev = traj.times.shape[0], part.t.shape[0]
        for k in range(0, n_s, 5):
            parts.append(agg.push_poses(Trajectory(
                traj.times[k:k + 5], SE3(traj.poses.R[k:k + 5], traj.poses.t[k:k + 5]))))
            parts.append(agg.push(EventStream(*(a[k * n_ev // n_s:(k + 5) * n_ev // n_s]
                                                for a in part))))
        parts += [agg.finalize_poses(), agg.flush()]
        calls = sum(p.t_mid.shape[0] > 0 for p in parts)
        got = concat_event_frames(parts)
    torch.cuda.synchronize()
    assert got.t_mid.shape[0] == 21 and got.poses.R.is_cuda
    assert cuda.launch_counts["frame_poses"] == n0 + calls
    for name, a, b in zip(("R", "t"), got.poses, pose_at_times(td, got.t_mid)):
        assert torch.equal(_bits(a), _bits(b)), f"{source}: {name} against the eager chain"


class _CudaOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Records every dispatched operation, views left out, that gives a CUDA
    tensor."""

    def __init__(self):
        super().__init__()
        self.names: list[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        flat = torch.utils._pytree.tree_leaves(out)
        if not func.is_view and any(isinstance(x, torch.Tensor) and x.is_cuda for x in flat):
            self.names.append(str(func))
        return out


@pytest.mark.gpu
def test_cuda_aggregate_is_one_copy_and_one_launch(dev, _agg_scene):
    """A host stream reaches the card by one copy from pinned memory and is
    posed by one `frame_poses` launch: no other device operation, no host
    sync."""
    cam, traj, events = _agg_scene
    aggregate(cam, events, traj, 1024, pose_extrapolation="clamp", device=dev)  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with _CudaOps() as ops:
            frames = aggregate(cam, events, traj, 1024, pose_extrapolation="clamp", device=dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ops.names == ["aten._to_copy.default", "repro_torch.frame_poses.default"]
    assert frames.xy.is_cuda and frames.poses.R.is_cuda


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
        assert cuda.launch_counts["depth_argmax"] == cuda.launch_counts["detect_filter"] == n
        assert cuda.launch_counts["canonical_project"] == n
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
    assert cuda.launch_counts["canonical_project"] == n


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
