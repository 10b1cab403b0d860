"""The detection-tail kernel's arithmetic on the CPU.

The CUDA kernel (`csrc/detect_filter.cu`) runs only on the card, so this
file holds a torch emulation of its tiling: one block per (segment, 32x8
tile), the tile's conf plus a halo of radius + 1 read with clamped
coordinates, the vertical then the horizontal pass in ascending tap order
(one multiply, then one fused multiply-add a tap), ring pixels outside the
image taken from the wrapped pixel and blurred from the whole plane, and the
median by the kernel's own sorting network. The tile size and the network
are read from the CUDA source. The emulation is held bitwise to the CPU
path (`core.detection`, which the wrapper `detect_filter` takes for CPU
tensors) on depth, mask and confidence; on the card
`tests/test_torch_cuda.py` holds the kernel to the same CPU path.
"""
from __future__ import annotations

import itertools
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import detection as det
from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch, run_emvs, sweep_segment_batch
from repro_torch.events import aggregation as t_agg
from repro_torch.events import simulator as t_sim
from repro_torch.kernels import cuda
from repro_torch.kernels.detect_filter import ops as D
from repro_torch.kernels.local_max.ref import depth_argmax_ref
from repro_torch.launch import graph_analysis as ga

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
          / "detect_filter.cu").read_text()
TILE_W = int(re.search(r"constexpr int kTileW = (\d+);", SOURCE).group(1))
TILE_H = int(re.search(r"constexpr int kTileH = (\d+);", SOURCE).group(1))
NETWORK = [(int(a), int(b)) for a, b in re.findall(r"cmp_swap\(v\[(\d)\], v\[(\d)\]\)", SOURCE)]
INF = float("inf")

# (h, w): the two sensors, a small plane, one pixel, planes smaller than the halo
SHAPES = [(180, 240), (260, 346), (5, 7), (1, 1), (2, 3), (4, 6)]


def _mean(x: torch.Tensor, k: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """sum_j k[j] * x.narrow(dim, j, n), one multiply then fused multiply-adds."""
    out = x.narrow(dim, 0, n) * k[0]
    for j in range(1, k.shape[0]):
        out = torch.addcmul(out, x.narrow(dim, j, n), k[j])
    return out


def _sort9(v: list[torch.Tensor]) -> list[torch.Tensor]:
    v = list(v)
    for a, b in NETWORK:
        v[a], v[b] = torch.minimum(v[a], v[b]), torch.maximum(v[a], v[b])
    return v


def emulate(conf, zf, planes, taps, *, threshold_c, min_votes, median_filter):
    """The kernel's (depth, mask) for conf, zf (S, h, w), all blocks at once:
    tensors shaped (S, tiles_y, tiles_x, rows, cols) hold each block's
    shared-memory arrays. Also the local mean of each block's tile and ring,
    with the pixels they stand for (`blur[:, ys, xs]`)."""
    s, h, w = conf.shape
    nz = planes.shape[0]
    k = torch.tensor(taps, dtype=torch.float32)
    r = (len(taps) - 1) // 2
    eh, ew = TILE_H + 2, TILE_W + 2  # the tile and its ring
    ny, nx = math.ceil(h / TILE_H), math.ceil(w / TILE_W)
    y0 = torch.arange(ny) * TILE_H
    x0 = torch.arange(nx) * TILE_W

    def grid(rows, cols):  # per-block (rows, cols) -> broadcast (ny, nx, R, C)
        return rows[:, None, :, None], cols[None, :, None, :]

    # the window: conf at the clamped (y0 - 1 - r + wy, x0 - 1 - r + wx)
    wr = torch.clamp(y0[:, None] - 1 - r + torch.arange(eh + 2 * r), 0, h - 1)
    wc = torch.clamp(x0[:, None] - 1 - r + torch.arange(ew + 2 * r), 0, w - 1)
    win = conf[(slice(None), *grid(wr, wc))]
    vert = _mean(win, k, -2, eh)
    mean_in = _mean(vert, k, -1, ew)
    c_in = win[..., r:r + eh, r:r + ew]

    # the ring's coordinates wrap; a pixel outside the image is blurred whole
    uy = y0[:, None] - 1 + torch.arange(eh)
    ux = x0[:, None] - 1 + torch.arange(ew)
    in_y, in_x = grid((uy >= 0) & (uy < h), (ux >= 0) & (ux < w))
    inside = in_y & in_x
    yw, xw = grid(torch.remainder(uy, h), torch.remainder(ux, w))
    cols = []
    for i in range(2 * r + 1):
        xc = torch.clamp(xw + i - r, 0, w - 1)
        col = conf[:, torch.clamp(yw - r, 0, h - 1), xc] * k[0]
        for j in range(1, 2 * r + 1):
            col = torch.addcmul(col, conf[:, torch.clamp(yw + j - r, 0, h - 1), xc], k[j])
        cols.append(col)
    mean_out = _mean(torch.stack(cols, -1), k, -1, 1)[..., 0]
    mean = torch.where(inside, mean_in, mean_out)
    c = torch.where(inside, c_in, conf[:, yw, xw])
    mask_e = (c > mean + threshold_c) & (c >= min_votes)

    z = zf[:, yw, xw]
    zl = torch.clamp(torch.floor(z).to(torch.int64), 0, nz - 1)
    zh = torch.clamp(zl + 1, max=nz - 1)
    frac = z - zl.to(torch.float32)
    depth_e = torch.addcmul(planes[zl] * (1.0 - frac), planes[zh], frac)

    m = mask_e[..., 1:eh - 1, 1:ew - 1]
    d = depth_e[..., 1:eh - 1, 1:ew - 1]
    if median_filter:
        cands = [torch.where(mask_e[..., dy:dy + TILE_H, dx:dx + TILE_W],
                             depth_e[..., dy:dy + TILE_H, dx:dx + TILE_W], INF)
                 for dy in range(3) for dx in range(3)]
        count = sum((x < INF).to(torch.int64) for x in cands)
        ranked = torch.stack(_sort9(cands))
        mid = torch.clamp(torch.div(count - 1, 2, rounding_mode="floor"), min=0)
        med = torch.gather(ranked, 0, mid[None])[0]
        d = torch.where(m & (count > 0), med, d)

    def untile(x):  # (S, ny, nx, TH, TW) -> (S, h, w)
        return x.permute(0, 1, 3, 2, 4).reshape(s, ny * TILE_H, nx * TILE_W)[:, :h, :w]

    return untile(d), untile(m), (mean, yw, xw)


def _cpu_tail(conf, zf, planes, *, radius, median_filter, threshold_c, min_votes):
    kw = dict(threshold_c=threshold_c, min_votes=min_votes)
    if radius == det.ADAPTIVE_RADIUS:
        return det.detect_and_filter_from(conf, zf, planes, median_filter=median_filter, **kw)
    dm = det.detect_structure_from(conf, zf, planes, adaptive_radius=radius, **kw)
    return det._median_tail(dm, median_filter)


def _check(conf, zf, planes, *, radius, median_filter, threshold_c=6.0, min_votes=3.0):
    kw = dict(threshold_c=threshold_c, min_votes=min_votes)
    want = _cpu_tail(conf, zf, planes, radius=radius, median_filter=median_filter, **kw)
    taps = D._gaussian_taps(det.ADAPTIVE_SIGMA, radius)
    depth, mask, (mean, ys, xs) = emulate(conf, zf, planes, taps,
                                          median_filter=median_filter, **kw)
    blur = det.gaussian_blur(conf, det.ADAPTIVE_SIGMA, radius)
    assert torch.equal(mean.view(torch.int32), blur[:, ys, xs].view(torch.int32))
    assert torch.equal(mask, want.mask)
    assert torch.equal(depth.view(torch.int32), want.depth.view(torch.int32))
    assert torch.equal(want.confidence, conf)
    return want


def _random_inputs(seed: int, s: int, h: int, w: int, nz: int = 16):
    rng = np.random.default_rng(seed)
    # vote counts with a few tall peaks, so the threshold keeps some pixels
    conf = rng.poisson(2.0, (s, h, w)) + 40 * (rng.random((s, h, w)) < 0.05)
    conf = conf.astype(np.float32) + rng.choice([0.0, 0.25], (s, h, w)).astype(np.float32)
    # past both ends of the planes, to reach the clamps
    zf = rng.uniform(-1.5, nz + 0.5, (s, h, w)).astype(np.float32)
    planes = np.sort(rng.uniform(0.6, 4.5, nz)).astype(np.float32)
    return [torch.from_numpy(a) for a in (conf, zf, planes)]


def test_network_sorts_every_zero_one_input():
    """The source's comparators sort all 2^9 zero-one inputs, hence any nine
    values (the zero-one principle)."""
    assert len(NETWORK) == 25
    for bits in itertools.product((0, 1), repeat=9):
        v = list(bits)
        for a, b in NETWORK:
            v[a], v[b] = min(v[a], v[b]), max(v[a], v[b])
        assert v == sorted(bits), bits


@pytest.mark.parametrize("radius", [5, 2])
@pytest.mark.parametrize("median_filter", [True, False])
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("h,w", SHAPES)
def test_emulation_matches_cpu_path_random(h, w, s, median_filter, radius):
    conf, zf, planes = _random_inputs(h * 1000 + w * 10 + s, s, h, w)
    want = _check(conf, zf, planes, radius=radius, median_filter=median_filter)
    if h * w > 100:
        assert 0 < int(want.mask.sum()) < want.mask.numel()


@pytest.mark.parametrize("radius", [5, 2])
@pytest.mark.parametrize("median_filter", [True, False])
@pytest.mark.parametrize("h,w", [(180, 240), (5, 7)])
def test_the_wrapper_on_cpu_is_the_plain_tail(h, w, median_filter, radius):
    """`detect_filter` on CPU tensors takes `core.detection`'s plain tail:
    bitwise on depth, mask and confidence, with a leading batch, and no
    launch counted."""
    conf, zf, planes = _random_inputs(h * 7 + w + radius, 2, h, w)
    kw = dict(threshold_c=6.0, min_votes=3.0)
    before = dict(cuda.launch_counts)
    got = D.detect_filter(conf, zf, planes, median_filter=median_filter,
                          adaptive_radius=radius, **kw)
    assert dict(cuda.launch_counts) == before
    want = _cpu_tail(conf, zf, planes, radius=radius, median_filter=median_filter, **kw)
    assert isinstance(got, det.DepthMap)
    assert torch.equal(got.mask, want.mask)
    assert torch.equal(got.depth.view(torch.int32), want.depth.view(torch.int32))
    assert torch.equal(got.confidence, want.confidence)
    assert 0 < int(got.mask.sum()) < got.mask.numel()


@pytest.fixture(scope="module")
def sweep():
    """conf and zf of every key-frame segment of the pipeline tests' seeded
    sweep (`tests/test_torch_pipeline.py`'s frames, the port's nearest
    quantized kernel formulation on the CPU)."""
    cam = CameraModel()
    traj = t_sim.make_trajectory("simulation_3planes", 24, device="cpu")
    ev = t_sim.simulate_events(cam, t_sim.make_scene(t_sim.SceneConfig(points_per_plane=80)),
                               traj, device="cpu")
    frames = t_agg.aggregate(cam, ev, traj, events_per_frame=256,
                             pose_extrapolation="clamp", device="cpu")
    cfg = DSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5)
    opts = EMVSOptions(formulation="kernel", quantized=True, keyframe_dist_frac=0.05)
    res = run_emvs(cam, cfg, frames, opts, device="cpu")
    conf, zf = depth_argmax_ref(torch.stack([seg.dsi for seg in res.segments]))
    return conf, zf, cfg.planes(device="cpu")


@pytest.mark.parametrize("threshold_c,min_votes", [(6.0, 3.0), (1.0, 1.0)])
@pytest.mark.parametrize("radius", [5, 2])
@pytest.mark.parametrize("median_filter", [True, False])
@pytest.mark.parametrize("s", [1, 2, 3])
def test_emulation_matches_cpu_path_sweep(sweep, s, median_filter, radius, threshold_c,
                                          min_votes):
    """The sweep keeps few pixels at the default threshold (a small scene),
    so a low threshold is held too."""
    conf, zf, planes = sweep
    assert conf.shape[0] >= 3
    want = _check(conf[:s], zf[:s], planes, radius=radius, median_filter=median_filter,
                  threshold_c=threshold_c, min_votes=min_votes)
    if threshold_c < 6.0:
        assert int(want.mask.sum()) > 100


@pytest.mark.parametrize("formulation", ["kernel", "scatter"])
def test_meta_sweep_traces_the_tail_as_one_operation(formulation):
    """`sweep_segment_batch` on meta tensors: the DepthMap's shapes and
    dtypes come from the tail kernel's fake, one operation a bucket."""
    cam = CameraModel(width=32, height=24, cx=15.5, cy=11.5)
    cfg = DSIConfig.for_camera(cam, num_planes=8)
    opts = EMVSOptions(formulation=formulation, quantized=True)
    s, c, e = 3, 4, 16
    fm = ga.fake_mode()
    f32 = torch.float32
    with fm:
        batch = SegmentBatch(
            torch.empty((s, c, e, 2), device="meta"),
            torch.empty((s, c, e), dtype=torch.bool, device="meta"),
            torch.empty((s, c), dtype=torch.bool, device="meta"),
            torch.empty((s, c, 3, 3), dtype=f32, device="meta"),
            torch.empty((s, c, 3), dtype=f32, device="meta"),
            torch.empty((s, 3, 3), dtype=f32, device="meta"),
            torch.empty((s, 3), dtype=f32, device="meta"))
    (_, dm), _, mode = ga.analyze(lambda b: sweep_segment_batch(cam, cfg, b, opts), batch,
                                  fake=fm)
    assert dm.depth.shape == dm.mask.shape == dm.confidence.shape == (s, 24, 32)
    assert (dm.depth.dtype, dm.mask.dtype, dm.confidence.dtype) == (
        torch.float32, torch.bool, torch.float32)
    tails = [o for o in mode.ops if o.name == "repro_torch.detect_filter.default"]
    assert len(tails) == 1
    assert tails[0].outputs == (("float32", (s, 24, 32)), ("bool", (s, 24, 32)))
