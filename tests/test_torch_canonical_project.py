"""The sweep's front-end kernel (`kernels/canonical_project`) off the card.

The kernel itself runs only on the card (`tests/test_torch_cuda.py` holds it
bitwise to the CPU path there). Here: the launcher's refusals, which raise
rather than fall back to the plain version; the wrapper's CPU path, bitwise
the eager chain (`precompute_batch_geometry`, then `canonical_inputs`); the
meta path's output shapes and dtypes, one traced operation a bucket and no
launch counted; and `sweep_segment_batch` on the CPU, bitwise the chain it
ran before the kernel existed (`precompute_batch_geometry`, then
`backproject_vote_frames`), with padded frames and parked events.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import detection
from repro_torch.core import pipeline as tp
from repro_torch.core.camera import CAMERAS, CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3, so3_exp
from repro_torch.events.aggregation import PARKED_COORD
from repro_torch.kernels import cuda
from repro_torch.kernels.backproject_vote.ops import backproject_vote_frames, canonical_inputs
from repro_torch.kernels.canonical_project.kernel import canonical_project_cuda
from repro_torch.kernels.canonical_project.ops import canonical_project
from repro_torch.launch import graph_analysis as ga


def _batch(seed: int, s: int, c: int, e: int, cam: CameraModel, device="cpu"
           ) -> tp.SegmentBatch:
    """Random poses near a key frame, events over the sensor, a few parked
    invalid events, and the last frames of all but the first segment padded
    (repeating the last real frame, as `pad_segments` does)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0.0, 0.05, (s, c, 3)).astype(np.float32))
    R = so3_exp(w)
    t = torch.from_numpy(rng.normal(0.0, 0.2, (s, c, 3)).astype(np.float32))
    xy = rng.uniform((-2.0, -2.0), (cam.width + 2.0, cam.height + 2.0),
                     (s, c, e, 2)).astype(np.float32)
    valid = rng.random((s, c, e)) > 0.1
    parked = rng.random((s, c, e)) < 0.05
    xy[parked] = PARKED_COORD
    valid[parked] = False
    n_real = np.array([c] + [int(rng.integers(1, c + 1)) for _ in range(s - 1)])
    fv = np.arange(c)[None, :] < n_real[:, None]
    idx = np.minimum(np.arange(c)[None, :], n_real[:, None] - 1)
    rows = np.arange(s)[:, None]
    xy, valid = xy[rows, idx], valid[rows, idx]
    R, t = R[torch.from_numpy(rows), torch.from_numpy(idx)], t[torch.from_numpy(rows),
                                                               torch.from_numpy(idx)]
    return tp.SegmentBatch(
        xy=torch.from_numpy(xy).to(device), valid=torch.from_numpy(valid).to(device),
        frame_valid=torch.from_numpy(fv).to(device), poses_R=R.contiguous().to(device),
        poses_t=t.contiguous().to(device), ref_R=R[:, 0].contiguous().to(device),
        ref_t=t[:, 0].contiguous().to(device))


def _inputs(device, s=2, c=3, e=16, nz=8):
    """The launcher's arguments as empty tensors on `device`."""
    f32, b = torch.float32, torch.bool
    planes = torch.empty((nz,), dtype=f32, device=device)
    return [torch.empty((s, c, e, 2), dtype=f32, device=device),
            torch.empty((s, c, e), dtype=b, device=device),
            torch.empty((s, c), dtype=b, device=device),
            torch.empty((s, c, 3, 3), dtype=f32, device=device),
            torch.empty((s, c, 3), dtype=f32, device=device),
            torch.empty((s, 3, 3), dtype=f32, device=device),
            torch.empty((s, 3), dtype=f32, device=device),
            planes, planes[nz // 2]]


def _call(args, quantized=True):
    cam = CameraModel()
    return canonical_project_cuda(*args, K=cam.K_values().ravel().tolist(),
                                  K_inv=cam.K_inv_values().ravel().tolist(),
                                  quantized=quantized)


NAMES = ("xy", "valid", "frame_valid", "poses_R", "poses_t", "ref_R", "ref_t", "planes", "z0")


@pytest.mark.parametrize("which", range(9))
def test_refuses_cpu_tensors(which):
    """A CPU tensor anywhere is refused: the wrapper sends CPU buckets to the
    plain version, never a silent fallback here."""
    args = _inputs("meta")
    args[which] = _inputs("cpu")[which]
    with pytest.raises(ValueError, match=f"needs CUDA tensors, got {NAMES[which]} on cpu"):
        _call(args)


@pytest.mark.parametrize("which,dtype", [(0, torch.float64), (3, torch.float64),
                                         (4, torch.float16), (5, torch.float64),
                                         (6, torch.bfloat16), (7, torch.float64),
                                         (8, torch.float64)])
def test_refuses_wrong_float_dtypes(which, dtype):
    args = _inputs("meta")
    args[which] = args[which].to(dtype)
    with pytest.raises(TypeError, match=f"{NAMES[which]} must be torch.float32"):
        _call(args)


@pytest.mark.parametrize("which", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_refuses_masks_that_are_not_bool(which, dtype):
    """Validity is a bool mask (a vote weighs 1 or 0), as for B1."""
    args = _inputs("meta")
    args[which] = args[which].to(dtype)
    with pytest.raises(ValueError, match="bool mask"):
        _call(args)


@pytest.mark.parametrize("which", [0, 1, 3, 4, 5])
def test_refuses_non_contiguous(which):
    args = _inputs("meta")
    t = args[which]
    args[which] = torch.empty(tuple(reversed(t.shape)), dtype=t.dtype,
                              device="meta").permute(*reversed(range(t.dim())))
    assert args[which].shape == t.shape and not args[which].is_contiguous()
    with pytest.raises(ValueError, match=f"{NAMES[which]} must be contiguous"):
        _call(args)


@pytest.mark.parametrize("which,shape", [(1, (2, 3, 15)), (2, (2, 4)), (3, (2, 3, 3, 4)),
                                         (5, (1, 3, 3)), (6, (2, 4))])
def test_refuses_mismatched_shapes(which, shape):
    args = _inputs("meta")
    args[which] = torch.empty(shape, dtype=args[which].dtype, device="meta")
    with pytest.raises(ValueError, match=NAMES[which]):
        _call(args)


def test_refuses_intrinsics_of_the_wrong_length():
    with pytest.raises(ValueError, match="nine values"):
        canonical_project_cuda(*_inputs("meta"), K=[1.0] * 8, K_inv=[1.0] * 9,
                               quantized=False)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _eager_chain(cam, batch, planes, z0, quantized):
    """The front end as the pipeline composed it before the kernel."""
    geoms = tp.precompute_batch_geometry(cam, batch.poses_R, batch.poses_t,
                                         SE3(batch.ref_R[:, None], batch.ref_t[:, None]),
                                         planes, z0)
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], dim=-1)
    return canonical_inputs(batch.xy, batch.valid, geoms.H, phi, quantized=quantized,
                            frame_valid=batch.frame_valid)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("camera", ["davis240", "davis346"])
def test_the_wrapper_on_cpu_is_the_eager_chain(camera, quantized):
    """`canonical_project` on CPU tensors takes the plain version: bitwise
    the eager chain on xy0, valid and phi, with padded frames and parked
    events, and no launch counted."""
    cam = CAMERAS[camera]
    batch = _batch(11, 3, 5, 48, cam)
    assert not bool(batch.frame_valid.all())
    planes = DSIConfig.for_camera(cam, num_planes=16, z_min=0.6, z_max=4.5).planes(
        device="cpu")
    before = dict(cuda.launch_counts)
    got = canonical_project(cam, batch, planes, planes[8], quantized=quantized)
    assert dict(cuda.launch_counts) == before
    want = _eager_chain(cam, batch, planes, planes[8], quantized)
    for name, a, b in zip(("xy0", "valid", "phi"), got, want):
        assert a.device.type == "cpu" and a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(_bits(a), _bits(b)), name
    assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("s,c,e,nz", [(1, 1, 1, 1), (2, 40, 1024, 128), (3, 80, 37, 5)])
def test_meta_path_gives_the_outputs_shapes(s, c, e, nz, quantized):
    """On meta tensors the operation returns the kernel's output shapes and
    dtypes and launches nothing."""
    before = dict(cuda.launch_counts)
    xy0, valid, phi = _call(_inputs("meta", s, c, e, nz), quantized)
    assert (xy0.device.type, valid.device.type, phi.device.type) == ("meta",) * 3
    assert (tuple(xy0.shape), xy0.dtype) == ((s, c, e, 2), torch.float32)
    assert (tuple(valid.shape), valid.dtype) == ((s, c, e), torch.bool)
    assert (tuple(phi.shape), phi.dtype) == ((s, c, nz, 3), torch.float32)
    assert dict(cuda.launch_counts) == before


@pytest.mark.parametrize("quantized", [False, True])
def test_meta_sweep_traces_the_front_end_as_one_operation(quantized):
    """`sweep_segment_batch` on meta tensors: the front end is one operation
    a bucket, whose outputs B1 reads, and no eager geometry runs beside it."""
    cam = CameraModel(width=32, height=24, cx=15.5, cy=11.5)
    cfg = DSIConfig.for_camera(cam, num_planes=8)
    opts = tp.EMVSOptions(formulation="kernel", quantized=quantized)
    s, c, e = 3, 4, 16
    fm = ga.fake_mode()
    with fm:
        batch = tp.SegmentBatch(*_inputs("meta", s, c, e)[:7])
    _, _, mode = ga.analyze(lambda b: tp.sweep_segment_batch(cam, cfg, b, opts), batch,
                            fake=fm)
    fronts = [o for o in mode.ops if o.name == "repro_torch.canonical_project.default"]
    assert len(fronts) == 1
    assert fronts[0].outputs == (("float32", (s, c, e, 2)), ("bool", (s, c, e)),
                                 ("float32", (s, c, 8, 3)))
    assert not [o for o in mode.ops if o.name in ("aten.addcmul.default", "aten.floor.default")]


@pytest.mark.parametrize("voting", ["nearest", "bilinear"])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("camera", ["davis240", "davis346"])
def test_cpu_sweep_keeps_the_eager_front_end(camera, quantized, voting):
    """On the CPU the kernel formulation's sweep is bitwise the chain it ran
    before the kernel: the batch geometry, then `backproject_vote_frames`
    (Table 1, the homography, the frame mask, B1's and B2's plain versions),
    then the detection tail."""
    cam = CAMERAS[camera]
    cfg = DSIConfig.for_camera(cam, num_planes=8, z_min=0.6, z_max=4.5)
    opts = tp.EMVSOptions(formulation="kernel", quantized=quantized, voting=voting)
    batch = _batch(7, 2, 6, 64, cam)
    dsi, dm = tp.sweep_segment_batch(cam, cfg, batch, opts)

    planes = cfg.planes(device="cpu")
    z0 = planes[cfg.num_planes // 2]
    geoms = tp.precompute_batch_geometry(cam, batch.poses_R, batch.poses_t,
                                         SE3(batch.ref_R[:, None], batch.ref_t[:, None]),
                                         planes, z0)
    phi = torch.stack([geoms.phi.alpha, geoms.phi.beta_x, geoms.phi.beta_y], dim=-1)
    want, conf, zf = backproject_vote_frames(
        batch.xy, batch.valid, geoms.H, phi, cam=cam, dsi_cfg=cfg, mode=voting,
        quantized=quantized, frame_valid=batch.frame_valid)
    if quantized:
        want = tp.dsi_lib.from_storage(want)
    want_dm = detection.detect_and_filter_from(conf, zf, planes)
    assert dsi.dtype == want.dtype and torch.equal(dsi, want)
    assert int((dsi != 0).sum()) > 0
    assert torch.equal(dm.depth.view(torch.int32), want_dm.depth.view(torch.int32))
    assert torch.equal(dm.mask, want_dm.mask)
    assert torch.equal(dm.confidence, want_dm.confidence)
