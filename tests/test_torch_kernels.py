"""The port's kernel modules against the JAX reference, and their rules.

On the CPU each wrapper takes its plain version; the same numpy inputs go
through the reference's oracle (`backproject_vote_ref` + `depth_argmax_ref`)
and, for one small case, through the reference's Pallas kernel in interpret
mode. Nearest voting is held bitwise (integer vote counts are exact in any
order); bilinear to float tolerance (the einsum's summation order differs
between XLA and PyTorch). The CUDA kernels themselves run only on a card:
see tests/test_torch_cuda.py.
"""
from __future__ import annotations

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.dsi import storage_roundtrip as j_storage_roundtrip
from repro.kernels.backproject_vote import ops as j_ops
from repro.kernels.backproject_vote.kernel import backproject_vote_pallas
from repro.kernels.backproject_vote.ref import backproject_vote_ref as j_bpv_ref
from repro.kernels.local_max.ref import depth_argmax_ref as j_argmax_ref
from repro_torch import interop
from repro_torch.kernels import cuda
from repro_torch.kernels.backproject_vote import ops as t_ops
from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda
from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
from repro_torch.kernels.local_max.ops import depth_argmax

CX, CY, W, H = 16.0, 12.0, 40, 24
# bilinear: XLA's einsum and torch.bmm sum fractional votes in another order
BILINEAR_ATOL, BILINEAR_RTOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is as fast and leaves the other
    cores to the test workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed: int, F: int, E: int, NZ: int, w: int = W, h: int = H):
    rng = np.random.default_rng(seed)
    xy0 = rng.uniform((-5, -5), (w + 5, h + 5), (F, E, 2)).astype(np.float32)
    valid = (rng.random((F, E)) > 0.2).astype(np.float32)
    alpha = rng.uniform(0.7, 1.3, (F, NZ, 1)).astype(np.float32)
    beta = rng.uniform(-4, 4, (F, NZ, 2)).astype(np.float32)
    return xy0, valid, np.concatenate([alpha, beta], axis=-1)


def _boundary_inputs(F: int = 4, NZ: int = 8):
    """Events on w-1/h-1, half-integers, non-finite coords; frame 3 padded."""
    specials = np.array([
        [W - 1.0, H - 1.0], [W - 1.0, 0.0], [0.0, H - 1.0], [W - 0.5, H - 0.5],
        [W - 1.5, H - 1.5], [0.5, 0.5], [-0.5, -0.5], [-0.51, 7.0], [0.49, 0.51],
        [W + 100.0, 3.0], [3.0, H + 100.0], [7.25, 7.75], [W - 1.25, H - 1.75],
        [13.5, 2.5], [2.5, 13.5], [0.0, 0.0], [np.nan, 5.0], [5.0, np.inf],
        [-np.inf, 5.0], [255.5, 3.0],
    ], dtype=np.float32)
    xy0 = np.tile(specials[None], (F, 1, 1))
    valid = np.ones(xy0.shape[:-1], np.float32)
    valid[3] = 0.0
    phi = np.concatenate([np.ones((F, NZ, 1)), np.zeros((F, NZ, 2))], -1).astype(np.float32)
    return xy0, valid, phi


def _reference(xy0, valid, phi, mode: str, quantized: bool):
    """Reference fused datapath: vote (oracle), int16 store, reduction."""
    dsi = j_bpv_ref(jnp.asarray(xy0), jnp.asarray(valid), jnp.asarray(phi),
                    cx=CX, cy=CY, w=W, h=H, mode=mode,
                    quantize_plane_coords=quantized and mode == "nearest")
    if quantized:
        dsi = j_storage_roundtrip(dsi).astype(jnp.int16)
    conf, zf = j_argmax_ref(dsi)
    return np.asarray(dsi), np.asarray(conf), np.asarray(zf)


def _port(xy0, valid, phi, mode: str, quantized: bool):
    """The port's op; it takes the 1/0 validity as a bool mask."""
    dsi, conf, zf = t_ops.backproject_vote_detect(
        torch.from_numpy(xy0), torch.from_numpy(valid).bool(), torch.from_numpy(phi),
        cx=CX, cy=CY, w=W, h=H, mode=mode, quantized=quantized)
    return dsi.numpy(), conf.numpy(), zf.numpy()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("case", ["random", "boundary"])
def test_backproject_vote_detect_nearest_bitwise(case, quantized):
    args = _inputs(11, 4, 256, 16) if case == "random" else _boundary_inputs()
    ref = _reference(*args, "nearest", quantized)
    got = _port(*args, "nearest", quantized)
    for r, g, what in zip(ref, got, ("dsi", "conf", "zf")):
        assert r.dtype == g.dtype, (what, r.dtype, g.dtype)
        np.testing.assert_array_equal(r, g, err_msg=what)


@pytest.mark.parametrize("quantized", [False, True])
def test_backproject_vote_detect_bilinear_close(quantized):
    xy0, valid, phi = _inputs(12, 4, 256, 16)
    dsi_r, _, _ = _reference(xy0, valid, phi, "bilinear", quantized)
    dsi_g, conf_g, zf_g = _port(xy0, valid, phi, "bilinear", quantized)
    assert dsi_r.dtype == dsi_g.dtype
    np.testing.assert_allclose(dsi_g.astype(np.float32), dsi_r.astype(np.float32),
                               atol=BILINEAR_ATOL, rtol=BILINEAR_RTOL)
    # the reduction of the port's own stored DSI matches the reference's
    conf_r, zf_r = j_argmax_ref(jnp.asarray(dsi_g))
    np.testing.assert_array_equal(np.asarray(conf_r), conf_g)
    np.testing.assert_array_equal(np.asarray(zf_r), zf_g)


@pytest.mark.parametrize("quantized", [False, True])
def test_backproject_vote_frames_bitwise(quantized):
    """The full frame datapath (homography, Table-1 quantization, frame
    mask) on a DAVIS240 camera, against the reference's wrapper run with
    the Pallas kernel in interpret mode."""
    cam = JCamera()
    cfg = JDSIConfig.for_camera(cam, num_planes=8, z_min=0.6, z_max=4.5)
    rng = np.random.default_rng(13)
    F, E, NZ = 4, 256, 8
    xy = rng.uniform(-5, 245, (F, E, 2)).astype(np.float32)
    valid = rng.random((F, E)) > 0.1
    H3 = np.eye(3, dtype=np.float32) + rng.normal(size=(F, 3, 3)).astype(np.float32) * 0.01
    phi = np.concatenate([rng.uniform(0.8, 1.2, (F, NZ, 1)),
                          rng.uniform(-5, 5, (F, NZ, 2))], -1).astype(np.float32)
    fv = np.array([1, 1, 1, 0], np.float32)
    ref = j_ops.backproject_vote_frames(
        jnp.asarray(xy), jnp.asarray(valid), jnp.asarray(H3), jnp.asarray(phi),
        cam=cam, dsi_cfg=cfg, mode="nearest", quantized=quantized,
        frame_valid=jnp.asarray(fv), interpret=True)
    got = t_ops.backproject_vote_frames(
        torch.from_numpy(xy), torch.from_numpy(valid), torch.from_numpy(H3),
        torch.from_numpy(phi), cam=interop.camera_from_dict(dataclasses.asdict(cam)),
        dsi_cfg=interop.dsi_config_from_dict(dataclasses.asdict(cfg)),
        mode="nearest", quantized=quantized, frame_valid=torch.from_numpy(fv).bool())
    for r, g, what in zip(ref, got, ("dsi", "conf", "zf")):
        r = np.asarray(r)
        # the reference kernel stores float32 when not quantized, int16 when quantized
        assert r.dtype == g.numpy().dtype, (what, r.dtype, g.dtype)
        np.testing.assert_array_equal(r, g.numpy(), err_msg=what)


def test_backproject_vote_batched_segments_match_single():
    """A bucket (S, F, E) gives each segment what its own call gives."""
    segs = [(xy0, valid > 0, phi) for xy0, valid, phi in
            (_inputs(20 + k, 3, 128, 8) for k in range(3))]
    batched = t_ops.backproject_vote_detect(
        *(torch.from_numpy(np.stack([s[i] for s in segs])) for i in range(3)),
        cx=CX, cy=CY, w=W, h=H, quantized=True)
    for k, seg in enumerate(segs):
        single = t_ops.backproject_vote_detect(
            *(torch.from_numpy(a) for a in seg), cx=CX, cy=CY, w=W, h=H, quantized=True)
        for b, s in zip(batched, single):
            assert torch.equal(b[k], s)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int32])
def test_depth_argmax_bitwise(dtype):
    rng = np.random.default_rng(14)
    dsi = rng.integers(0, 50, (16, 24, 40)).astype(dtype)
    dsi[:, 0, 0] = 0  # all-zero column: argmax 0, parabola edge
    dsi[:, 1, 1] = 7  # plateau: first max wins
    if dtype == np.float32:
        dsi = dsi + rng.uniform(0, 1, dsi.shape).astype(np.float32)
    conf_r, zf_r = j_argmax_ref(jnp.asarray(dsi))
    conf_t, zf_t = depth_argmax(torch.from_numpy(dsi))
    np.testing.assert_array_equal(np.asarray(conf_r), conf_t.numpy())
    np.testing.assert_array_equal(np.asarray(zf_r), zf_t.numpy())


@pytest.mark.parametrize("quantized", [False, True])
def test_vs_reference_pallas_kernel_interpret(quantized):
    """One small case against the reference's Pallas kernel itself, run by
    its interpreter on the CPU (padded outputs cropped to w, h)."""
    xy0, valid, phi = _inputs(15, 2, 128, 8)
    dsi_k, conf_k, zf_k = backproject_vote_pallas(
        jnp.asarray(xy0[..., 0]), jnp.asarray(xy0[..., 1]), jnp.asarray(valid),
        jnp.asarray(phi), cx=CX, cy=CY, w=W, h=H, block_z=4, mode="nearest",
        quantized=quantized, onehot_dtype=jnp.float32, interpret=True)
    got = _port(xy0, valid, phi, "nearest", quantized)
    for r, g in zip((dsi_k[:, :H, :W], conf_k[:H, :W], zf_k[:H, :W]), got):
        np.testing.assert_array_equal(np.asarray(r), g)


def test_wrappers_raise_on_other_devices():
    x = torch.zeros((1, 2, 4, 2), device="meta")
    with pytest.raises(ValueError, match="no path"):
        t_ops.backproject_vote_detect(x, x[..., 0], torch.zeros((1, 2, 8, 3), device="meta"),
                                      cx=CX, cy=CY, w=W, h=H)
    with pytest.raises(ValueError, match="no path"):
        depth_argmax(torch.zeros((8, 4, 4), device="meta"))


def test_launchers_raise_without_cuda_and_never_fall_back():
    """Below the wrappers, the launchers take CUDA tensors only: given CPU
    tensors (or on a machine with no card or nvcc) they raise, they never
    return the plain version's result, and nothing counts as a launch."""
    xy0, valid, phi = (torch.from_numpy(a)[None] for a in _inputs(16, 2, 64, 8))
    before = dict(cuda.launch_counts)
    with pytest.raises((ValueError, RuntimeError)):
        backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid, phi,
                              cx=CX, cy=CY, w=W, h=H)
    with pytest.raises((ValueError, RuntimeError)):
        depth_argmax_cuda(torch.zeros((1, 8, 4, 4)))
    assert dict(cuda.launch_counts) == before
    if not os.path.exists(cuda.NVCC_DEFAULT) and shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda.load("backproject_vote")
