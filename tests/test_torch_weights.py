"""Vote weights in the port's `SegmentBatch`: bool masks, or float weights
voted as given.

The reference carries `valid` and `frame_valid` as float32 fields and its
scatter and matmul formulations vote a fractional weight as it is. The
port carries 1/0 masks as bool (`pad_segments`, `process_segment`,
`interop.segment_batch_from_numpy` for exact 1/0 inputs) and any other
weights as float32. Its scatter and matmul formulations then give the
reference's DSI bitwise; its kernel formulation counts a valid event as 1
and refuses float weights with a ValueError rather than rounding them up
to whole votes.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.camera import CameraModel as JCamera
from repro.core.dsi import DSIConfig as JDSIConfig
from repro.core.pipeline import EMVSOptions as JOptions
from repro.core.pipeline import SegmentBatch as JBatch
from repro.core.pipeline import process_segments_batched as j_sweep
from repro_torch import interop
from repro_torch.core import pipeline as tp
from repro_torch.events.aggregation import EventFrames
from repro_torch.core.geometry import SE3

CAM = JCamera(width=32, height=24, fx=30.0, fy=30.0, cx=16.0, cy=12.0)
CFG = JDSIConfig.for_camera(CAM, num_planes=8, z_min=0.6, z_max=4.5)
S, C, E = 1, 4, 64


def _batch(weight: float) -> tuple[np.ndarray, ...]:
    """S=1, C=4 frames of E=64 events on a 32x24 sensor, every event of
    weight `weight`, the last frame slot padding, the camera translating
    sideways from the reference pose."""
    rng = np.random.default_rng(11)
    xy = rng.uniform((0, 0), (CAM.width - 1, CAM.height - 1), (S, C, E, 2)).astype(np.float32)
    valid = np.full((S, C, E), weight, np.float32)
    frame_valid = np.array([[1, 1, 1, 0]], np.float32)
    poses_R = np.tile(np.eye(3, dtype=np.float32), (S, C, 1, 1))
    poses_t = np.zeros((S, C, 3), np.float32)
    poses_t[..., 0] = np.linspace(0.0, 0.06, C, dtype=np.float32)
    ref_R = np.tile(np.eye(3, dtype=np.float32), (S, 1, 1))
    ref_t = np.zeros((S, 3), np.float32)
    return xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t


def _port(fields, formulation: str, quantized: bool):
    batch = interop.segment_batch_from_numpy(*fields, device="cpu")
    cam = interop.camera_from_dict(dataclasses.asdict(CAM))
    cfg = interop.dsi_config_from_dict(dataclasses.asdict(CFG))
    return tp.process_segments_batched(
        cam, cfg, batch, tp.EMVSOptions(formulation=formulation, quantized=quantized))


@pytest.mark.parametrize("weight", [0.5, 0.7, 0.3, 1.0])
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("formulation", ["scatter", "matmul"])
def test_fractional_weights_vote_as_the_reference(weight, quantized, formulation):
    """Scatter and matmul vote float weights as given: the DSI, depth and
    mask equal the reference's bitwise (tolerance 0)."""
    fields = _batch(weight)
    dsi_r, dm_r = j_sweep(CAM, CFG, JBatch(*(jnp.asarray(a) for a in fields)),
                          JOptions(formulation=formulation, quantized=quantized))
    dsi_g, dm_g = _port(fields, formulation, quantized)
    assert int(np.asarray(dsi_r).astype(np.int64).sum()) == int(dsi_g.sum())
    np.testing.assert_array_equal(np.asarray(dsi_r), dsi_g.numpy())
    np.testing.assert_array_equal(np.asarray(dm_r.depth), dm_g.depth.numpy())
    np.testing.assert_array_equal(np.asarray(dm_r.mask), dm_g.mask.numpy())


@pytest.mark.parametrize("weight", [0.5, 0.7, 0.3])
@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_formulation_refuses_fractional_weights(weight, quantized):
    """The kernel counts each valid event as 1: fed fractional weights it
    raises instead of returning the whole-vote DSI."""
    with pytest.raises(ValueError, match="bool mask"):
        _port(_batch(weight), "kernel", quantized)


def test_kernel_formulation_counts_whole_votes():
    """At weight 1 the batch arrives as bool masks and the kernel
    formulation equals the reference's kernel formulation's sum."""
    fields = _batch(1.0)
    dsi_g, _ = _port(fields, "kernel", False)
    dsi_m, _ = _port(fields, "matmul", False)
    np.testing.assert_array_equal(dsi_g.numpy(), dsi_m.numpy().astype(np.float32))


@pytest.mark.parametrize("weight", [1.0, 0.5])
def test_segment_batch_from_numpy_masks(weight):
    """1/0 fields become bool masks, checked on numpy; anything else stays
    float32 weights, value for value."""
    fields = _batch(weight)
    batch = interop.segment_batch_from_numpy(*fields, device="cpu")
    assert batch.frame_valid.dtype == torch.bool
    np.testing.assert_array_equal(batch.frame_valid.numpy(), fields[2] != 0)
    if weight == 1.0:
        assert batch.valid.dtype == torch.bool
        assert bool(batch.valid.all())
    else:
        assert batch.valid.dtype == torch.float32
        np.testing.assert_array_equal(batch.valid.numpy(), fields[1])
    nan = interop.segment_batch_from_numpy(
        *fields[:1], np.where(fields[1] > 0, np.nan, 0).astype(np.float32), *fields[2:],
        device="cpu")
    assert nan.valid.dtype == torch.float32


@pytest.mark.parametrize("mask", [True, False])
def test_pad_segments_and_process_segment_carry_masks(mask):
    """Bool event masks stay bool through `pad_segments` and
    `process_segment`, with bool frame masks; float weights stay float32."""
    rng = np.random.default_rng(3)
    valid = rng.random((6, E)) > 0.3
    frames = EventFrames(
        xy=torch.from_numpy(rng.uniform(0, 20, (6, E, 2)).astype(np.float32)),
        valid=torch.from_numpy(valid if mask else valid * np.float32(0.5)),
        t_mid=torch.arange(6, dtype=torch.float32),
        poses=SE3(torch.eye(3).expand(6, 3, 3), torch.zeros(6, 3)))
    batch = tp.pad_segments(frames, [(0, 3), (3, 5)], 4)
    assert batch.frame_valid.dtype == torch.bool
    np.testing.assert_array_equal(batch.frame_valid.numpy(),
                                  [[1, 1, 1, 0], [1, 1, 0, 0]])
    assert batch.valid.dtype == (torch.bool if mask else torch.float32)
    np.testing.assert_array_equal(batch.valid[1, 3].numpy(), frames.valid[4].numpy())
    # process_segment builds the same one-segment batch; its kernel
    # formulation runs on the bool masks and refuses the float weights
    cam = interop.camera_from_dict(dataclasses.asdict(CAM))
    cfg = interop.dsi_config_from_dict(dataclasses.asdict(CFG))
    opts = tp.EMVSOptions(formulation="kernel")
    ref = SE3(frames.poses.R[0], frames.poses.t[0])
    if mask:
        dsi, _ = tp.process_segment(cam, cfg, frames, ref, opts)
        dsi_m, _ = tp.process_segment(cam, cfg, frames, ref,
                                      dataclasses.replace(opts, formulation="matmul"))
        np.testing.assert_array_equal(dsi.numpy(), dsi_m.numpy().astype(np.float32))
    else:
        with pytest.raises(ValueError, match="bool mask"):
            tp.process_segment(cam, cfg, frames, ref, opts)
