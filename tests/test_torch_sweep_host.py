"""The sweep kernel's host logic (`repro_torch.kernels.backproject_vote.kernel`).

The CUDA kernel runs only on a card (tests/test_torch_cuda.py). What it
relies on from the host runs here: validity as a bool mask (the kernel
counts each valid vote as 1, so a float weight is refused, on the CPU path
too), the padding of each frame's events to the 16-byte bulk-copy granule
(zero weights, so the reference's DSI is unchanged, bitwise) and the
shared-memory plan of one CTA (a band of the plane's rows, event ring, phi
window, barriers) against the H100's opt-in limit.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.backproject_vote.ref import backproject_vote_ref as j_bpv_ref
from repro_torch.kernels.backproject_vote import kernel as K
from repro_torch.kernels.backproject_vote import ops
from repro_torch.kernels.backproject_vote.ref import (
    backproject_vote_detect_ref,
    backproject_vote_ref,
)

CX, CY, W, H = 16.0, 12.0, 40, 24
H100_SMEM_OPTIN = 232_448  # bytes of shared memory one block may opt into


def _inputs(seed: int, s: int, f: int, e: int, nz: int):
    rng = np.random.default_rng(seed)
    xy0 = rng.uniform((-5, -5), (W + 5, H + 5), (s, f, e, 2)).astype(np.float32)
    valid = (rng.random((s, f, e)) > 0.2).astype(np.float32)
    phi = np.concatenate([rng.uniform(0.7, 1.3, (s, f, nz, 1)),
                          rng.uniform(-4, 4, (s, f, nz, 2))], -1).astype(np.float32)
    return xy0, valid, phi


@pytest.mark.parametrize("e", [1, 3, 5, 7, 1023])
@pytest.mark.parametrize("quantized", [False, True])
def test_padded_events_vote_nothing(e, quantized):
    """Padding E to a multiple of 16 with invalid events leaves the plain
    version's DSI, conf and zf bitwise equal, and the reference's DSI."""
    xy0, valid, phi = _inputs(e, 2, 3, e, 6)
    x, y, v = (torch.from_numpy(a) for a in (xy0[..., 0], xy0[..., 1], valid > 0))
    xp, yp, vp = K.pad_events(x, y, v)
    ep = K.padded_events(e)
    assert ep % K.BULK_EVENTS == 0 and ep - e < K.BULK_EVENTS
    for t in (xp, yp, vp):
        assert t.shape == (2, 3, ep) and t.is_contiguous()
        assert t.data_ptr() % 16 == 0
    assert vp.dtype == torch.bool and not vp[..., e:].any()
    assert torch.equal(xp[..., :e], x) and torch.equal(vp[..., :e], v)
    kw = dict(cx=CX, cy=CY, w=W, h=H, quantized=quantized)
    phi_t = torch.from_numpy(phi)
    want = backproject_vote_detect_ref(torch.stack([x, y], -1), v, phi_t, **kw)
    got = backproject_vote_detect_ref(torch.stack([xp, yp], -1), vp, phi_t, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the padded plain vote of each segment equals the reference's unpadded one
    padded = torch.stack([xp, yp], -1)
    for s in range(2):
        want_j = j_bpv_ref(jnp.asarray(xy0[s]), jnp.asarray(valid[s]), jnp.asarray(phi[s]),
                           cx=CX, cy=CY, w=W, h=H, quantize_plane_coords=quantized)
        got_t = backproject_vote_ref(padded[s], vp[s], phi_t[s], cx=CX, cy=CY, w=W, h=H,
                                     quantize_plane_coords=quantized)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_j))

def test_pad_events_keeps_aligned_arrays():
    """E a multiple of 16 on an aligned, contiguous base: no copy."""
    x = torch.arange(2 * 3 * 16, dtype=torch.float32).reshape(2, 3, 16)
    (xp,) = K.pad_events(x)
    assert xp.data_ptr() == x.data_ptr()
    # views starting 4 bytes (float32) or 1 byte (a mask) into their
    # storage are copied to an aligned base
    view = torch.arange(1 + 48, dtype=torch.float32)[1:].reshape(1, 3, 16)
    mask = (torch.arange(1 + 48) % 3 == 0)[1:].reshape(1, 3, 16)
    vp, mp = K.pad_events(view, mask)
    assert vp.data_ptr() % 16 == 0 and torch.equal(vp, view)
    assert mp.data_ptr() % 16 == 0 and torch.equal(mp, mask)


@pytest.mark.parametrize("w,h,band_rows,n_bands", [(240, 180, 180, 1), (346, 260, 130, 2),
                                                     (400, 300, 100, 3), (64, 48, 48, 1)])
def test_shared_memory_plan(w, h, band_rows, n_bands):
    """One CTA holds a band of rows of the plane beside the 34.9 KB ring,
    the phi window and the barriers: 240x180 fits the H100's 232,448 B
    opt-in as one band, DAVIS346 takes two balanced bands, 400x300 three."""
    assert K.band_plan(w, h, H100_SMEM_OPTIN) == (band_rows, n_bands)
    assert (n_bands - 1) * band_rows < h <= n_bands * band_rows
    need = K.smem_bytes(w, band_rows)
    assert need == K.SMEM_FIXED_BYTES + 4 * w * band_rows + (-4 * w * band_rows) % 16
    assert K.check_shared_memory(w, h, H100_SMEM_OPTIN) == need <= H100_SMEM_OPTIN
    # one row more per band would not fit, or there is only one band
    assert n_bands == 1 or K.smem_bytes(w, -(-h // (n_bands - 1))) > H100_SMEM_OPTIN


@pytest.mark.parametrize("w,rows", [(40_000, 1), (23_820, 2), (47_640, 1)])
def test_band_plan_narrow_limits(w, rows):
    """Widths where only one or two rows fit beside the fixed part: every
    band holds that many rows, and the last one the rest."""
    band_rows, n_bands = K.band_plan(w, 5, H100_SMEM_OPTIN)
    assert band_rows <= rows and n_bands == -(-5 // band_rows)
    assert K.smem_bytes(w, rows) <= H100_SMEM_OPTIN < K.smem_bytes(w, rows + 1)


@pytest.mark.parametrize("w", [47_641, 100_000])
def test_band_plan_refuses_when_no_row_fits(w):
    with pytest.raises(ValueError, match="one row"):
        K.band_plan(w, 3, H100_SMEM_OPTIN)
    with pytest.raises(ValueError, match="shared memory"):
        K.check_shared_memory(w, 3, H100_SMEM_OPTIN)


def test_shared_memory_plan_numbers():
    assert K.SMEM_FIXED_BYTES == 41_888
    assert K.smem_bytes(240, 180) == 214_688 <= H100_SMEM_OPTIN


@pytest.mark.parametrize("weights", ["half", "float 1/0", "float64", "int32", "uint8"])
def test_op_refuses_non_bool_weights(weights):
    """The op takes validity as a bool mask on every device: a float weight
    (0.5 here, or 1/0 in another dtype) raises on the CPU path as well, so
    the card and the CPU never disagree on a fractional weight."""
    xy0, valid, phi = (torch.from_numpy(a) for a in _inputs(3, 1, 2, 16, 4))
    mask = valid > 0
    bad = {"half": mask.float() * 0.5, "float 1/0": mask.float(),
           "float64": mask.double(), "int32": mask.int(), "uint8": mask.to(torch.uint8)}
    with pytest.raises(ValueError, match="bool mask"):
        ops.backproject_vote_detect(xy0, bad[weights], phi, cx=CX, cy=CY, w=W, h=H)


@pytest.mark.parametrize("which", ["valid", "frame_valid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
def test_canonical_inputs_refuses_non_bool_masks(which, dtype):
    xy = torch.zeros((2, 8, 2))
    H3 = torch.eye(3).expand(2, 3, 3)
    phi = torch.zeros((2, 4, 3))
    masks = {"valid": torch.ones((2, 8), dtype=torch.bool),
             "frame_valid": torch.ones((2,), dtype=torch.bool)}
    masks[which] = masks[which].to(dtype)
    with pytest.raises(ValueError, match=f"{which} must be a bool mask"):
        ops.canonical_inputs(xy, masks["valid"], H3, phi, frame_valid=masks["frame_valid"])


def test_launcher_refuses_float_weights():
    """The CUDA launcher refuses a float weight by its dtype, before it
    looks at the device, and counts no launch."""
    xy0, valid, phi = (torch.from_numpy(a) for a in _inputs(4, 1, 2, 16, 4))
    before = dict(K.cuda.launch_counts)
    with pytest.raises(ValueError, match="bool mask"):
        K.backproject_vote_cuda(xy0[..., 0], xy0[..., 1], valid * 0.5, phi,
                                cx=CX, cy=CY, w=W, h=H)
    assert dict(K.cuda.launch_counts) == before


@pytest.mark.parametrize("frame_mask", [False, True])
def test_canonical_inputs_mask_is_the_reference_weights(frame_mask):
    """The bool mask `canonical_inputs` hands the kernels is nonzero exactly
    where the reference's 1/0 weights (valid * frame_valid) are."""
    rng = np.random.default_rng(6)
    valid = rng.random((2, 3, 8)) > 0.3
    fv = np.array([[1, 1, 0], [1, 0, 0]], np.float32)
    xy = torch.from_numpy(rng.uniform(0, 30, (2, 3, 8, 2)).astype(np.float32))
    H3 = torch.eye(3).expand(2, 3, 3, 3)
    phi = torch.zeros((2, 3, 4, 3))
    want = valid.astype(np.float32) * (fv[..., None] if frame_mask else 1.0)
    _, got, _ = ops.canonical_inputs(
        xy, torch.from_numpy(valid), H3, phi,
        frame_valid=torch.from_numpy(fv > 0) if frame_mask else None)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want != 0)
