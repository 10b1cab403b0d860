"""Launcher for the CUDA sweep kernel (`csrc/backproject_vote.cu`).

Replaces the vote-and-store part of
`repro.kernels.backproject_vote.kernel.backproject_vote_pallas`: one launch
votes every plane of every segment of a bucket. Takes CUDA tensors only
(meta tensors trace it: its output's shape and dtype, nothing launched),
and the events' validity as a bool mask.

The host logic the kernel relies on lives here and runs anywhere:
`check_mask` (validity is a bool mask, so every vote weighs 1 or 0),
`pad_events` (each frame's events to a multiple of 16, invalid, so
every bulk copy is 16-byte aligned and sized) and the shared-memory plan:
`band_plan` cuts the plane into row bands, one CTA each, so that a band's
accumulator fits beside the event ring, the phi window and the barriers
(`smem_bytes`, `check_shared_memory`). A DAVIS240 plane (240x180) is one
band; DAVIS346 (346x260) two of 130 rows.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

BULK_EVENTS = 16  # events whose validity bytes fill the 16 bytes a bulk copy is aligned to
STAGE_EVENTS = 1984  # events one ring stage holds: two per consumer thread
RING_STAGES = 2
PHI_FRAMES = 512  # frames of (alpha, beta_x, beta_y) staged at once
# the CTA's fixed shared memory: the ring's stages of x0 and y0 (float32)
# and valid (one byte), 2 x 1984 x 9 B, the phi window (512 x 12 B) and a
# full and an empty mbarrier per stage; kFixedBytes in the kernel
SMEM_FIXED_BYTES = RING_STAGES * (9 * STAGE_EVENTS + 2 * 8) + PHI_FRAMES * 3 * 4


def check_mask(what: str, mask: Tensor) -> None:
    """ValueError unless `mask` is a bool tensor. The kernel counts each
    valid nearest vote as 1, exact only for the reference's 0/1 masks; a
    float weight could be fractional, and is refused by its dtype."""
    if mask.dtype != torch.bool:
        raise ValueError(f"{what} must be a bool mask (votes weigh 1 or 0), "
                         f"got {mask.dtype}")


def padded_events(e: int) -> int:
    """Events per frame after padding to the bulk-copy granule."""
    return -(-e // BULK_EVENTS) * BULK_EVENTS


def pad_events(*arrays: Tensor) -> tuple[Tensor, ...]:
    """Each (S, F, E) array padded with zeros (False) along E to
    `padded_events(E)`, contiguous, on a 16-byte aligned base. An invalid
    event votes nothing, so the padded events change no vote."""
    out = []
    for t in arrays:
        e = t.shape[-1]
        if padded_events(e) != e:
            t = torch.nn.functional.pad(t, (0, padded_events(e) - e))
        t = t.contiguous()
        if t.data_ptr() % 16:
            t = t.clone()
        out.append(t)
    return tuple(out)


def smem_bytes(w: int, rows: int) -> int:
    """Dynamic shared memory one CTA takes for a band of `rows` rows of a
    w-wide plane (`backproject_vote_smem_bytes` in the kernel)."""
    return SMEM_FIXED_BYTES + -(-4 * w * rows // 16) * 16


def band_plan(w: int, h: int, limit: int) -> tuple[int, int]:
    """`(band_rows, n_bands)` for a w x h plane under `limit`, the bytes of
    shared memory a block may opt into on the device.

    The most rows whose accumulator fits beside the fixed part set the
    number of bands; the bands are then balanced, `ceil(h / n_bands)` rows
    each and the rest in the last. ValueError when not even one row fits."""
    max_rows = (limit - SMEM_FIXED_BYTES) // 16 * 16 // (4 * w)
    if max_rows < 1:
        raise ValueError(
            f"one row of a {w}-wide plane needs {smem_bytes(w, 1)} B of shared "
            f"memory per block ({4 * w} B of accumulator beside the "
            f"{SMEM_FIXED_BYTES} B event ring, phi window and barriers); this "
            f"device allows {limit} B")
    n_bands = -(-h // min(max_rows, h))
    return -(-h // n_bands), n_bands


def check_shared_memory(w: int, h: int, limit: int) -> int:
    """The shared memory one CTA of `band_plan(w, h, limit)` takes;
    ValueError when not even one row fits."""
    return smem_bytes(w, band_plan(w, h, limit)[0])


@functools.cache
def _library():
    lib = cuda.load("backproject_vote")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.backproject_vote_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                                            ctypes.c_float, ctypes.c_float, i, i, p]
    lib.backproject_vote_launch.restype = i
    lib.backproject_vote_smem_bytes.argtypes = [i, i]
    lib.backproject_vote_smem_bytes.restype = i
    return lib


def kernel_smem_bytes(w: int, rows: int) -> int:
    """The kernel's own count of `smem_bytes(w, rows)` (needs the built library)."""
    return _library().backproject_vote_smem_bytes(w, rows)


def backproject_vote_cuda(
    x0: Tensor,  # (S, F, E) canonical x
    y0: Tensor,  # (S, F, E)
    valid: Tensor,  # (S, F, E) bool
    phi: Tensor,  # (S, F, Nz, 3)
    *,
    cx: float,
    cy: float,
    w: int,
    h: int,
    mode: str = "nearest",
    quantized: bool = False,
    band_rows: int | None = None,
) -> Tensor:
    """Stored DSI (S, Nz, h, w): int16 when `quantized`, else float32.

    A valid event votes with weight 1: nearest votes are exact int32 counts,
    bilinear votes add float32 fractions. One CTA votes one band of rows of
    one plane of one segment; `band_rows` forces the band height (a test
    knob: by default `band_plan` picks the fewest bands that fit). A
    refused launch raises."""
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown voting mode: {mode}")
    check_mask("backproject_vote_cuda: valid", valid)
    for name, t in (("x0", x0), ("y0", y0), ("valid", valid), ("phi", phi)):
        want = torch.bool if name == "valid" else torch.float32
        if t.device.type not in ("cuda", "meta") or t.dtype != want:
            raise ValueError(f"backproject_vote_cuda: {name} must be a {want} "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if x0.dim() != 3 or y0.shape != x0.shape or valid.shape != x0.shape:
        raise ValueError("backproject_vote_cuda: x0, y0, valid must share one "
                         f"(S, F, E) shape, got {tuple(x0.shape)}, "
                         f"{tuple(y0.shape)}, {tuple(valid.shape)}")
    s, f, e = x0.shape
    if phi.dim() != 4 or phi.shape[:2] != (s, f) or phi.shape[3] != 3:
        raise ValueError(f"backproject_vote_cuda: phi must be (S, F, Nz, 3), "
                         f"got {tuple(phi.shape)}")
    return torch.ops.repro_torch.backproject_vote(
        x0, y0, valid, phi, float(cx), float(cy), int(w), int(h),
        mode == "bilinear", bool(quantized), band_rows)


# One PyTorch operation per launch: on a CUDA tensor it runs the body
# below (the launch), a fake tensor only its output's shape and dtype, so a
# dry run or a lint traces B1 as one operation without launching it.
@torch.library.custom_op("repro_torch::backproject_vote", mutates_args=())
def _backproject_vote_op(x0: Tensor, y0: Tensor, valid: Tensor, phi: Tensor,
                         cx: float, cy: float, w: int, h: int, bilinear: bool,
                         quantized: bool, band_rows: Optional[int]) -> Tensor:
    s, f, e = x0.shape
    nz = phi.shape[2]
    store = torch.int16 if quantized else torch.float32
    dsi = torch.empty((s, nz, h, w), dtype=store, device=x0.device)
    if dsi.numel() == 0:
        return dsi
    limit = torch.cuda.get_device_properties(x0.device).shared_memory_per_block_optin
    if band_rows is None:
        band_rows, _ = band_plan(w, h, limit)
    band_rows = min(band_rows, h)
    if band_rows < 1 or smem_bytes(w, band_rows) > limit:
        raise ValueError(f"backproject_vote_cuda: band_rows={band_rows} must be at "
                         f"least 1 and fit {limit} B of shared memory at width {w}")
    x0, y0, valid = pad_events(x0, y0, valid)
    phi = phi.contiguous()
    lib = _library()
    with torch.cuda.device(x0.device):
        err = lib.backproject_vote_launch(
            x0.data_ptr(), y0.data_ptr(), valid.data_ptr(), phi.data_ptr(),
            dsi.data_ptr(), s, f, x0.shape[-1], nz, w, h, band_rows, cx, cy,
            int(bilinear), int(quantized), cuda.current_stream(x0.device))
        cuda.check(err, "backproject_vote_launch")
        cuda.launch_counts["backproject_vote"] += 1
    return dsi


@_backproject_vote_op.register_fake
def _(x0, y0, valid, phi, cx, cy, w, h, bilinear, quantized, band_rows):
    return x0.new_empty((x0.shape[0], phi.shape[2], h, w),
                        dtype=torch.int16 if quantized else torch.float32)
