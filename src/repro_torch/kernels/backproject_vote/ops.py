"""Public wrappers for the fused back-projection + vote + store + detect.

Counterpart of `repro.kernels.backproject_vote.ops`. The tensor's device
picks the path: a CPU tensor takes the plain version (`ref.py`), a CUDA
tensor launches the sweep kernel and then the depth max/argmax kernel over
the stored DSI, a meta tensor traces that path (the kernels' output
shapes and dtypes; nothing runs), any other device raises. Every wrapper accepts one frame
batch (F, E, ...) or a bucket of segments (S, F, E, ...); on CUDA a bucket
is one launch of each kernel. Validity is a bool mask on every device (the
reference's masks are exact 0/1; the kernel counts each valid vote as 1),
so a fractional weight is refused, never rounded.
"""
from __future__ import annotations

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import apply_homography
from repro_torch.kernels.backproject_vote.kernel import backproject_vote_cuda, check_mask
from repro_torch.kernels.backproject_vote.ref import backproject_vote_detect_ref
from repro_torch.kernels.local_max.kernel import depth_argmax_cuda
from repro_torch.quant.fixed_point import Q11_21, quantize_roundtrip
from repro_torch.quant.policies import TABLE1

Tensor = torch.Tensor


def backproject_vote_detect(
    xy0: Tensor,  # (..., F, E, 2) canonical coords
    valid: Tensor,  # (..., F, E) bool
    phi: Tensor,  # (..., F, Nz, 3)
    *,
    cx: float,
    cy: float,
    w: int,
    h: int,
    mode: str = "nearest",
    quantized: bool = False,
) -> tuple[Tensor, Tensor, Tensor]:
    """`(dsi, conf, zf)`: the stored DSI (..., Nz, h, w), int16 when
    `quantized` else float32, and the depth-axis max and parabola-refined
    argmax (..., h, w) of the STORED values."""
    if xy0.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"backproject_vote_detect: no path for device {xy0.device}")
    check_mask("backproject_vote_detect: valid", valid)
    if xy0.device.type == "cpu":
        return backproject_vote_detect_ref(xy0, valid, phi, cx=cx, cy=cy, w=w, h=h,
                                           mode=mode, quantized=quantized)
    lead = xy0.shape[:-3]
    f, e = xy0.shape[-3:-1]
    nz = phi.shape[-2]
    xy0 = xy0.to(torch.float32).reshape(-1, f, e, 2)
    dsi = backproject_vote_cuda(
        xy0[..., 0], xy0[..., 1], valid.reshape(-1, f, e),
        phi.to(torch.float32).reshape(-1, f, nz, 3),
        cx=cx, cy=cy, w=w, h=h, mode=mode, quantized=quantized)
    conf, zf = depth_argmax_cuda(dsi)
    return (dsi.reshape(*lead, nz, h, w), conf.reshape(*lead, h, w),
            zf.reshape(*lead, h, w))


def canonical_inputs(
    xy: Tensor, valid: Tensor, H: Tensor, phi: Tensor, *, quantized: bool = False,
    frame_valid: Tensor | None = None,
) -> tuple[Tensor, Tensor, Tensor]:
    """The kernels' inputs `(xy0, valid, phi)` from raw event coords: the
    homography, the frame mask and, under `quantized`, Table 1 for the
    events, H, phi (Q11.21) and the canonical coords. `valid` and
    `frame_valid` are bool masks."""
    check_mask("canonical_inputs: valid", valid)
    if frame_valid is not None:
        check_mask("canonical_inputs: frame_valid", frame_valid)
        valid = valid & frame_valid[..., None]
    if quantized:
        xy = TABLE1.quantize_events(xy)
        H = TABLE1.quantize_homography(H)
        phi = quantize_roundtrip(phi, Q11_21)  # alpha/beta share the phi format
    xy0 = apply_homography(H, xy)
    if quantized:
        xy0 = TABLE1.quantize_canonical(xy0)
    return xy0, valid, phi


def backproject_vote_frames(
    xy: Tensor,  # (..., F, E, 2) rectified raw event coords
    valid: Tensor,  # (..., F, E) bool
    H: Tensor,  # (..., F, 3, 3)
    phi: Tensor,  # (..., F, Nz, 3)
    *,
    cam: CameraModel,
    dsi_cfg: DSIConfig,
    mode: str = "nearest",
    quantized: bool = False,
    frame_valid: Tensor | None = None,  # (..., F) bool — padded frames vote nothing
) -> tuple[Tensor, Tensor, Tensor]:
    """Full P + R + store + detect for a frame batch: `(dsi, conf, zf)`.

    The homography (Canonical Projection Module) is a batched tensor op;
    the proportional projection, vote, store and detection are the
    kernels. Under `quantized` the Table-1 contract runs end to end: events,
    H and phi (Q11.21) here, the int8 plane coords and the int16 store in
    the kernel. `frame_valid` masks every event of a padded frame.
    """
    del dsi_cfg  # kept in the signature for symmetry with the reference
    xy0, valid, phi = canonical_inputs(xy, valid, H, phi, quantized=quantized,
                                       frame_valid=frame_valid)
    return backproject_vote_detect(
        xy0, valid, phi, cx=cam.cx, cy=cam.cy, w=cam.width, h=cam.height,
        mode=mode, quantized=quantized)
