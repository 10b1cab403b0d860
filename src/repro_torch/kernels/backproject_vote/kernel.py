"""Launcher for the CUDA sweep kernel (`csrc/backproject_vote.cu`).

Replaces the vote-and-store part of
`repro.kernels.backproject_vote.kernel.backproject_vote_pallas`: one launch
votes every plane of every segment of a bucket. Takes CUDA tensors only.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor


def _entry():
    fn = cuda.load("backproject_vote").backproject_vote_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float,
                   ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def backproject_vote_cuda(
    x0: Tensor,  # (S, F, E) canonical x
    y0: Tensor,  # (S, F, E)
    valid: Tensor,  # (S, F, E) float32 vote weight
    phi: Tensor,  # (S, F, Nz, 3)
    *,
    cx: float,
    cy: float,
    w: int,
    h: int,
    mode: str = "nearest",
    quantized: bool = False,
) -> Tensor:
    """Stored DSI (S, Nz, h, w): int16 when `quantized`, else float32."""
    if mode not in ("nearest", "bilinear"):
        raise ValueError(f"unknown voting mode: {mode}")
    for name, t in (("x0", x0), ("y0", y0), ("valid", valid), ("phi", phi)):
        if not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"backproject_vote_cuda: {name} must be a float32 "
                             f"CUDA tensor, got {t.dtype} on {t.device}")
    if x0.dim() != 3 or y0.shape != x0.shape or valid.shape != x0.shape:
        raise ValueError("backproject_vote_cuda: x0, y0, valid must share one "
                         f"(S, F, E) shape, got {tuple(x0.shape)}, "
                         f"{tuple(y0.shape)}, {tuple(valid.shape)}")
    s, f, e = x0.shape
    if phi.dim() != 4 or phi.shape[:2] != (s, f) or phi.shape[3] != 3:
        raise ValueError(f"backproject_vote_cuda: phi must be (S, F, Nz, 3), "
                         f"got {tuple(phi.shape)}")
    nz = phi.shape[2]
    smem = 4 * w * h  # one CTA holds an h*w float32 vote accumulator
    limit = torch.cuda.get_device_properties(x0.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"a {w}x{h} plane needs {smem} B of shared memory per block; this "
            f"device allows {limit} B (row-band tiling is not implemented)")
    store = torch.int16 if quantized else torch.float32
    dsi = torch.empty((s, nz, h, w), dtype=store, device=x0.device)
    if dsi.numel() == 0:
        return dsi
    x0, y0, valid, phi = (t.contiguous() for t in (x0, y0, valid, phi))
    fn = _entry()
    with torch.cuda.device(x0.device):
        err = fn(x0.data_ptr(), y0.data_ptr(), valid.data_ptr(), phi.data_ptr(),
                 dsi.data_ptr(), s, f, e, nz, w, h, cx, cy,
                 int(mode == "bilinear"), int(quantized),
                 cuda.current_stream(x0.device))
        cuda.check(err, "backproject_vote_launch")
        cuda.launch_counts["backproject_vote"] += 1
    return dsi
