"""Launcher for the CUDA detection-tail kernel (`csrc/detect_filter.cu`).

Replaces no TPU kernel: the reference's tail is plain JAX. Takes CUDA
tensors only (a meta tensor traces it); the wrapper (`ops.py`) sends CPU
tensors to `core.detection`'s eager code, which the kernel equals bit for
bit.
"""
from __future__ import annotations

import ctypes
from collections.abc import Sequence

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

MAX_RADIUS = 8  # the kernel's shared-memory halo


def _entry():
    fn = cuda.load("detect_filter").detect_filter_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def detect_filter_cuda(conf: Tensor, zf: Tensor, planes: Tensor, taps: Sequence[float], *,
                       threshold_c: float, min_votes: float, median_filter: bool
                       ) -> tuple[Tensor, Tensor]:
    """conf, zf (S, h, w) and planes (Nz,), float32 on CUDA, and the blur's
    2r+1 Gaussian taps (host floats) -> (depth (S, h, w) float32, mask
    (S, h, w) bool): one launch for the whole batch, no host sync."""
    for name, t in (("conf", conf), ("zf", zf), ("planes", planes)):
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"detect_filter_cuda needs CUDA tensors, got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"detect_filter_cuda: {name} must be float32, got {t.dtype}")
    if conf.dim() != 3 or zf.shape != conf.shape or planes.dim() != 1:
        raise ValueError(f"detect_filter_cuda: expected conf and zf (S, h, w) and planes "
                         f"(Nz,), got {tuple(conf.shape)}, {tuple(zf.shape)}, "
                         f"{tuple(planes.shape)}")
    n_taps = len(taps)
    if n_taps % 2 != 1 or n_taps > 2 * MAX_RADIUS + 1:
        raise ValueError(f"detect_filter_cuda: the blur's radius must be at most "
                         f"{MAX_RADIUS} (the kernel's halo), got {n_taps} taps")
    return torch.ops.repro_torch.detect_filter(conf, zf, planes, list(taps),
                                               threshold_c, min_votes, median_filter)


# One PyTorch operation per launch: on CUDA tensors it runs the body below
# (the launch), on fake tensors only its outputs' shapes and dtypes, so a
# dry run or a lint traces the tail as one operation without launching it.
@torch.library.custom_op("repro_torch::detect_filter", mutates_args=())
def _detect_filter_op(conf: Tensor, zf: Tensor, planes: Tensor, taps: list[float],
                      threshold_c: float, min_votes: float, median: bool
                      ) -> tuple[Tensor, Tensor]:
    conf, zf, planes = conf.contiguous(), zf.contiguous(), planes.contiguous()
    s, h, w = conf.shape
    depth = torch.empty_like(conf)
    mask = torch.empty(conf.shape, dtype=torch.bool, device=conf.device)
    if s == 0 or h * w == 0:
        return depth, mask
    fn = _entry()
    host_taps = (ctypes.c_float * len(taps))(*taps)
    with torch.cuda.device(conf.device):
        err = fn(conf.data_ptr(), zf.data_ptr(), planes.data_ptr(), depth.data_ptr(),
                 mask.data_ptr(), s, h, w, planes.shape[0], (len(taps) - 1) // 2,
                 ctypes.cast(host_taps, ctypes.c_void_p), threshold_c, min_votes,
                 int(median), cuda.current_stream(conf.device))
        cuda.check(err, "detect_filter_launch")
        cuda.launch_counts["detect_filter"] += 1
    return depth, mask


@_detect_filter_op.register_fake
def _(conf, zf, planes, taps, threshold_c, min_votes, median):
    return torch.empty_like(conf), conf.new_empty(conf.shape, dtype=torch.bool)
