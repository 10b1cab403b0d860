"""Launcher for the CUDA depth max/argmax kernel (`csrc/local_max.cu`).

Replaces `repro.kernels.local_max.kernel.depth_argmax_pallas`. Takes a
CUDA tensor only; there is no other path here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.int16: 1, torch.int32: 2}


def _entry():
    fn = cuda.load("local_max").depth_argmax_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def depth_argmax_cuda(dsi: Tensor) -> tuple[Tensor, Tensor]:
    """dsi (S, Nz, h, w) float32/int16/int32 on CUDA -> (conf, zf), (S, h, w)."""
    if not dsi.is_cuda:
        raise ValueError(f"depth_argmax_cuda needs a CUDA tensor, got {dsi.device}")
    if dsi.dtype not in _DTYPE_CODES:
        raise TypeError(f"depth_argmax_cuda: unsupported DSI dtype {dsi.dtype}")
    if dsi.dim() != 4:
        raise ValueError(f"depth_argmax_cuda: expected (S, Nz, h, w), got {tuple(dsi.shape)}")
    dsi = dsi.contiguous()
    s, nz, h, w = dsi.shape
    conf = torch.empty((s, h, w), dtype=torch.float32, device=dsi.device)
    zf = torch.empty_like(conf)
    if s == 0 or h * w == 0:
        return conf, zf
    fn = _entry()
    with torch.cuda.device(dsi.device):
        err = fn(dsi.data_ptr(), conf.data_ptr(), zf.data_ptr(), s, nz, h * w,
                 _DTYPE_CODES[dsi.dtype], cuda.current_stream(dsi.device))
        cuda.check(err, "depth_argmax_launch")
        cuda.launch_counts["depth_argmax"] += 1
    return conf, zf
