"""Launcher for the CUDA frame-pose kernel (`csrc/frame_poses.cu`).

Replaces no TPU kernel: the reference interpolates poses as plain JAX.
Takes CUDA tensors only (a meta tensor traces it); the wrapper (`ops.py`)
sends CPU tensors to the plain version (`ref.py`), whose eager chain on
the card the kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

_INPUTS = ("times", "R", "t", "t_query")


@functools.lru_cache(maxsize=1)
def _entry():
    """The launcher's entry point, its types set once per process."""
    fn = cuda.load("frame_poses").frame_poses_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_long, ctypes.c_long, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frame_poses_cuda(times: Tensor, R: Tensor, t: Tensor, t_query: Tensor
                     ) -> tuple[Tensor, Tensor]:
    """Poses `(R, t)`, (F, 3, 3) and (F, 3) float32, at `t_query` (F,) from
    the trajectory `times` (N,), `R` (N, 3, 3), `t` (N, 3): one launch, no
    host sync. Every tensor must be on the card (or meta), float32 and
    contiguous: nothing is converted or copied here."""
    if times.dim() != 1:
        raise ValueError(f"frame_poses_cuda: times must be (N,), got {tuple(times.shape)}")
    n = int(times.shape[0])
    if n < 2:
        raise ValueError(
            f"pose interpolation needs at least 2 trajectory samples, got "
            f"{n}: one sample cannot bracket any query time")
    want = {"times": (n,), "R": (n, 3, 3), "t": (n, 3), "t_query": (t_query.numel(),)}
    for name, x in zip(_INPUTS, (times, R, t, t_query)):
        if x.device.type not in ("cuda", "meta"):
            raise ValueError(f"frame_poses_cuda needs CUDA tensors, got {name} on {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"frame_poses_cuda: {name} must be torch.float32, got {x.dtype}")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"frame_poses_cuda: {name} must be {want[name]} for times "
                             f"({n},), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"frame_poses_cuda: {name} must be contiguous")
    return torch.ops.repro_torch.frame_poses(times, R, t, t_query)


# One PyTorch operation per launch: on CUDA tensors it runs the body below
# (the launch), on fake tensors only its outputs' shapes and dtypes.
@torch.library.custom_op("repro_torch::frame_poses", mutates_args=())
def _frame_poses_op(times: Tensor, R: Tensor, t: Tensor, t_query: Tensor
                    ) -> tuple[Tensor, Tensor]:
    f = t_query.shape[0]
    R_out = t_query.new_empty((f, 3, 3))
    t_out = t_query.new_empty((f, 3))
    if f == 0:
        return R_out, t_out
    fn = _entry()
    with torch.cuda.device(t_query.device):
        err = fn(times.data_ptr(), R.data_ptr(), t.data_ptr(), t_query.data_ptr(),
                 R_out.data_ptr(), t_out.data_ptr(), times.shape[0], f,
                 cuda.current_stream(t_query.device))
        cuda.check(err, "frame_poses_launch")
        cuda.launch_counts["frame_poses"] += 1
    return R_out, t_out


@_frame_poses_op.register_fake
def _(times, R, t, t_query):
    f = t_query.shape[0]
    return t_query.new_empty((f, 3, 3)), t_query.new_empty((f, 3))
