"""Launcher for the CUDA front-end kernel (`csrc/canonical_project.cu`).

Replaces no TPU kernel: the reference's frame geometry and Table-1 steps
are plain JAX. Takes CUDA tensors only (a meta tensor traces it); the
wrapper (`ops.py`) sends CPU tensors to the plain version (`ref.py`), which
the kernel equals bit for bit.
"""
from __future__ import annotations

import ctypes
import functools
from collections.abc import Sequence

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.backproject_vote.kernel import check_mask

Tensor = torch.Tensor

# the inputs in the launcher's order; the masks are bool, the rest float32
_INPUTS = ("xy", "valid", "frame_valid", "poses_R", "poses_t", "ref_R", "ref_t", "planes", "z0")
_MASKS = ("valid", "frame_valid")


@functools.lru_cache(maxsize=1)
def _entry():
    """The launcher's entry point, its types set once per process."""
    fn = cuda.load("canonical_project").canonical_project_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def canonical_project_cuda(xy: Tensor, valid: Tensor, frame_valid: Tensor, poses_R: Tensor,
                           poses_t: Tensor, ref_R: Tensor, ref_t: Tensor, planes: Tensor,
                           z0: Tensor, *, K: Sequence[float], K_inv: Sequence[float],
                           quantized: bool) -> tuple[Tensor, Tensor, Tensor]:
    """A bucket's raw events and poses -> the sweep kernel's inputs `(xy0,
    valid, phi)`, (S, C, E, 2) float32, (S, C, E) bool, (S, C, Nz, 3)
    float32: one launch, no host sync. `K`, `K_inv` are the intrinsics'
    nine float32 values each, row-major; `z0` a 0-dim tensor. Every tensor
    must be on the card (or meta), of its dtype and contiguous: nothing is
    converted or copied here."""
    tensors = dict(zip(_INPUTS, (xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t,
                                 planes, z0)))
    if xy.dim() != 4 or xy.shape[-1] != 2 or planes.dim() != 1:
        raise ValueError(f"canonical_project_cuda: expected xy (S, C, E, 2) and planes (Nz,), "
                         f"got {tuple(xy.shape)} and {tuple(planes.shape)}")
    s, c, e, _ = xy.shape
    want = {"xy": (s, c, e, 2), "valid": (s, c, e), "frame_valid": (s, c),
            "poses_R": (s, c, 3, 3), "poses_t": (s, c, 3), "ref_R": (s, 3, 3), "ref_t": (s, 3),
            "planes": tuple(planes.shape), "z0": ()}
    for name, t in tensors.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"canonical_project_cuda needs CUDA tensors, got {name} on "
                             f"{t.device}")
        if name in _MASKS:
            check_mask(f"canonical_project_cuda: {name}", t)
        elif t.dtype != torch.float32:
            raise TypeError(f"canonical_project_cuda: {name} must be torch.float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"canonical_project_cuda: {name} must be {want[name]} for xy "
                             f"{tuple(xy.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"canonical_project_cuda: {name} must be contiguous")
    if len(K) != 9 or len(K_inv) != 9:
        raise ValueError("canonical_project_cuda: K and K_inv take nine values each")
    return torch.ops.repro_torch.canonical_project(
        xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t, planes, z0,
        [float(v) for v in K], [float(v) for v in K_inv], quantized)


# One PyTorch operation per launch: on CUDA tensors it runs the body below
# (the launch), on fake tensors only its outputs' shapes and dtypes, so a
# dry run or a lint traces the front end as one operation without launching it.
@torch.library.custom_op("repro_torch::canonical_project", mutates_args=())
def _canonical_project_op(xy: Tensor, valid: Tensor, frame_valid: Tensor, poses_R: Tensor,
                          poses_t: Tensor, ref_R: Tensor, ref_t: Tensor, planes: Tensor,
                          z0: Tensor, K: list[float], K_inv: list[float],
                          quantized: bool) -> tuple[Tensor, Tensor, Tensor]:
    s, c, e, _ = xy.shape
    nz = planes.shape[0]
    xy0 = torch.empty_like(xy)
    valid_out = torch.empty_like(valid)
    phi = torch.empty((s, c, nz, 3), dtype=torch.float32, device=xy.device)
    if s * c == 0:
        return xy0, valid_out, phi
    fn = _entry()
    host_k = (ctypes.c_float * 9)(*K)
    host_k_inv = (ctypes.c_float * 9)(*K_inv)
    with torch.cuda.device(xy.device):
        err = fn(xy.data_ptr(), valid.data_ptr(), frame_valid.data_ptr(), poses_R.data_ptr(),
                 poses_t.data_ptr(), ref_R.data_ptr(), ref_t.data_ptr(), planes.data_ptr(),
                 z0.data_ptr(), ctypes.cast(host_k, ctypes.c_void_p),
                 ctypes.cast(host_k_inv, ctypes.c_void_p), xy0.data_ptr(),
                 valid_out.data_ptr(), phi.data_ptr(), s, c, e, nz, int(quantized),
                 cuda.current_stream(xy.device))
        cuda.check(err, "canonical_project_launch")
        cuda.launch_counts["canonical_project"] += 1
    return xy0, valid_out, phi


@_canonical_project_op.register_fake
def _(xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t, planes, z0, K, K_inv,
      quantized):
    s, c = xy.shape[:2]
    return (torch.empty_like(xy), torch.empty_like(valid),
            xy.new_empty((s, c, planes.shape[0], 3), dtype=torch.float32))
