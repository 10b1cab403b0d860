"""Launcher for the CUDA flash-attention kernels (`csrc/flash_attention.cu`).

Replaces `repro.kernels.flash_attention.kernel.flash_attention_pallas`.
Two hand-written kernels sit in that file; `route` picks one from the
dtype and the head dim alone, before the launch:

  "tc"   the tensor-core kernel (wgmma on bf16 operands, TMA ring): bf16
         with D a multiple of 16 up to 256;
  "fma"  the CUDA-core kernel (float32 FMAs): everything else it takes,
         float32 (tensor-core products would be TF32) and bf16 at other D.

`flash_attention_cuda` takes CUDA tensors only (meta tensors trace it);
there is no other path here. Operands are read in place through their strides (`kernel_strides`).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

_ROUTE_CODES = {"fma": 0, "tc": 1}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16  # bytes: the kernels' vector loads and TMA need 16-byte rows


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel that (dtype, head dim) takes: "tc" or "fma"."""
    if dtype == torch.bfloat16 and d % 16 == 0 and 16 <= d <= 256:
        return "tc"
    return "fma"


def kernel_strides(t: Tensor) -> tuple[int, int, int] | None:
    """(batch, head, seq) element strides the kernels read the 4-D `t`
    with, or None when they cannot: the innermost stride must be 1, and the
    base address and every other stride multiples of 16 bytes. A dim of
    size 1 is never stepped, so its stride is replaced by a valid one."""
    if t.dim() != 4 or t.stride(3) != 1:
        return None
    size = t.element_size()
    if t.data_ptr() % _ALIGN:
        return None
    out = [0, 0, 0]
    inner = t.shape[3]  # the stride a size-1 dim gets: its inner neighbour's extent
    for i in (2, 1, 0):
        st = t.stride(i) if t.shape[i] != 1 else inner
        if st < 0 or (st * size) % _ALIGN:
            return None
        out[i] = st
        inner = st * t.shape[i]
    return tuple(out)


@functools.cache
def _entry():
    fn = cuda.load("flash_attention").flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, p, i, ctypes.c_float, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _readable(t: Tensor) -> tuple[Tensor, tuple[int, int, int]]:
    st = kernel_strides(t)
    if st is None:  # a fresh contiguous copy is always readable
        t = t.clone(memory_format=torch.contiguous_format)
        st = kernel_strides(t)
    return t, st


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) on CUDA -> (B, Hq, Sq, D) in q.dtype.

    Query head h reads KV head h // (Hq // Hkv). D is a multiple of 8 up
    to 256; float32 or bfloat16, the same for all three. Each operand is
    read through its strides, so views such as the (B, S, H, D) layout
    transposed to (B, H, S, D) cost no copy; an operand is copied into a
    contiguous tensor only when its innermost stride is not 1 or its base
    or other strides are not multiples of 16 bytes (`kernel_strides`).
    The output is `torch.empty_like(q)`, so it keeps q's layout.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"flash_attention_cuda: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda: q, k, v must share one dtype "
                            f"of float32/bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda: {name} must be 4-D, got "
                             f"{tuple(t.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: {hq} query heads over {hkv} KV heads")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"flash_attention_cuda: head dim {d} must be a multiple "
                         "of 8 in [8, 256]")
    if sq and b and hq:
        if skv == 0:
            raise ValueError("flash_attention_cuda: no keys")
        if b * hq > 2**31 - 1 or sq > 65535 * 64:
            raise ValueError(f"flash_attention_cuda: {b}x{hq} heads of {sq} "
                             "queries exceed the grid")
    return torch.ops.repro_torch.flash_attention(q, k, v, bool(causal))


# One PyTorch operation per launch: on CUDA tensors it runs the body below
# (the launch), on fake tensors only its output's shape and dtype, so a dry
# run traces B3 as one operation without launching it.
@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention_op(q: Tensor, k: Tensor, v: Tensor, causal: bool) -> Tensor:
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    d = q.shape[3]
    b, hq, sq = q.shape[:3]
    hkv, skv = k.shape[1], k.shape[2]
    (q, qs), (k, ks), (v, vs) = _readable(q), _readable(k), _readable(v)
    out, os_ = _readable(out)
    r = route(q.dtype, d)
    strides = (ctypes.c_longlong * 12)(*qs, *ks, *vs, *os_)
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, hq, hkv,
                 sq, skv, d, ctypes.cast(strides, ctypes.c_void_p), int(causal),
                 1.0 / math.sqrt(d), _DTYPE_CODES[q.dtype], _ROUTE_CODES[r],
                 cuda.current_stream(q.device))
        cuda.check(err, f"flash_attention_launch ({r})")
        cuda.launch_counts["flash_attention"] += 1
        cuda.launch_counts[f"flash_attention_{r}"] += 1
    return out


@_flash_attention_op.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)
