"""Launcher for the CUDA flash-attention kernel (`csrc/flash_attention.cu`).

Replaces `repro.kernels.flash_attention.kernel.flash_attention_pallas`.
Takes CUDA tensors only; there is no other path here.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import cuda

Tensor = torch.Tensor

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _entry():
    fn = cuda.load("flash_attention").flash_attention_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, ctypes.c_float, i, p]
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                         q_per_kv: int = 1) -> Tensor:
    """q (BHq, Sq, D), k/v (BHkv, Skv, D) on CUDA -> (BHq, Sq, D) in q.dtype.

    Query row block `bh` reads KV head `bh // q_per_kv`. D is a multiple
    of 8 up to 256; float32 or bfloat16, the same for all three.
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_cuda: {name} must be a CUDA tensor, "
                             f"got {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda: q, k, v must share one dtype "
                            f"of float32/bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 3:
            raise ValueError(f"flash_attention_cuda: {name} must be 3-D, got "
                             f"{tuple(t.shape)}")
    bh, sq, d = q.shape
    bkv, skv = k.shape[:2]
    if v.shape != k.shape or k.shape[2] != d:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if q_per_kv < 1 or bkv * q_per_kv != bh:
        raise ValueError(f"flash_attention_cuda: {bh} query rows over {bkv} KV "
                         f"rows is not q_per_kv={q_per_kv}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"flash_attention_cuda: head dim {d} must be a multiple "
                         "of 8 in [8, 256]")
    if bh > 65535:
        raise ValueError(f"flash_attention_cuda: {bh} batch*heads exceed the grid")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    if sq == 0 or bh == 0:
        return out
    if skv == 0:
        raise ValueError("flash_attention_cuda: no keys")
    fn = _entry()
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
                 skv, d, q_per_kv, int(causal), 1.0 / math.sqrt(d),
                 _DTYPE_CODES[q.dtype], cuda.current_stream(q.device))
        cuda.check(err, "flash_attention_launch")
        cuda.launch_counts["flash_attention"] += 1
    return out
