"""Plain PyTorch version of causal (optionally GQA) attention, softmax in f32.

Counterpart of `repro.kernels.flash_attention.ref.attention_ref`: the CPU
path of `flash_attention`, and the yardstick its CUDA kernel is held to
on the card.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0.

    Returns (B, Hq, Sq, D) in q.dtype. Scores, softmax and PV in float32;
    the causal mask is aligned at `Skv - Sq` (the last query sees every key).
    """
    _, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.matmul(q.to(torch.float32), k.to(torch.float32).transpose(-1, -2))
    s = s / math.sqrt(d)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, v.to(torch.float32))
    return out.to(q.dtype)
