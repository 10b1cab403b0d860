"""Public wrapper: (B, H, S, D) layout and GQA plumbing; the device picks
the path."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.flash_attention.ref import attention_ref

Tensor = torch.Tensor


def flash_attention(
    q: Tensor,  # (B, Hq, Sq, D)
    k: Tensor,  # (B, Hkv, Skv, D)
    v: Tensor,
    *,
    causal: bool = True,
    block_q: int = 128,
    block_k: int = 128,
) -> Tensor:
    """Softmax attention, (B, Hq, Sq, D) in q.dtype.

    `block_q`/`block_k` are the reference kernel's tiling: shapes it would
    refuse (Sq or Skv not a multiple of its block) raise here too. They do
    not change the result; the CUDA kernels tile with their own 64 x 64 and
    mask ragged edges. A CPU tensor takes the plain version, a CUDA
    tensor launches a kernel (read through its strides, output in q's
    layout), a meta tensor traces it, any other device raises.
    """
    hq, sq = q.shape[1], q.shape[2]
    hkv, skv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: {hq} query heads over {hkv} KV heads")
    bq, bk = min(block_q, sq), min(block_k, skv)
    if bq <= 0 or bk <= 0 or sq % bq or skv % bk:
        raise ValueError(f"flash_attention: Sq={sq}, Skv={skv} are not multiples "
                         f"of blocks {bq}, {bk}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return flash_attention_cuda(q, k, v, causal=causal)
