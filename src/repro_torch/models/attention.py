"""GQA attention: RoPE, qk-norm, QKV-bias; prefill, training and decode cores.

Counterpart of `repro.models.attention`:

  * `attention_core` — prefill attention, through
    `repro_torch.kernels.flash_attention` (the hand-written kernel on the
    card, its plain version on the CPU). The reference names the Pallas
    kernel as the serving/prefill fast path but dispatches its prefill to
    the einsum `attention_full`; the port puts the kernel on that path.
    It computes scores and softmax statistics in float32, where
    `attention_full` rounds scores and probabilities to the input dtype
    (bf16 in production); on the card the bf16 tensor-core kernel rounds
    only the probabilities to bf16, as operands of their product with V.
  * `attention_full`, `attention_blockwise` and their dispatch
    `attention_dense_core` (the reference's `attention_core`: full up to
    FULL_ATTN_MAX_SEQ keys, blockwise above) — plain, differentiable
    PyTorch, the cores `forward` and the training loss run, with the
    reference's roundings. The kernel has no backward, so training never
    reaches it.
  * `attention_decode` — one query against a KV cache, plain PyTorch as
    in the reference (an einsum outside any kernel there).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import dense, init_dense, rms_norm

Tensor = torch.Tensor

FULL_ATTN_MAX_SEQ = 8192
BLOCKWISE_CHUNK = 1024


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_sincos(positions: Tensor, head_dim: int, theta: float) -> tuple[Tensor, Tensor]:
    """positions (..., S) -> sin/cos (..., S, head_dim/2) float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: Tensor, sin: Tensor, cos: Tensor) -> Tensor:
    """x: (B, S, H, D); sin/cos: (B?, S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    s = sin[..., None, :] if sin.dim() == x.dim() - 1 else sin
    c = cos[..., None, :] if cos.dim() == x.dim() - 1 else cos
    # rotate-half convention (Llama/Qwen)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_attention(generator: torch.Generator, cfg: ArchConfig,
                   dtype=torch.bfloat16, device=None) -> dict:
    d, hd = cfg.d_model, cfg.head_dim
    hq, hkv = cfg.n_heads_eff, cfg.n_kv_heads_eff  # incl. sharding pad
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": init_dense(generator, d, hq * hd, bias=cfg.qkv_bias, **kw),
        "wk": init_dense(generator, d, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": init_dense(generator, d, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": init_dense(generator, hq * hd, d,
                         scale=(hq * hd) ** -0.5 / (2 * cfg.n_layers) ** 0.5, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=device)
    return p


def mask_padded_heads(att: Tensor, cfg: ArchConfig) -> Tensor:
    """Zero the padded heads' outputs, so the model function equals the
    unpadded arch's while head counts divide the tensor-parallel degree."""
    if cfg.head_pad == 0:
        return att
    mask = (torch.arange(cfg.n_heads_eff, device=att.device) < cfg.n_heads).to(att.dtype)
    return att * mask[None, None, :, None]


class QKV(NamedTuple):
    q: Tensor  # (B, S, Hq, D)
    k: Tensor  # (B, S, Hkv, D)
    v: Tensor  # (B, S, Hkv, D)


def _split_heads(t: Tensor, heads: int, hd: int) -> Tensor:
    """(B, S, H*hd) -> (B, S, H, hd). A DTensor sharded on its last dim
    over a mesh axis that does not divide H is first gathered there: the
    split would cut heads."""
    if isinstance(t, DTensor):
        sizes = t.device_mesh.shape
        last = t.dim() - 1
        pl = [Replicate() if p == Shard(last) and heads % sizes[i] else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(t.device_mesh, pl)
    return t.reshape(t.shape[0], t.shape[1], heads, hd)


def qkv_project(params: dict, x: Tensor, cfg: ArchConfig, positions: Tensor) -> QKV:
    hq, hkv, hd = cfg.n_heads_eff, cfg.n_kv_heads_eff, cfg.head_dim
    q = _split_heads(dense(x, params["wq"]["w"], params["wq"].get("b")), hq, hd)
    k = _split_heads(dense(x, params["wk"]["w"], params["wk"].get("b")), hkv, hd)
    v = _split_heads(dense(x, params["wv"]["w"], params["wv"].get("b")), hkv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    sin, cos = rope_sincos(positions, hd, cfg.rope_theta)
    q = apply_rope(q, sin, cos)
    k = apply_rope(k, sin, cos)
    return QKV(q, k, v)


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------


def _repeat_kv(k: Tensor, groups: int) -> Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def attention_full(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """(B, S, H, D) layout; einsum core; float32 softmax."""
    sq, hq, d = q.shape[1], q.shape[2], q.shape[3]
    skv, hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, hq // hkv)
    v = _repeat_kv(v, hq // hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / d ** 0.5
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_blockwise(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                        chunk: int = BLOCKWISE_CHUNK) -> Tensor:
    """Online softmax over KV chunks; O(S * chunk) live scores; differentiable.

    The reference's rectangular schedule: every (query, KV chunk) pair is
    computed and masked, none skipped; a Python loop over the chunks
    stands for its scan."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if skv % chunk:
        raise ValueError(f"attention_blockwise: {skv} keys are not a multiple of {chunk}")
    qpos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
    scale = 1.0 / d ** 0.5
    f32 = torch.float32
    # (m, l) statistics and the accumulator in (B, Hq, Sq, ...) layout
    m = torch.full((b, hq, sq, 1), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((b, hq, sq, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, hq, sq, d), dtype=f32, device=q.device)
    for j in range(skv // chunk):
        kb = _repeat_kv(k[:, j * chunk:(j + 1) * chunk], g)
        vb = _repeat_kv(v[:, j * chunk:(j + 1) * chunk], g)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(f32) * scale
        if causal:
            kpos = j * chunk + torch.arange(chunk, device=q.device)[None, :]
            s = s.masked_fill(kpos > qpos, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(q.dtype), vb).to(f32)
        acc = acc * corr + pv
        m = m_new
    out = (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)  # (B, Hq, Sq, D)
    return out.transpose(1, 2)  # (B, Sq, Hq, D)


def attention_dense_core(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True
                         ) -> Tensor:
    """The reference's `attention_core`: full attention up to
    FULL_ATTN_MAX_SEQ keys, blockwise above. Differentiable."""
    if k.shape[1] <= FULL_ATTN_MAX_SEQ:
        return attention_full(q, k, v, causal=causal)
    return attention_blockwise(q, k, v, causal=causal)


def attention_core(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True) -> Tensor:
    """(B, S, H, D) layout in and out; one `flash_attention` call.

    Blocks are the whole sequence, so any length passes the reference
    kernel's divisibility check; the CUDA kernels tile on their own. On the
    card they read the transposed views in place and write the output in
    q's (B, S, H, D) layout, so neither transpose costs a copy."""
    sq, skv = q.shape[1], k.shape[1]
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                          causal=causal, block_q=sq, block_k=skv)
    return out.transpose(1, 2)


def attention_decode(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     length: Tensor | int) -> Tensor:
    """One-token decode: q (B, 1, Hq, D); caches (B, Smax, Hkv, D).

    `length` (B,) or scalar: number of valid cache entries (including the
    token being decoded). Products are exact in float32 for bf16 inputs,
    so computing in float32 gives the reference's bf16-in, f32-accumulate
    einsums; a float32 q against a bf16 cache promotes as JAX does.
    """
    b, _, hq, d = q.shape
    smax, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qh = q[:, 0].reshape(b, hkv, g, d).to(torch.float32)
    kf = k_cache.to(torch.float32).permute(0, 2, 3, 1)  # (B, Hkv, D, Smax)
    s = torch.matmul(qh, kf) / math.sqrt(d)  # (B, Hkv, g, Smax)
    pos = torch.arange(smax, device=q.device)[None, None, None, :]
    ln = torch.as_tensor(length, device=q.device)
    ln = ln[:, None, None, None] if ln.dim() == 1 else ln
    s = s.masked_fill(pos >= ln, float("-inf"))
    p = torch.softmax(s, dim=-1).to(q.dtype).to(torch.float32)
    vf = v_cache.to(torch.float32).transpose(1, 2)  # (B, Hkv, Smax, D)
    out = torch.matmul(p, vf)  # (B, Hkv, g, D)
    return out.reshape(b, 1, hq, d).to(q.dtype)


def attention_out(params: dict, attn: Tensor) -> Tensor:
    b, s = attn.shape[:2]
    return dense(attn.reshape(b, s, -1), params["wo"]["w"])
