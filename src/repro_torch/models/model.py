"""LM model assembly: init / forward / prefill / decode, attention-only families.

Counterpart of `repro.models.model` for the configs whose super-block is
one attention layer (`cfg.pattern() == ("attn",)`) with a dense MLP. The
reference scans over super-blocks with parameters stacked on a leading
axis; here `params["blocks"]` is a list with one dict per layer and the
scan is a Python loop. Decode state is a list with one `KVCache` per
layer, updated in place (see `repro_torch.models.kv_cache`).

Not ported yet: MoE (ROADMAP A8, `models/moe.py`), Mamba-2 and hybrid
stacks (A8, `models/mamba2.py`), the distribution knobs of `ModelCtx`
and the training loss (A8, training slice).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    attention_core,
    attention_decode,
    attention_out,
    init_attention,
    mask_padded_heads,
    qkv_project,
)
from repro_torch.models.kv_cache import (
    KVCache,
    init_cache,
    read_cache,
    write_cache,
    write_cache_batched,
)
from repro_torch.models.layers import (
    embed,
    init_embed,
    init_mlp,
    init_rms_norm,
    mlp,
    normal,
    rms_norm,
    unembed,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ModelCtx:
    """Execution context. Only `kv_quantized` is ported; the reference's
    distribution knobs raise until their slice lands."""

    ep_shard: Optional[Any] = None
    seq_shard: Optional[Any] = None
    kv_quantized: bool = False
    remat: bool = False
    mesh: Optional[Any] = None
    batch_axes: tuple = ()
    seq_axis: Optional[str] = None

    def __post_init__(self):
        unported = [f.name for f in dataclasses.fields(self)
                    if f.name != "kv_quantized" and getattr(self, f.name) != f.default]
        if unported:
            raise NotImplementedError(
                f"ModelCtx fields {unported} (expert/sequence sharding, remat, "
                "meshes) are not ported yet: ROADMAP A8")


def _check_supported(cfg: ArchConfig) -> None:
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE layers are not ported yet (ROADMAP A8, models/moe.py)")
    if cfg.pattern() != ("attn",):
        raise NotImplementedError(
            f"{cfg.name}: pattern {cfg.pattern()} needs Mamba-2 layers, not ported "
            "yet (ROADMAP A8, models/mamba2.py)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Full parameter tree: {"embed", "blocks" (one dict per layer),
    "final_norm", "lm_head" unless tied}, drawn on `device` (the card
    unless "cpu") from `generator`, which must live on that device."""
    _check_supported(cfg)
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    params = {"embed": init_embed(generator, cfg.vocab_size, cfg.d_model, **kw)}
    params["blocks"] = [
        {"norm1": init_rms_norm(cfg.d_model, device=dev),
         "attn": init_attention(generator, cfg, **kw),
         "norm2": init_rms_norm(cfg.d_model, device=dev),
         "ffn": {"dense": init_mlp(generator, cfg.d_model, cfg.d_ff,
                                   cfg.mlp_variant, **kw)}}
        for _ in range(cfg.n_layers)]
    params["final_norm"] = init_rms_norm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal(generator, (cfg.vocab_size, cfg.d_model),
                                   cfg.d_model ** -0.5, dtype, dev)
    return params


def param_count(params: dict) -> int:
    def leaves(t):
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return [t]

    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------------------
# Forward and prefill
# ---------------------------------------------------------------------------


def _embed_inputs(params: dict, tokens: Tensor, cfg: ArchConfig,
                  frontend_embed: Tensor | None) -> Tensor:
    x = embed(tokens, params["embed"]["table"])
    if frontend_embed is not None:
        fe = frontend_embed.to(x.dtype)
        if cfg.frontend == "vision_patches":
            # patch embeddings occupy the first n_front positions (anyres stub)
            x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
        elif cfg.frontend == "audio_frames":
            # EnCodec frame embeddings added to code-token embeddings (stub)
            x = x + fe
    return x


def _ffn(p: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    h2 = rms_norm(x, p["norm2"]["scale"], cfg.norm_eps)
    return x + mlp(p["ffn"]["dense"], h2, cfg.mlp_variant)


def _logits(params: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, table)


def _prefill_layers(params: dict, x: Tensor, cfg: ArchConfig,
                    state: list[KVCache] | None) -> Tensor:
    """The layer stack over a whole sequence; writes K/V at 0 into `state`."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    for i, p in enumerate(params["blocks"]):
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        qkv = qkv_project(p["attn"], h, cfg, positions)
        att = mask_padded_heads(attention_core(qkv.q, qkv.k, qkv.v, causal=True), cfg)
        x = x + attention_out(p["attn"], att)
        if state is not None:
            write_cache(state[i], qkv.k, qkv.v, 0)
        x = _ffn(p, x, cfg)
    return x


def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            frontend_embed: Tensor | None = None,
            ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, MoE aux loss = 0)."""
    _check_supported(cfg)
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    x = _prefill_layers(params, x, cfg, None)
    return _logits(params, x, cfg), torch.zeros((), dtype=torch.float32,
                                                 device=x.device)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      ctx: ModelCtx = ModelCtx(), dtype=torch.bfloat16,
                      device=None) -> list[KVCache]:
    """One zeroed KV cache per layer, on `device` (the card unless "cpu")."""
    _check_supported(cfg)
    dev = resolve_device(device)
    return [init_cache(batch, max_len, cfg.n_kv_heads_eff, cfg.head_dim,
                       quantized=ctx.kv_quantized, dtype=dtype, device=dev)
            for _ in range(cfg.n_layers)]


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig, max_len: int, *,
            frontend_embed: Tensor | None = None, ctx: ModelCtx = ModelCtx(),
            logit_index: int | None = None) -> tuple[Tensor, list[KVCache]]:
    """Process the prompt; return (logits (B, 1, V) at one position, state).

    `logit_index`: position whose logits to return (default: the last),
    clamped into the sequence as `dynamic_slice` clamps it. Lets the engine
    right-pad prompts to a bucket and read the true last prompt token.
    The whole padded sequence is written into the cache; the engine masks
    positions at and past each slot's length and decode overwrites them.
    """
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    b, s = tokens.shape
    state = init_decode_state(cfg, b, max_len, ctx, dtype=x.dtype, device=x.device)
    x = _prefill_layers(params, x, cfg, state)
    at = s - 1 if logit_index is None else max(0, min(int(logit_index), s - 1))
    return _logits(params, x[:, at:at + 1], cfg), state


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_layers(params: dict, x: Tensor, state: list[KVCache], cfg: ArchConfig,
                   positions: Tensor, write, length) -> Tensor:
    for p, cache in zip(params["blocks"], state):
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        qkv = qkv_project(p["attn"], h, cfg, positions)
        write(cache, qkv.k, qkv.v)
        k, v = read_cache(cache, x.dtype)
        att = mask_padded_heads(attention_decode(qkv.q, k, v, length), cfg)
        x = x + attention_out(p["attn"], att)
        x = _ffn(p, x, cfg)
    return x


def decode_step(params: dict, state: list[KVCache], tokens: Tensor, cur_len: int,
                cfg: ArchConfig, *, frontend_embed: Tensor | None = None,
                ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[KVCache]]:
    """One-token decode. tokens (B, 1); `cur_len` = tokens so far (one for
    every row). The new token's K/V is written at index cur_len and it
    attends to cache[:cur_len + 1]. `state` is updated in place."""
    cur_len = int(cur_len)
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    positions = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
    x = _decode_layers(params, x, state, cfg, positions,
                       lambda c, k, v: write_cache(c, k, v, cur_len), cur_len + 1)
    return _logits(params, x, cfg), state


def decode_step_batched(params: dict, state: list[KVCache], tokens: Tensor,
                        lengths: Tensor, cfg: ArchConfig, *,
                        frontend_embed: Tensor | None = None,
                        ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[KVCache]]:
    """Continuous-batching decode: per-slot lengths (B,) on the tokens'
    device. Each slot's new K/V is written at its own position and it
    attends to its own `lengths[b] + 1` cache entries. In place."""
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    positions = lengths[:, None].to(torch.int32)  # per-slot RoPE position
    x = _decode_layers(params, x, state, cfg, positions,
                       lambda c, k, v: write_cache_batched(c, k, v, lengths),
                       lengths + 1)
    return _logits(params, x, cfg), state


def splice_slot(state: list[KVCache], pstate: list[KVCache], slot: int
                ) -> list[KVCache]:
    """Copy a prefilled batch-1 decode state into slot `slot` of a batched
    engine state (continuous-batching admission), in place."""
    for cache, pcache in zip(state, pstate):
        for dst, src in zip(cache, pcache):
            if dst is not None:
                dst[slot:slot + 1] = src.to(dst.dtype)
    return state
