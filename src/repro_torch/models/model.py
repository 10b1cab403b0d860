"""LM model assembly: init / forward / prefill / decode for every LM family.

Counterpart of `repro.models.model`. The reference scans over
super-blocks (the arch's repeating layer pattern: one attention layer for
the dense and MoE families, one Mamba-2 layer for the SSM family, Jamba's
eight) with parameters stacked on a leading axis; here
`params["blocks"]` is a list with one dict per layer, in layer order
(super-block x pattern position), and the scan is a Python loop.

Decode state is a list with one entry per layer: a `KVCache` for an
attention layer, updated in place (see `repro_torch.models.kv_cache`),
and an `SSMState` for a Mamba-2 layer, float32 whatever the model dtype,
which a decode step replaces in the list with the layer's new state.

MoE layers run the single-device path (`models/moe.py`). Not ported yet:
the distribution knobs of `ModelCtx` and the training loss (ROADMAP A7).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Union

import torch

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models import mamba2 as m2
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
    init_rms_norm,
    mlp,
    normal,
    rms_norm,
    unembed,
)
from repro_torch.models.moe import init_moe_or_dense, moe_apply

Tensor = torch.Tensor
LayerState = Union[KVCache, m2.SSMState]


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
                "meshes) are not ported yet: ROADMAP A7")


def _kinds(cfg: ArchConfig) -> list[str]:
    """Every layer's kind, in layer order."""
    return list(cfg.pattern()) * cfg.n_superblocks()


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_ffn(generator: torch.Generator, cfg: ArchConfig, pos_in_pattern: int,
              dtype, device) -> dict:
    """{"moe": ...} or {"dense": ...} by the MoE layout (`init_moe_or_dense`)."""
    return {kind.removeprefix("kind_"): p for kind, p in init_moe_or_dense(
        generator, cfg, pos_in_pattern, dtype, device).items()}


def _init_block(generator: torch.Generator, cfg: ArchConfig, kind: str,
                pos_in_pattern: int, dtype, device) -> dict:
    """One layer (pattern position): mixer + MLP/MoE + norms."""
    p: dict = {"norm1": init_rms_norm(cfg.d_model, device=device)}
    if kind == "attn":
        p["attn"] = init_attention(generator, cfg, dtype, device)
    elif kind == "mamba":
        p["mamba"] = m2.init_mamba2(generator, cfg, dtype, device)
    else:
        raise ValueError(kind)
    # a pure-SSM layer has no MLP; Jamba's Mamba layers each have one
    if kind == "attn" or cfg.family == "hybrid":
        p["norm2"] = init_rms_norm(cfg.d_model, device=device)
        p["ffn"] = _init_ffn(generator, cfg, pos_in_pattern, dtype, device)
    return p


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                dtype=torch.bfloat16, device=None) -> dict:
    """Full parameter tree: {"embed", "blocks" (one dict per layer),
    "final_norm", "lm_head" unless tied}, drawn on `device` (the card
    unless "cpu") from `generator`, which must live on that device."""
    dev = resolve_device(device)
    pat = cfg.pattern()
    params = {"embed": init_embed(generator, cfg.vocab_size, cfg.d_model, dtype, dev)}
    params["blocks"] = [_init_block(generator, cfg, kind, i % len(pat), dtype, dev)
                        for i, kind in enumerate(_kinds(cfg))]
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


def _apply_ffn(p_ffn: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, dict]:
    if "dense" in p_ffn:
        return mlp(p_ffn["dense"], x, cfg.mlp_variant), {}
    b, s, d = x.shape
    y, metrics = moe_apply(p_ffn["moe"], x.reshape(b * s, d), cfg)
    return y.reshape(b, s, d), metrics


def _ffn(p: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, dict]:
    """The layer's MLP/MoE residual, where it has one."""
    if "ffn" not in p:
        return x, {}
    y, metrics = _apply_ffn(p["ffn"], rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), cfg)
    return x + y, metrics


def _logits(params: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, table)


def _prefill_layers(params: dict, x: Tensor, cfg: ArchConfig,
                    state: list[LayerState] | None) -> tuple[Tensor, Tensor | None]:
    """The layer stack over a whole sequence; returns (x, summed MoE aux,
    None without a MoE layer). With `state`, writes K/V at 0 into each
    cache and puts each Mamba-2 layer's final state, as float32, in its
    entry."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    aux = None
    for i, (p, kind) in enumerate(zip(params["blocks"], _kinds(cfg))):
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        if kind == "attn":
            qkv = qkv_project(p["attn"], h, cfg, positions)
            att = mask_padded_heads(attention_core(qkv.q, qkv.k, qkv.v, causal=True), cfg)
            x = x + attention_out(p["attn"], att)
            if state is not None:
                write_cache(state[i], qkv.k, qkv.v, 0)
        else:
            y, st = m2.mamba2_prefill(p["mamba"], h, cfg, want_state=state is not None)
            x = x + y
            if state is not None:
                state[i] = m2.SSMState(*(t.to(torch.float32) for t in st))
        x, metrics = _ffn(p, x, cfg)
        if "moe_aux" in metrics:
            aux = metrics["moe_aux"] if aux is None else aux + metrics["moe_aux"]
    return x, aux


def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            frontend_embed: Tensor | None = None,
            ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, mean MoE aux loss per layer)."""
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    x, aux = _prefill_layers(params, x, cfg, None)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return _logits(params, x, cfg), aux / max(cfg.n_layers, 1)


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      ctx: ModelCtx = ModelCtx(), dtype=torch.bfloat16,
                      device=None) -> list[LayerState]:
    """One zeroed state per layer, on `device` (the card unless "cpu"): a
    KV cache of `dtype` (int8 when quantized) for an attention layer, a
    float32 `SSMState` for a Mamba-2 layer."""
    dev = resolve_device(device)
    return [init_cache(batch, max_len, cfg.n_kv_heads_eff, cfg.head_dim,
                       quantized=ctx.kv_quantized, dtype=dtype, device=dev)
            if kind == "attn" else
            m2.mamba2_init_state(cfg, batch, dtype=torch.float32, device=dev)
            for kind in _kinds(cfg)]


def prefill(params: dict, tokens: Tensor, cfg: ArchConfig, max_len: int, *,
            frontend_embed: Tensor | None = None, ctx: ModelCtx = ModelCtx(),
            logit_index: int | None = None) -> tuple[Tensor, list[LayerState]]:
    """Process the prompt; return (logits (B, 1, V) at one position, state).

    `logit_index`: position whose logits to return (default: the last),
    clamped into the sequence as `dynamic_slice` clamps it. Lets the engine
    right-pad prompts to a bucket and read the true last prompt token.
    The whole padded sequence is written into the cache; the engine masks
    positions at and past each slot's length and decode overwrites them.
    A Mamba-2 layer's state takes in every position, so the engine
    prefills SSM and hybrid archs at the prompt's exact length.
    """
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    b, s = tokens.shape
    state: list[LayerState] = [
        init_cache(b, max_len, cfg.n_kv_heads_eff, cfg.head_dim,
                   quantized=ctx.kv_quantized, dtype=x.dtype, device=x.device)
        if kind == "attn" else None  # filled by the layer's prefill
        for kind in _kinds(cfg)]
    x, _ = _prefill_layers(params, x, cfg, state)
    at = s - 1 if logit_index is None else max(0, min(int(logit_index), s - 1))
    return _logits(params, x[:, at:at + 1], cfg), state


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_layers(params: dict, x: Tensor, state: list[LayerState], cfg: ArchConfig,
                   positions: Tensor, write, length) -> Tensor:
    for i, (p, kind) in enumerate(zip(params["blocks"], _kinds(cfg))):
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        if kind == "attn":
            qkv = qkv_project(p["attn"], h, cfg, positions)
            write(state[i], qkv.k, qkv.v)
            k, v = read_cache(state[i], x.dtype)
            att = mask_padded_heads(attention_decode(qkv.q, k, v, length), cfg)
            x = x + attention_out(p["attn"], att)
        else:
            y, state[i] = m2.mamba2_decode_step(p["mamba"], h, state[i], cfg)
            x = x + y
        x, _ = _ffn(p, x, cfg)
    return x


def decode_step(params: dict, state: list[LayerState], tokens: Tensor, cur_len: int,
                cfg: ArchConfig, *, frontend_embed: Tensor | None = None,
                ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[LayerState]]:
    """One-token decode. tokens (B, 1); `cur_len` = tokens so far (one for
    every row). The new token's K/V is written at index cur_len and it
    attends to cache[:cur_len + 1]. `state` is updated in place."""
    cur_len = int(cur_len)
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    positions = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
    x = _decode_layers(params, x, state, cfg, positions,
                       lambda c, k, v: write_cache(c, k, v, cur_len), cur_len + 1)
    return _logits(params, x, cfg), state


def decode_step_batched(params: dict, state: list[LayerState], tokens: Tensor,
                        lengths: Tensor, cfg: ArchConfig, *,
                        frontend_embed: Tensor | None = None,
                        ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[LayerState]]:
    """Continuous-batching decode: per-slot lengths (B,) on the tokens'
    device. Each slot's new K/V is written at its own position and it
    attends to its own `lengths[b] + 1` cache entries. In place."""
    x = _embed_inputs(params, tokens, cfg, frontend_embed)
    positions = lengths[:, None].to(torch.int32)  # per-slot RoPE position
    x = _decode_layers(params, x, state, cfg, positions,
                       lambda c, k, v: write_cache_batched(c, k, v, lengths),
                       lengths + 1)
    return _logits(params, x, cfg), state


def splice_slot(state: list[LayerState], pstate: list[LayerState], slot: int
                ) -> list[LayerState]:
    """Copy a prefilled batch-1 decode state into slot `slot` of a batched
    engine state (continuous-batching admission), in place, on the device:
    every KV cache and SSM state field."""
    for layer, player in zip(state, pstate):
        for dst, src in zip(layer, player):
            if dst is not None:
                dst[slot:slot + 1] = src.to(dst.dtype)
    return state
