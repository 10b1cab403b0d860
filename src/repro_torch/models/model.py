"""LM model assembly: init / forward / prefill / decode for every LM family.

Counterpart of `repro.models.model`. The reference scans over
super-blocks (the arch's repeating layer pattern: one attention layer for
the dense and MoE families, one Mamba-2 layer for the SSM family, Jamba's
eight) with parameters stacked on a leading axis; here
`params["blocks"]` is a list with one dict per layer, in layer order
(super-block x pattern position), and the scan is a Python loop. On a
mesh where the reference's FSDP shards a stack's super-block dim, those
leaves are held stacked under `params["stacks"]` (the mesh layout of
`distributed/sharding.py`), and each layer reads its row (`_layers`).

Decode state is a list with one entry per layer: a `KVCache` for an
attention layer, updated in place (see `repro_torch.models.kv_cache`),
and an `SSMState` for a Mamba-2 layer, float32 whatever the model dtype,
which a decode step replaces in the list with the layer's new state.

`forward` and `loss_fn` (training) run the differentiable attention cores
(`attention_dense_core`), with `ModelCtx(remat=True)` checkpointing each
super-block as the reference checkpoints its scan body; prefill keeps the
flash-attention kernel. MoE layers run the single-device path
(`models/moe.py`) without a mesh.

On a mesh (`ModelCtx.mesh`), parameters and inputs are DTensors
(`distributed/sharding.py` places them) and DTensor's sharding
propagation takes the place of GSPMD. `ctx.constrain` pins (B, S, D)
activations to the batch axes (and S to `seq_axis`) where the reference
pins them. Where the reference runs a `shard_map` body, or DTensor has no
rule, the port runs local tensors: the attention cores (the flash kernel
is one custom operation) on batch- and, where both head counts divide
`model`, head-sharded q, k, v; MoE layers through `ctx.ep_shard`
(`distributed/expert_parallel.py`; without one, an `EPShard` over the
context's batch axes); decode attention through `ctx.seq_shard`
(`distributed/flash_decode.py`) or, on a sequence-sharded cache, the same
partial-softmax combine over the axes that shard it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Any, Optional, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.expert_parallel import EPShard
from repro_torch.distributed.flash_decode import decode_partial
from repro_torch.models import mamba2 as m2
from repro_torch.models.attention import (
    attention_core,
    attention_decode,
    attention_dense_core,
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
    """Execution context: distribution + cache policy knobs."""

    ep_shard: Optional[Any] = None  # distributed.EPShard | None
    seq_shard: Optional[Any] = None  # distributed.SeqShard | None (flash-decode)
    kv_quantized: bool = False
    remat: bool = False  # checkpoint each super-block (training)
    mesh: Optional[Any] = None  # the DeviceMesh activations are pinned on
    batch_axes: tuple = ()  # activation batch-dim mesh axes
    seq_axis: Optional[str] = None  # sequence-parallel axis (perf option)

    def constrain(self, x: Tensor) -> Tensor:
        """Pin activation sharding: (B, S, D) batch over batch_axes, and S
        over `seq_axis` when set. Without a mesh, or off (B, S, D), x."""
        if self.mesh is None or x.dim() != 3:
            return x
        return shd.constrain(x, self.mesh, shd.P(tuple(self.batch_axes) or None,
                                                 self.seq_axis, None))

    def unshard(self, tree):
        """Parameters as a layer reads them: each DTensor gathered over
        every mesh axis but `model` (FSDP's per-layer all-gather; the
        gradient leaves as a reduce-scatter), the MoE subtree left to the
        expert-parallel executor. Without a mesh, the tree."""
        if self.mesh is None:
            return tree
        if isinstance(tree, dict):
            return {k: v if k == "moe" else self.unshard(v) for k, v in tree.items()}
        if not isinstance(tree, DTensor):
            return tree
        names = tuple(self.mesh.mesh_dim_names)
        pl = [p if names[i] == "model" else Replicate() for i, p in enumerate(tree.placements)]
        return tree.redistribute(self.mesh, pl) if pl != list(tree.placements) else tree

    def local_placements(self, t: Tensor, head_dims: tuple[int, ...] = ()) -> list:
        """Placements of a (B, S, H, ...) tensor for a local body: batch
        over the batch axes where they divide it, heads over `model` where
        every count in `head_dims` divides it, the rest (and every mesh dim
        of size 1) replicated."""
        names = tuple(self.mesh.mesh_dim_names)
        sizes = shd.axis_sizes(self.mesh)
        pl: list = [Replicate()] * len(names)
        bs = math.prod(sizes[a] for a in self.batch_axes)
        if self.batch_axes and t.shape[0] % bs == 0:
            for a in self.batch_axes:
                if sizes[a] > 1:
                    pl[names.index(a)] = Shard(0)
        tp = sizes.get("model", 1)
        if head_dims and tp > 1 and all(h % tp == 0 for h in head_dims):
            pl[names.index("model")] = Shard(2)
        return pl


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


def layer_shapes(cfg: ArchConfig) -> list[dict]:
    """Each pattern position's layer as meta tensors: its leaves' shapes."""
    return [_init_block(None, cfg, kind, i, torch.bfloat16, torch.device("meta"))
            for i, kind in enumerate(cfg.pattern())]


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


def _embed(tokens: Tensor, table: Tensor, ctx: ModelCtx) -> Tensor:
    """`embed`; on a mesh, on local tensors: each rank looks its batch
    rows' tokens up in its slice of the vocab (zero outside it), and a sum
    over `model` completes the rows where the vocab is split there
    (DTensor's index rule refuses a batch split over two mesh axes in
    some PyTorch versions)."""
    if not isinstance(table, DTensor):
        return embed(tokens, table)
    mesh = table.device_mesh
    names = tuple(mesh.mesh_dim_names)
    pl = ctx.local_placements(tokens)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    tok = tokens.redistribute(mesh, pl).to_local()
    # the table's gradient is partial over the axes that split the tokens
    grads = [Partial() if p == Replicate() and pl[i] != Replicate() else p
             for i, p in enumerate(table.placements)]
    local = table.to_local(grad_placements=grads)
    split = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    if not split:
        x = embed(tok, local)
    else:
        off = shd.shard_offset(table, 0)
        inside = (tok >= off) & (tok < off + local.shape[0])
        x = embed(torch.where(inside, tok - off, 0), local) * inside[..., None].to(local.dtype)
        for i in split:
            x = col.psum(x, mesh.get_group(names[i]))
    return DTensor.from_local(x, mesh, pl, run_check=False)


def _embed_inputs(params: dict, tokens: Tensor, cfg: ArchConfig,
                  frontend_embed: Tensor | None, ctx: ModelCtx) -> Tensor:
    x = _embed(tokens, ctx.unshard(params["embed"]["table"]), ctx)
    if frontend_embed is not None:
        fe = frontend_embed.to(x.dtype)
        if cfg.frontend == "vision_patches":
            # patch embeddings occupy the first n_front positions (anyres stub)
            x = torch.cat([fe, x[:, fe.shape[1]:]], dim=1)
        elif cfg.frontend == "audio_frames":
            # EnCodec frame embeddings added to code-token embeddings (stub)
            x = x + fe
    return x


def _apply_ffn(p_ffn: dict, x: Tensor, cfg: ArchConfig, ctx: ModelCtx
               ) -> tuple[Tensor, dict]:
    if "dense" in p_ffn:
        return mlp(p_ffn["dense"], x, cfg.mlp_variant), {}
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    ep = ctx.ep_shard
    if ep is None and isinstance(x, DTensor):
        # the experts sharded over `model` by the parameter rules: expert
        # parallelism over the context's token axes (GSPMD's partition of
        # the single-device formulation)
        ep = EPShard(x.device_mesh, token_axes=tuple(ctx.batch_axes))
    y, metrics = ep.moe(p_ffn["moe"], xt, cfg) if ep is not None else moe_apply(
        p_ffn["moe"], xt, cfg)
    return y.reshape(b, s, d), metrics


def _ffn(p: dict, x: Tensor, cfg: ArchConfig, ctx: ModelCtx) -> tuple[Tensor, dict]:
    """The layer's MLP/MoE residual, where it has one."""
    if "ffn" not in p:
        return x, {}
    x = ctx.constrain(x)
    y, metrics = _apply_ffn(p["ffn"], rms_norm(x, p["norm2"]["scale"], cfg.norm_eps), cfg,
                            ctx)
    return x + y, metrics


def _attend(attend, q: Tensor, k: Tensor, v: Tensor, ctx: ModelCtx) -> Tensor:
    """A causal attention core; on a mesh, on local tensors (the
    reference's GSPMD partitions the core; the flash kernel is one custom
    operation DTensor has no rule for): batch-sharded, and q's heads over
    `model` where they divide it. K/V heads shard with them where they
    divide too; else each rank takes the whole K/V and keeps the heads of
    its q heads' groups (their gradients then sum over `model`)."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, causal=True)
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    qpl = ctx.local_placements(q, (hq,))
    kvpl = ctx.local_placements(k, (hq, hkv))
    q_l = q.redistribute(mesh, qpl).to_local()
    if qpl == kvpl:
        k_l, v_l = (t.redistribute(mesh, kvpl).to_local() for t in (k, v))
    else:  # q split by head over `model`, K/V whole there
        names = tuple(mesh.mesh_dim_names)
        m = names.index("model")
        grads = [Partial() if i == m else p for i, p in enumerate(kvpl)]
        r, h_loc = mesh.get_coordinate()[m], q_l.shape[2]
        k_l, v_l = (torch.repeat_interleave(t.redistribute(mesh, kvpl).to_local(
            grad_placements=grads), hq // hkv, dim=2)[:, :, r * h_loc:(r + 1) * h_loc]
            for t in (k, v))
    out = attend(q_l, k_l, v_l, causal=True)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


def _mamba_local(p: dict, h: Tensor, cfg: ArchConfig, ctx: ModelCtx, want_state: bool
                 ) -> tuple[Tensor, m2.SSMState | None]:
    """A Mamba-2 layer's prefill on a mesh, on local tensors (Megatron's
    split of the mixer): DTensor's rules for its convs, scans and einsums
    differ between PyTorch versions (some lack `flip`, some mis-place a
    view's gradient on a mesh of size-1 dims) and flatten split dims into
    strided layouts. Batch over the batch axes; where the heads divide
    `model`, each model rank runs its heads' slice of d_inner and the norm
    and output projection sum over `model` (`mamba2._finish`), else every
    rank runs the whole layer. Each input's gradient sums over the axes
    that split its uses. One rank runs `mamba2_prefill` as it is."""
    mesh = h.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = shd.axis_sizes(mesh)
    nh = cfg.ssm.num_heads(cfg.d_model)
    split = sizes.get("model", 1) > 1 and nh % sizes["model"] == 0
    m = names.index("model") if split else None
    hpl = ctx.local_placements(h)
    batch = [pl == Shard(0) for pl in hpl]

    def local(t):
        """A parameter's local shard (gathered over every axis but `model`):
        its gradient is partial over the batch axes and, where `model`
        splits its uses but not it, over `model`."""
        if not isinstance(t, DTensor):
            return t
        grads = [Partial() if batch[i] or (i == m and pl == Replicate()) else pl
                 for i, pl in enumerate(t.placements)]
        return t.to_local(grad_placements=tuple(grads))

    h_grads = [Partial() if i == m else pl for i, pl in enumerate(hpl)]
    h_l = h.redistribute(mesh, hpl).to_local(grad_placements=tuple(h_grads))
    y, st = m2.mamba2_prefill(shd.map_with_path(p, lambda _, t: local(t)), h_l, cfg,
                              want_state=want_state,
                              axis=mesh.get_group("model") if split else None)

    def placed(t, dim=None):
        pl = [Shard(dim) if i == m and dim is not None else q for i, q in enumerate(hpl)]
        return DTensor.from_local(t, mesh, pl, run_check=False)

    if st is not None:  # conv windows (B, K-1, C), the SSD state (B, H, N, P)
        st = m2.SSMState(conv_x=placed(st.conv_x, 2), conv_B=placed(st.conv_B),
                         conv_C=placed(st.conv_C), ssd=placed(st.ssd, 1))
    return placed(y), st


def _decode_attention(q: Tensor, k: Tensor, v: Tensor, length, ctx: ModelCtx) -> Tensor:
    """One-token attention over the cache: `ctx.seq_shard`'s flash-decode
    when set; over a DTensor cache, the same partial-softmax combine over
    the mesh axes that shard its sequence (GSPMD's reduction of a sharded
    softmax); else `attention_decode`."""
    if ctx.seq_shard is not None:
        return ctx.seq_shard.decode_attention(q, k, v, length)
    if not isinstance(k, DTensor):
        return attention_decode(q, k, v, length)
    mesh = k.device_mesh
    names = tuple(mesh.mesh_dim_names)
    seq_dims = [i for i, pl in enumerate(k.placements) if pl == Shard(1)]
    qpl = [Replicate() if pl == Shard(1) else pl for pl in k.placements]
    q_l = (q.redistribute(mesh, qpl) if isinstance(q, DTensor) else
           DTensor.from_local(q, mesh, [Replicate()] * mesh.ndim).redistribute(mesh, qpl))
    out = decode_partial(q_l.to_local(), k.to_local(), v.to_local(), length,
                         shd.shard_offset(k, 1),
                         [mesh.get_group(names[i]) for i in seq_dims])
    return DTensor.from_local(out, mesh, qpl, run_check=False)


def _logits(params: dict, x: Tensor, cfg: ArchConfig, ctx: ModelCtx) -> Tensor:
    x = rms_norm(x, ctx.unshard(params["final_norm"]["scale"]), cfg.norm_eps)
    table = params["embed"]["table"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(x, ctx.unshard(table))


def _superblock(blocks: list[dict], x: Tensor, *, cfg: ArchConfig, positions: Tensor,
                attend, state: list[LayerState] | None, first: int, ctx: ModelCtx
                ) -> tuple[Tensor, Tensor | None]:
    """One super-block (the arch's layer pattern, layers `first`...) over a
    whole sequence; returns (x, its summed MoE aux, None without a MoE
    layer). With `state`, writes K/V at 0 into each cache and puts each
    Mamba-2 layer's final state, as float32, in its entry."""
    aux = None
    for j, (p, kind) in enumerate(zip(blocks, cfg.pattern())):
        p = ctx.unshard(p)
        x = ctx.constrain(x)
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        if kind == "attn":
            qkv = qkv_project(p["attn"], h, cfg, positions)
            att = mask_padded_heads(_attend(attend, qkv.q, qkv.k, qkv.v, ctx), cfg)
            x = x + attention_out(p["attn"], att)
            if state is not None:
                write_cache(state[first + j], qkv.k, qkv.v, 0)
        else:
            if isinstance(h, DTensor):
                y, st = _mamba_local(p["mamba"], h, cfg, ctx, state is not None)
            else:
                y, st = m2.mamba2_prefill(p["mamba"], h, cfg, want_state=state is not None)
            x = x + y
            if state is not None:
                state[first + j] = m2.SSMState(*(t.to(torch.float32) for t in st))
        x, metrics = _ffn(p, x, cfg, ctx)
        if "moe_aux" in metrics:
            aux = metrics["moe_aux"] if aux is None else aux + metrics["moe_aux"]
    return ctx.constrain(x), aux


def _layers(params: dict, cfg: ArchConfig, ctx: ModelCtx) -> list[dict]:
    """Every layer's parameters, in layer order. In the mesh layout
    (`distributed/sharding.py::to_mesh_layout`) each stacked leaf is
    gathered whole over every mesh axis but `model`, once (GSPMD gathers a
    stack sharded on its super-block dim before the scan over it; the
    gradient leaves as the reduce-scatter back to its placement), and each
    layer reads its row."""
    stacks = params.get(shd.STACKS)
    if stacks is None:
        return params["blocks"]
    gathered = [shd.map_with_path(s, lambda _, t: ctx.unshard(t)) for s in stacks]
    rows = shd.layer_rows(gathered, cfg.n_superblocks())
    return [shd.with_rows(p, r) for p, r in zip(params["blocks"], rows)]


def _layer_stack(params: dict, x: Tensor, cfg: ArchConfig, *, attend, ctx: ModelCtx,
                 state: list[LayerState] | None = None, remat: bool = False
                 ) -> tuple[Tensor, Tensor | None]:
    """The layer stack over a whole sequence, one super-block at a time
    (each checkpointed with `remat`); returns (x, the MoE aux summed per
    super-block, then over super-blocks, as the reference's scan sums it;
    None without a MoE layer)."""
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
    n = len(cfg.pattern())
    layers = _layers(params, cfg, ctx)
    aux = None
    for sb in range(cfg.n_superblocks()):
        run = functools.partial(_superblock, layers[sb * n:(sb + 1) * n],
                                cfg=cfg, positions=positions, attend=attend,
                                state=state, first=sb * n, ctx=ctx)
        x, a = checkpoint(_on_mesh(ctx, run), x, use_reentrant=False) if remat else run(x)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _on_mesh(ctx: ModelCtx, fn=None):
    """DTensor's implicit replication of plain tensors (positions, masks)
    on a mesh, as a context (nothing without a mesh); with `fn`, `fn`
    run inside it (remat's recompute runs outside the caller's context)."""
    if fn is not None:
        def run(*args):
            with _on_mesh(ctx):
                return fn(*args)
        return run
    if ctx.mesh is None:
        return contextlib.nullcontext()
    return implicit_replication()


def forward(params: dict, tokens: Tensor, cfg: ArchConfig, *,
            frontend_embed: Tensor | None = None,
            ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, Tensor]:
    """tokens (B, S) -> (logits (B, S, V) float32, mean MoE aux loss per
    layer). Differentiable: plain attention cores, never the kernel."""
    with _on_mesh(ctx):
        x = ctx.constrain(_embed_inputs(params, tokens, cfg, frontend_embed, ctx))
        x, aux = _layer_stack(params, x, cfg, attend=attention_dense_core, ctx=ctx,
                              remat=ctx.remat)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return _logits(params, x, cfg, ctx), aux / max(cfg.n_layers, 1)


def _token_terms(logits: Tensor, targets: Tensor) -> tuple[Tensor, Tensor]:
    """Mean next-token NLL and z-loss term (mean logZ^2) over the tokens."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (logz - gold).mean(), (logz ** 2).mean()


def _sharded_token_terms(logits: DTensor, targets: Tensor, ctx: ModelCtx
                         ) -> tuple[Tensor, Tensor]:
    """`_token_terms` on a mesh: each rank's rows, the vocab gathered, then
    the mean of the ranks' means over the batch axes (equal shards: the
    global mean; one rank: its own, bitwise). The gradient stays
    batch-sharded (DTensor's rule for the gather's backward replicates it)."""
    mesh = ctx.mesh
    pl = ctx.local_placements(logits)
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim, run_check=False)
    terms = _token_terms(logits.redistribute(mesh, pl).to_local(),
                         targets.redistribute(mesh, pl).to_local())
    for i, (p, name) in enumerate(zip(pl, mesh.mesh_dim_names)):
        if p != Replicate():
            terms = tuple(col.pmean(t, mesh.get_group(name)) for t in terms)
    return tuple(DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
                 for t in terms)


def loss_fn(params: dict, tokens: Tensor, targets: Tensor, cfg: ArchConfig, *,
            frontend_embed: Tensor | None = None,
            ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, dict]:
    """Next-token cross-entropy (+ MoE aux + z-loss). targets = shifted ids.
    Returns (loss, {"nll", "zloss", "moe_aux"}), float32 scalars
    (replicated DTensors on a mesh)."""
    logits, aux = forward(params, tokens, cfg, frontend_embed=frontend_embed, ctx=ctx)
    with _on_mesh(ctx):
        if isinstance(logits, DTensor):
            nll, z2 = _sharded_token_terms(logits, targets, ctx)
        else:
            nll, z2 = _token_terms(logits, targets)
        zloss = 1e-4 * z2
        moe_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
        loss = nll + zloss + moe_w * aux
    return loss, {"nll": nll, "zloss": zloss, "moe_aux": aux}


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
    prefills SSM and hybrid archs at the prompt's exact length. On a mesh
    the caches are DTensors placed by `decode_state_specs`.
    """
    with _on_mesh(ctx):
        x = _embed_inputs(params, tokens, cfg, frontend_embed, ctx)
        b, s = tokens.shape
        state: list[LayerState] = [
            init_cache(b, max_len, cfg.n_kv_heads_eff, cfg.head_dim,
                       quantized=ctx.kv_quantized, dtype=x.dtype, device=x.device)
            if kind == "attn" else None  # filled by the layer's prefill
            for kind in _kinds(cfg)]
        if ctx.mesh is not None:
            plan = shd.ShardingPlan.for_mesh(ctx.mesh)
            state = shd.distribute(state, shd.decode_state_specs(cfg, state, ctx.mesh, plan),
                                   ctx.mesh)
        x, _ = _layer_stack(params, x, cfg, attend=attention_core, ctx=ctx, state=state)
        at = s - 1 if logit_index is None else max(0, min(int(logit_index), s - 1))
        return _logits(params, x[:, at:at + 1], cfg, ctx), state


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _decode_layers(params: dict, x: Tensor, state: list[LayerState], cfg: ArchConfig,
                   positions: Tensor, write, length, ctx: ModelCtx) -> Tensor:
    for i, (p, kind) in enumerate(zip(_layers(params, cfg, ctx), _kinds(cfg))):
        p = ctx.unshard(p)
        x = ctx.constrain(x)
        h = rms_norm(x, p["norm1"]["scale"], cfg.norm_eps)
        if kind == "attn":
            qkv = qkv_project(p["attn"], h, cfg, positions)
            write(state[i], qkv.k, qkv.v)
            k, v = read_cache(state[i], x.dtype)
            att = mask_padded_heads(_decode_attention(qkv.q, k, v, length, ctx), cfg)
            x = x + attention_out(p["attn"], att)
        else:
            y, state[i] = m2.mamba2_decode_step(p["mamba"], h, state[i], cfg)
            x = x + y
        x, _ = _ffn(p, x, cfg, ctx)
    return x


def decode_step(params: dict, state: list[LayerState], tokens: Tensor, cur_len: int,
                cfg: ArchConfig, *, frontend_embed: Tensor | None = None,
                ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[LayerState]]:
    """One-token decode. tokens (B, 1); `cur_len` = tokens so far (one for
    every row). The new token's K/V is written at index cur_len and it
    attends to cache[:cur_len + 1]. `state` is updated in place."""
    cur_len = int(cur_len)
    with _on_mesh(ctx):
        x = _embed_inputs(params, tokens, cfg, frontend_embed, ctx)
        positions = torch.full((1, 1), cur_len, dtype=torch.int32, device=x.device)
        x = _decode_layers(params, x, state, cfg, positions,
                           lambda c, k, v: write_cache(c, k, v, cur_len), cur_len + 1, ctx)
        return _logits(params, x, cfg, ctx), state


def decode_step_batched(params: dict, state: list[LayerState], tokens: Tensor,
                        lengths: Tensor, cfg: ArchConfig, *,
                        frontend_embed: Tensor | None = None,
                        ctx: ModelCtx = ModelCtx()) -> tuple[Tensor, list[LayerState]]:
    """Continuous-batching decode: per-slot lengths (B,) on the tokens'
    device. Each slot's new K/V is written at its own position and it
    attends to its own `lengths[b] + 1` cache entries. In place."""
    x = _embed_inputs(params, tokens, cfg, frontend_embed, ctx)
    positions = lengths[:, None].to(torch.int32)  # per-slot RoPE position
    x = _decode_layers(params, x, state, cfg, positions,
                       lambda c, k, v: write_cache_batched(c, k, v, lengths),
                       lengths + 1, ctx)
    return _logits(params, x, cfg, ctx), state


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
