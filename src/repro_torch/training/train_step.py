"""Train step: loss -> grads -> AdamW, with remat, microbatch
gradient accumulation, mixed precision and mesh-aware sharding.

Counterpart of `repro.training.train_step`. The step is eager PyTorch:
`torch.autograd.grad` of `models.model.loss_fn` (plain attention cores;
`remat` checkpoints each super-block), then the in-place `adamw_update`.
Microbatches split the global batch the reference's interleaved way
(microbatch i takes rows i, i + mb, i + 2 mb, ...), their gradients summed
in float32 and averaged, as are the loss and its parts.

On a mesh the state is DTensors placed by `state_specs` (the reference's
in/out shardings) and the batch is split over the batch axes; DTensor
inserts the collectives GSPMD inserts. `state_specs` gives the specs of
the mesh layout (`distributed/sharding.py`: the leaves whose super-block
dim the reference's FSDP shards held stacked), and `place_state` moves
the parameters, m and v into it, so the step, AdamW and the checkpoints
see one tree. Each gradient is redistributed to
its parameter's placements, and the float32 microbatch accumulator is
replicated, or with `grad_acc_sharded` held in the parameters' placements.
The mesh-only `TrainOptions` fields are ignored without a mesh, as in the
reference. `lower_train_step` traces the sharded step on fake tensors
(there is no AOT compiler to call).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed.tensor as dtensor
from torch.distributed.tensor import Replicate
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.expert_parallel import EPShard
from repro_torch.models import model as M
from repro_torch.training.optimizer import AdamWConfig, OptState, adamw_update, init_opt_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TrainOptions:
    microbatches: int = 1  # gradient-accumulation steps
    remat: bool = True  # checkpoint each super-block
    param_dtype: Any = torch.bfloat16
    opt: AdamWConfig = AdamWConfig()
    use_ep: bool = True  # expert parallelism for MoE archs (needs a mesh)
    # the reference's performance knobs; each acts on a mesh only
    grad_acc_sharded: bool = False
    moe_combine_bf16: bool = False
    ep_dispatch: str = "psum"  # psum | a2a
    ep_zero3: bool = False
    seq_parallel: bool = False


class TrainState(NamedTuple):
    params: Any
    opt: OptState


def make_model_ctx(cfg: ArchConfig, mesh: Optional[Any], opts: TrainOptions) -> M.ModelCtx:
    if mesh is None:
        return M.ModelCtx(remat=opts.remat)
    names = tuple(mesh.mesh_dim_names)
    sizes = shd.axis_sizes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    ep = None
    if (opts.use_ep and cfg.moe is not None and sizes.get("model", 1) > 1
            and cfg.moe.num_experts % sizes["model"] == 0):
        ep = EPShard(mesh, token_axes=batch_axes, dispatch=opts.ep_dispatch,
                     combine_dtype=torch.bfloat16 if opts.moe_combine_bf16 else torch.float32,
                     zero3=opts.ep_zero3 and "data" in names)
    seq_axis = None
    if opts.seq_parallel and sizes.get("model", 1) > 1:
        # sequence parallelism: activations between blocks carry (batch
        # over data) x (sequence over model)
        seq_axis = "model"
    return M.ModelCtx(ep_shard=ep, remat=opts.remat, mesh=mesh,
                      batch_axes=batch_axes, seq_axis=seq_axis)


def init_train_state(generator: torch.Generator, cfg: ArchConfig, opts: TrainOptions, *,
                     device=None) -> TrainState:
    """Parameters drawn from `generator` (which lives on `device`: the card
    unless "cpu") in `opts.param_dtype`, and zeroed optimizer state."""
    params = M.init_params(cfg, generator=generator, dtype=opts.param_dtype, device=device)
    return TrainState(params=params, opt=init_opt_state(params, opts.opt))


def make_train_step(cfg: ArchConfig, opts: TrainOptions,
                    mesh: Optional[Any] = None) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics).

    batch["tokens"/"targets"]: integer tensors (global_batch, seq) on the
    parameters' device (and "frontend_embed" where the arch has one); on a
    mesh, DTensors or plain tensors (the same on every rank, split over
    the batch axes here). The step updates `state` in place and returns
    it; metrics {"loss", "nll", "zloss", "moe_aux", "lr", "grad_norm"} are
    float32 device scalars (replicated DTensors on a mesh), so a step
    never waits for the host."""
    ctx = make_model_ctx(cfg, mesh, opts)
    n = opts.microbatches
    plan = shd.ShardingPlan.for_mesh(mesh) if mesh is not None else None

    def grads_of(leaves, spec, mb: dict):
        live = [p.detach().requires_grad_() for p in leaves]
        loss, aux = M.loss_fn(pytree.tree_unflatten(live, spec), mb["tokens"].long(),
                              mb["targets"].long(), cfg,
                              frontend_embed=mb.get("frontend_embed"), ctx=ctx)
        with M._on_mesh(ctx):
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        if mesh is not None:  # each gradient in its parameter's placements
            grads = [g.redistribute(p.device_mesh, p.placements) for g, p in zip(grads, leaves)]
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    def place(x: Tensor) -> Tensor:
        if mesh is None:
            return x
        return shd.constrain(x, mesh, shd.batch_spec(tuple(x.shape), mesh, plan))

    def split(x: Tensor) -> Tensor:
        """(B, ...) -> (mb, B/mb, ...), interleaved: row r goes to
        microbatch r % mb; on a mesh each microbatch stays split over the
        batch axes (each rank keeps its own rows)."""
        y = x.reshape((x.shape[0] // n, n) + tuple(x.shape[1:])).transpose(0, 1)
        if mesh is None:
            return y
        return shd.constrain(y, mesh, shd.P(None, tuple(ctx.batch_axes) or None))

    def acc_zeros(p: Tensor) -> Tensor:
        if mesh is None or opts.grad_acc_sharded:
            return torch.zeros_like(p, dtype=torch.float32)
        return dtensor.zeros(p.shape, dtype=torch.float32, device_mesh=mesh,
                             placements=[Replicate()] * mesh.ndim)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        leaves, spec = pytree.tree_flatten(state.params)
        batch = {k: place(v) for k, v in batch.items()}
        if n == 1:
            loss, aux, grads = grads_of(leaves, spec, batch)
        else:
            mbatch = {k: split(v) for k, v in batch.items()}
            with torch.no_grad():
                grads = [acc_zeros(p) for p in leaves]
            loss, aux = 0.0, {"nll": 0.0, "zloss": 0.0, "moe_aux": 0.0}
            for i in range(n):
                l_i, a_i, g_i = grads_of(leaves, spec, {k: v[i] for k, v in mbatch.items()})
                with torch.no_grad():
                    if mesh is not None and not opts.grad_acc_sharded:
                        g_i = [g.redistribute(mesh, [Replicate()] * mesh.ndim) for g in g_i]
                    torch._foreach_add_(grads, g_i)
                del g_i
                loss = loss + l_i
                aux = {k: aux[k] + a_i[k] for k in aux}
            with torch.no_grad():
                torch._foreach_div_(grads, float(n))
                if mesh is not None:
                    grads = [g.redistribute(p.device_mesh, p.placements)
                             for g, p in zip(grads, leaves)]
            loss = loss / n
            aux = {k: v / n for k, v in aux.items()}
        with M._on_mesh(ctx):
            params, opt, opt_metrics = adamw_update(
                state.params, pytree.tree_unflatten(grads, spec), state.opt, opts.opt)
        metrics = {"loss": loss, **aux, **opt_metrics}
        return TrainState(params=params, opt=opt), metrics

    return train_step


# ---------------------------------------------------------------------------
# Sharded state and the traced step for a mesh
# ---------------------------------------------------------------------------


def state_specs(cfg: ArchConfig, state: TrainState, mesh, plan: shd.ShardingPlan
                ) -> TrainState:
    """A `P` per leaf of the train state in its layout on `mesh`: the
    parameters' specs (`param_specs`, the mesh layout) for the parameters,
    m and v; the step counter replicated. `state` may be in either layout."""
    p_specs = shd.param_specs(cfg, state.params, mesh, plan)
    return TrainState(params=p_specs, opt=OptState(step=shd.P(), m=p_specs, v=p_specs))


def place_state(state: TrainState, specs: TrainState, mesh, *,
                src_data_rank: int | None = 0) -> TrainState:
    """The state placed on `mesh` by `specs` (DTensors; the step counter
    stays a plain tensor, the same on every rank), moved into the specs'
    mesh layout where it is one dict per layer (`sharding.distribute`)."""
    def place(tree, spec):
        return shd.distribute(tree, spec, mesh, src_data_rank=src_data_rank)

    return TrainState(params=place(state.params, specs.params),
                      opt=OptState(step=state.opt.step, m=place(state.opt.m, specs.opt.m),
                                   v=place(state.opt.v, specs.opt.v)))


def lower_train_step(cfg: ArchConfig, opts: TrainOptions, mesh, plan: shd.ShardingPlan,
                     input_specs: dict, *, fake=None, device=None):
    """Trace the sharded train step on fake tensors over `mesh` (the
    counterpart of the reference's AOT lowering): the state is drawn on
    fake tensors of `device` (the card unless "cpu"), placed by
    `state_specs`, and one step runs on `input_specs` (fake or meta batch
    tensors) under `launch.graph_analysis.analyze`. Returns
    ((out, stats, mode), state) — what `analyze` returns, and the placed
    state, whose local shards give one rank's bytes."""
    from repro_torch.device import resolve_device
    from repro_torch.launch import graph_analysis as ga

    dev = resolve_device(device)
    fake = fake if fake is not None else ga.fake_mode()
    step = make_train_step(cfg, opts, mesh)
    with fake:
        state = init_train_state(None, cfg, opts, device=dev)
    sspec = state_specs(cfg, state, mesh, plan)
    with fake:  # every rank holds the same fake tensors: no broadcast
        placed = place_state(state, sspec, mesh, src_data_rank=None)
        batch = {k: (v if v.device.type != "meta" else torch.empty(v.shape, dtype=v.dtype,
                                                                   device=dev))
                 for k, v in input_specs.items()}
    return ga.analyze(step, placed, batch, fake=fake), placed
