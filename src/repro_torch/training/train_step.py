"""Train step: loss -> grads -> AdamW, with remat, microbatch
gradient accumulation and mixed precision, on one card.

Counterpart of `repro.training.train_step` without a mesh. The step is
eager PyTorch: `torch.autograd.grad` of `models.model.loss_fn` (plain
attention cores; `remat` checkpoints each super-block), then the in-place
`adamw_update`. Microbatches split the global batch the reference's
interleaved way (microbatch i takes rows i, i + mb, i + 2 mb, ...), their
gradients summed in float32 and averaged, as are the loss and its parts.

The mesh-only `TrainOptions` fields are ignored without a mesh, as in the
reference; a mesh, `state_specs` and `lower_train_step` (the sharded,
compiled step) wait for ROADMAP A7b.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig
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


def _no_mesh(mesh: Optional[Any]) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a sharded train step (mesh=) is not ported yet: ROADMAP A7b "
            "(distributed/sharding.py, lower_train_step)")


def make_model_ctx(cfg: ArchConfig, mesh: Optional[Any], opts: TrainOptions) -> M.ModelCtx:
    _no_mesh(mesh)
    return M.ModelCtx(remat=opts.remat)


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
    parameters' device (and "frontend_embed" where the arch has one). The
    step updates `state` in place and returns it; metrics {"loss", "nll",
    "zloss", "moe_aux", "lr", "grad_norm"} are float32 device scalars, so
    a step never waits for the host."""
    ctx = make_model_ctx(cfg, mesh, opts)
    n = opts.microbatches

    def grads_of(leaves, spec, mb: dict):
        live = [p.detach().requires_grad_() for p in leaves]
        loss, aux = M.loss_fn(pytree.tree_unflatten(live, spec), mb["tokens"].long(),
                              mb["targets"].long(), cfg,
                              frontend_embed=mb.get("frontend_embed"), ctx=ctx)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        leaves, spec = pytree.tree_flatten(state.params)
        if n == 1:
            loss, aux, grads = grads_of(leaves, spec, batch)
        else:
            def split(x: Tensor) -> Tensor:
                """(B, ...) -> (mb, B/mb, ...), interleaved: row r goes to
                microbatch r % mb."""
                return x.reshape((x.shape[0] // n, n) + tuple(x.shape[1:])).transpose(0, 1)

            mbatch = {k: split(v) for k, v in batch.items()}
            with torch.no_grad():
                grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for p in leaves]
            loss, aux = 0.0, {"nll": 0.0, "zloss": 0.0, "moe_aux": 0.0}
            for i in range(n):
                l_i, a_i, g_i = grads_of(leaves, spec, {k: v[i] for k, v in mbatch.items()})
                with torch.no_grad():
                    torch._foreach_add_(grads, g_i)
                del g_i
                loss = loss + l_i
                aux = {k: aux[k] + a_i[k] for k in aux}
            with torch.no_grad():
                torch._foreach_div_(grads, float(n))
            loss = loss / n
            aux = {k: v / n for k, v in aux.items()}
        params, opt, opt_metrics = adamw_update(
            state.params, pytree.tree_unflatten(grads, spec), state.opt, opts.opt)
        metrics = {"loss": loss, **aux, **opt_metrics}
        return TrainState(params=params, opt=opt), metrics

    return train_step
