"""TrainState checkpointing on top of `distributed.fault_tolerance`.

Counterpart of `repro.training.checkpoint`. Checkpoints hold the
reference's logical layout, so either package restores what the other
saved: the state as {"params", "opt": (step, m, v)}, each tree in the
reference's stacked super-block layout (`interop.lm_params_stacked`), keys
such as `params/blocks/0/attn/wq/w` and `opt/m/embed/table`. The stacking
needs the arch's layer pattern, so `save` and `restore` take its config.

A sharded state (DTensors) saves as full arrays: every rank calls `save`,
each gathers every leaf, rank 0 writes. `restore(shardings=)` is the
elastic path: every rank reads the full arrays and keeps its shard of
each leaf on the mesh of `shardings` (a TrainState of
`sharding.NamedSharding`s in the port's layout on that mesh, e.g.
`tree_shardings(state_specs(...), mesh)`: where that mesh holds leaves
stacked, `sharding.to_mesh_layout`), whatever mesh saved them. The
reference's stacked leaves are split per layer and restacked there, so
a stack sharded over `data` takes each rank's rows at any `data` size.
"""
from __future__ import annotations

import os
from typing import Any

import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch import interop
from repro_torch.configs import ArchConfig
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.distributed import sharding as shd
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState


def _host(t):
    """A leaf as a host tensor, a DTensor gathered whole (a collective)."""
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().cpu()


def _stacked(state: TrainState, cfg: ArchConfig, to) -> dict:
    def tree(t):
        return interop.lm_params_stacked(pytree.tree_map(to, t), cfg)

    return {"params": tree(state.params),
            "opt": OptState(step=to(state.opt.step), m=tree(state.opt.m), v=tree(state.opt.v))}


def save(ckpt_dir: str, step: int, state: TrainState, cfg: ArchConfig, *,
         keep_last: int = 3, extra: dict | None = None) -> str:
    tree = _stacked(state, cfg, _host)
    sharded = any(isinstance(t, DTensor) for t in pytree.tree_leaves(state.params))
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return os.path.join(ckpt_dir, f"step_{step:010d}")
    path = ft.save_checkpoint(ckpt_dir, step, tree, extra=extra, keep_last=keep_last)
    if sharded:
        dist.barrier()
    return path


def restore(ckpt_dir: str, step: int, like: TrainState, cfg: ArchConfig,
            shardings: Any = None) -> TrainState:
    """The state saved at `step`, in `like`'s layout and on its device, each
    leaf in the dtype it was saved in; with `shardings`, each leaf (the
    step counter too, where its sharding is given) a DTensor placed by its
    sharding."""
    d = ft.restore_checkpoint(ckpt_dir, step, _stacked(like, cfg, lambda t: t.to("meta")))
    dev = like.opt.step.device
    if shardings is not None:
        def layers(tree, sh):
            full = shd.in_layout_of(interop.lm_params_from_numpy(tree, cfg, device="cpu"), sh)
            return pytree.tree_map(lambda t, s: s.place(t), full, sh)

        opt = d["opt"]
        return TrainState(params=layers(d["params"], shardings.params),
                          opt=OptState(step=opt.step.to(dev), m=layers(opt.m, shardings.opt.m),
                                       v=layers(opt.v, shardings.opt.v)))

    def layers(tree):
        return interop.lm_params_from_numpy(tree, cfg, device=dev)

    opt = d["opt"]
    return TrainState(params=layers(d["params"]),
                      opt=OptState(step=opt.step.to(dev), m=layers(opt.m), v=layers(opt.v)))


def latest(ckpt_dir: str) -> int | None:
    return ft.latest_step(ckpt_dir)
