"""TrainState checkpointing on top of `distributed.fault_tolerance`.

Counterpart of `repro.training.checkpoint`. Checkpoints hold the
reference's logical layout, so either package restores what the other
saved: the state as {"params", "opt": (step, m, v)}, each tree in the
reference's stacked super-block layout (`interop.lm_params_stacked`), keys
such as `params/blocks/0/attn/wq/w` and `opt/m/embed/table`. The stacking
needs the arch's layer pattern, so `save` and `restore` take its config.
Restoring onto a mesh (`shardings=`) waits for ROADMAP A7b.
"""
from __future__ import annotations

from typing import Any

from torch.utils import _pytree as pytree

from repro_torch import interop
from repro_torch.configs import ArchConfig
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import TrainState


def _stacked(state: TrainState, cfg: ArchConfig, to) -> dict:
    def tree(t):
        return interop.lm_params_stacked(pytree.tree_map(to, t), cfg)

    return {"params": tree(state.params),
            "opt": OptState(step=to(state.opt.step), m=tree(state.opt.m), v=tree(state.opt.v))}


def save(ckpt_dir: str, step: int, state: TrainState, cfg: ArchConfig, *,
         keep_last: int = 3, extra: dict | None = None) -> str:
    return ft.save_checkpoint(ckpt_dir, step,
                              _stacked(state, cfg, lambda t: t.detach().cpu()),
                              extra=extra, keep_last=keep_last)


def restore(ckpt_dir: str, step: int, like: TrainState, cfg: ArchConfig,
            shardings: Any = None) -> TrainState:
    """The state saved at `step`, in `like`'s layout and on its device, each
    leaf in the dtype it was saved in."""
    d = ft.restore_checkpoint(ckpt_dir, step, _stacked(like, cfg, lambda t: t.to("meta")),
                              shardings)
    dev = like.opt.step.device

    def layers(tree):
        return interop.lm_params_from_numpy(tree, cfg, device=dev)

    opt = d["opt"]
    return TrainState(params=layers(d["params"]),
                      opt=OptState(step=opt.step.to(dev), m=layers(opt.m), v=layers(opt.v)))


def latest(ckpt_dir: str) -> int | None:
    return ft.latest_step(ckpt_dir)
