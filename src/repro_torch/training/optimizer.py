"""AdamW + cosine schedule, written out (no torch.optim).

Counterpart of `repro.training.optimizer`, with its semantics: the global
gradient norm over every leaf, clip scale min(1, clip / max(norm, 1e-12)),
bias corrections 1 - b ** t at float32, weight decay on leaves of two or
more dimensions in the reference's stacked layout only (`_decays`), the
update math in float32 whatever the stored
dtypes, m and v stored in `state_dtype` (bf16 halves optimizer memory),
and each new parameter cast back to its own dtype. `torch.optim.AdamW`
and `clip_grad_norm_` differ from it (decoupled decay on every leaf, a
clip by the norm plus 1e-6), so the update is written here with
`torch._foreach_*` operations over groups of leaves.

Trees are nested dicts, lists and tuples of tensors (`torch.utils._pytree`).
`adamw_update` updates parameters, m and v IN PLACE and returns the same
tensors in the new trees. The step counter and every scalar (learning
rate, norm, clip scale, bias corrections) stay tensors on the parameters'
device, so an update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

Tensor = torch.Tensor

# elements per group of leaves updated together: bounds the float32
# temporaries (about five copies of a group) while keeping launches few
GROUP_ELEMENTS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32  # bf16 halves optimizer memory


class OptState(NamedTuple):
    step: Tensor  # () int32, on the parameters' device
    m: Any  # tree like params
    v: Any


def cosine_lr(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * peak (float32)."""
    s = step.to(torch.float32)
    warm = cfg.peak_lr * s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Any, cfg: AdamWConfig) -> OptState:
    leaves = pytree.tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)  # noqa: E731
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=pytree.tree_map(zeros, params), v=pytree.tree_map(zeros, params))


def global_norm(tree: Any) -> Tensor:
    """sqrt of the float32 sum of squares over every leaf. Each leaf's norm
    is taken in float32 and the squares summed in leaf order, which is
    not XLA's association: within float32 rounding of the reference."""
    leaves = pytree.tree_leaves(tree)
    norms = torch._foreach_norm(leaves, 2, dtype=torch.float32)
    return torch.sqrt(torch.sum(torch.stack(norms) ** 2))


def _decays(path: tuple, p: Tensor) -> bool:
    """Weight decay applies to the reference's matrices: leaves of two or
    more dimensions in ITS layout. There every layer leaf is stacked over
    super-blocks on a leading axis, so a leaf under the port's top-level
    `blocks` list (one layer's slice) counts one dimension more: block
    norms, biases and Mamba-2's A_log, dt_bias and D decay, the final norm
    does not. A leaf a mesh layout holds stacked (under `stacks`) has that
    axis already."""
    stacked = bool(path) and getattr(path[0], "key", None) == "blocks"
    return p.dim() + stacked >= 2


def _groups(n: int, sizes: list[int]) -> list[range]:
    """Consecutive ranges of leaf indices, each within GROUP_ELEMENTS
    elements unless one leaf alone exceeds it."""
    out, start, total = [], 0, 0
    for i in range(n):
        if i > start and total + sizes[i] > GROUP_ELEMENTS:
            out.append(range(start, i))
            start, total = i, 0
        total += sizes[i]
    if n:
        out.append(range(start, n))
    return out


def _f32(ts: list[Tensor]) -> list[Tensor]:
    return [t.to(torch.float32) for t in ts]


def _copy_(dst: list[Tensor], src: list[Tensor]) -> None:
    """`torch._foreach_copy_`; DTensors (a sharded state, where DTensor has
    no rule for it) shard by shard, both sides in the same placements."""
    if dst and isinstance(dst[0], DTensor):
        for d, s in zip(dst, src):
            if d.placements != s.placements:
                raise ValueError(f"copy from {s.placements} into {d.placements}")
        dst, src = [d.to_local() for d in dst], [s.to_local() for s in src]
    torch._foreach_copy_(dst, src)


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: OptState, cfg: AdamWConfig
                 ) -> tuple[Any, OptState, dict]:
    """One AdamW step in place; returns (params, OptState, {"lr", "grad_norm"})."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    # clip / max(gnorm, eps) as one float32 division (a Python scalar over
    # a tensor would take the reciprocal first)
    scale = torch.clamp_max(torch.full_like(gnorm, cfg.grad_clip)
                            / torch.clamp_min(gnorm, 1e-12), 1.0)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)

    p_paths, spec = pytree.tree_flatten_with_path(params)
    p_leaves = [p for _, p in p_paths]
    decays = [_decays(path, p) for path, p in p_paths]
    g_leaves = pytree.tree_leaves(grads)
    m_leaves = pytree.tree_leaves(state.m)
    v_leaves = pytree.tree_leaves(state.v)
    if not len(p_leaves) == len(g_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError("adamw_update: params, grads, m and v differ in leaves")
    for idx in _groups(len(p_leaves), [p.numel() for p in p_leaves]):
        ps = [p_leaves[i] for i in idx]
        g = torch._foreach_mul(_f32([g_leaves[i] for i in idx]), scale)
        m32 = torch._foreach_mul(_f32([m_leaves[i] for i in idx]), cfg.b1)
        torch._foreach_add_(m32, torch._foreach_mul(g, 1 - cfg.b1))
        gg = torch._foreach_mul(g, 1 - cfg.b2)
        torch._foreach_mul_(gg, g)
        v32 = torch._foreach_mul(_f32([v_leaves[i] for i in idx]), cfg.b2)
        torch._foreach_add_(v32, gg)
        del g, gg
        delta = torch._foreach_div(m32, bc1)  # mhat
        denom = torch._foreach_div(v32, bc2)  # vhat
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(delta, denom)
        del denom
        p32 = _f32(ps)
        mats = [j for j, i in enumerate(idx) if decays[i]]
        if mats:
            torch._foreach_add_([delta[j] for j in mats],
                                torch._foreach_mul([p32[j] for j in mats], cfg.weight_decay))
        torch._foreach_mul_(delta, lr)
        newp = torch._foreach_sub(p32, delta)
        del delta, p32
        _copy_(ps, newp)
        _copy_([m_leaves[i] for i in idx], m32)
        _copy_([v_leaves[i] for i in idx], v32)
    return (pytree.tree_unflatten(p_leaves, spec),
            OptState(step=step, m=state.m, v=state.v),
            {"lr": lr, "grad_norm": gnorm})
