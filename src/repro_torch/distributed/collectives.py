"""Collectives with the gradients of JAX's `shard_map` bodies.

Counterpart of the `jax.lax` collectives the reference's `shard_map`
bodies call (`psum`, `pmean`, `pmax`, `all_gather`, `all_to_all`). In a
body, a value is either the same on every rank of an axis (invariant: an
input the axis does not split, or a `psum`'s result) or different per rank
(varying). JAX tracks which, and transposes each collective to match:

* `enter(x)`: an invariant value used in a varying computation. Forward
  the identity; backward the sum of every rank's cotangent (each rank's
  share of the gradient is partial). JAX's implicit `pvary`.
* `psum(x)`: varying partial results summed into an invariant value.
  Forward the all-reduce; backward the identity (the cotangent is already
  the same on every rank). Megatron's "reduce from the model-parallel
  region"; with `enter` it is its "copy to" pair.
* `pmean_invariant(x)`: the mean of a value that is already invariant
  (`psum(enter(x)) / n`), whose gradient is the cotangent itself.
* `all_gather(x, dim)`: tiled gather; backward the rank's slice of the
  summed cotangents (a reduce-scatter).
* `all_to_all(x)`: dim 0 split evenly across ranks and exchanged; the
  backward is the same exchange.

`axis` is a process group (a `DeviceMesh` dim's group, `mesh.get_group`);
None means no axis: each function is then the identity, so a body runs
unchanged on one device. gloo and NCCL both reduce float32 and bfloat16.
The collectives are PyTorch's functional ones (`_c10d_functional`), which
fake tensors trace and `launch/graph_analysis.py` counts.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol

Tensor = torch.Tensor


def axis_size(axis) -> int:
    return 1 if axis is None else dist.get_world_size(axis)


def axis_index(axis) -> int:
    return 0 if axis is None else dist.get_rank(axis)


def _all_reduce(x: Tensor, axis, op: str = "sum") -> Tensor:
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, axis))


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return funcol.wait_tensor(funcol.all_gather_tensor(x.contiguous(), dim, axis))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.reduce_scatter_tensor(
            g.contiguous(), "sum", ctx.dim, ctx.axis)), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return funcol.wait_tensor(funcol.all_to_all_single(x.contiguous(), None, None, axis))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_to_all_single(g.contiguous(), None, None,
                                                           ctx.axis)), None


def enter(x: Tensor, axis) -> Tensor:
    return x if axis is None else _Enter.apply(x, axis)


def psum(x: Tensor, axis) -> Tensor:
    return x if axis is None else _Psum.apply(x, axis)


def pmean_invariant(x: Tensor, axis) -> Tensor:
    if axis is None:
        return x
    return psum(enter(x, axis), axis) / axis_size(axis)


def pmean(x: Tensor, axis) -> Tensor:
    """Mean of a varying value (every rank's cotangent share is 1/n)."""
    return x if axis is None else psum(x, axis) / axis_size(axis)


def pmax(x: Tensor, axis) -> Tensor:
    """Elementwise max over the axis (no gradient)."""
    return x if axis is None else _all_reduce(x.detach(), axis, "max")


def all_gather(x: Tensor, axis, dim: int) -> Tensor:
    return x if axis is None else _AllGather.apply(x, axis, dim)


def all_to_all(x: Tensor, axis) -> Tensor:
    """(n * k, ...) split in n blocks on dim 0; block j goes to rank j, and
    block j of the result came from rank j."""
    return x if axis is None else _AllToAll.apply(x, axis)
