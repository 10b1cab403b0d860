"""Production mesh construction, as `DeviceMesh`es over the default
process group.

Counterpart of `repro.launch.mesh`. Functions, not module-level
constants: importing this module touches no device or process-group
state. There is no implicit group: the caller initializes one
(`torch.distributed.init_process_group`, or `distributed.emvs.
local_process_group`), and without one both functions raise as
`distributed.emvs.make_segment_mesh` does. The mesh's device type
follows the group's backend: the card under NCCL, the CPU under gloo.

Mesh semantics (the reference's, one rank per card):
  single-pod: (data=16, model=16)            — 256 ranks
  multi-pod:  (pod=2, data=16, model=16)     — 512 ranks

`model` is the TP/EP axis; `data` is data parallel + FSDP; `pod` is
cross-pod data parallel.
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def _device_type() -> str:
    if not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs a process group: call "
            "torch.distributed.init_process_group (one rank per card, or gloo "
            "ranks on the CPU) before building it")
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """(data=16, model=16), or (pod=2, data=16, model=16) with `multi_pod`,
    over every rank of the default group, which must hold that many."""
    device_type = _device_type()
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = dist.get_world_size()
    if n != math.prod(shape):
        raise ValueError(
            f"the {'multi' if multi_pod else 'single'}-pod mesh {shape} needs "
            f"{math.prod(shape)} ranks; the default process group has {n}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1) -> DeviceMesh:
    """A small ("data", "model") mesh over the default group's ranks, for
    tests and examples: `data` is cut to what the ranks allow."""
    device_type = _device_type()
    n = dist.get_world_size()
    data = min(data, n // max(model, 1))
    return init_device_mesh(device_type, (max(data, 1), max(model, 1)),
                            mesh_dim_names=("data", "model"))
