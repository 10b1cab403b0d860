"""FLOPs, HBM bytes and live memory of a program traced on fake tensors.

Counterpart of `repro.launch.hlo_analysis`, which parses the compiled HLO
text of a jitted step. The port runs eagerly, so the program it would
launch is the sequence of aten operations its Python code dispatches:
`GraphAnalysisMode`, a `TorchDispatchMode`, records every one of them
while the program runs on fake tensors (`FakeTensorMode`: shapes, dtypes
and devices, no storage, nothing launched). For each operation:

  * FLOPs: `torch.utils.flop_counter`'s formulas (matmuls, convolutions,
    attention; elementwise work counts zero, as the reference counts dots
    only) and, for the port's three hand-written kernels, their declared
    work from `launch/roofline.py` (B1's 9 float32 operations per event
    and plane, every event counted valid since fake tensors hold no data;
    B2's 2 per voxel; B3's causal product FLOPs);
  * bytes read and written: each tensor input's distinct elements
    (a broadcast dimension counts once) and each output, at their dtype's
    width; the kernels' declared bytes (each input once, each output once);
  * whether it materializes: a view only re-describes a tensor and moves
    nothing; every other operation is one eager launch that reads its
    inputs and writes its outputs in device memory.

`hbm_bytes` sums the materializing operations' traffic: eager PyTorch
fuses nothing, so unlike the reference's XLA model no elementwise chain
is free. The reference's `trip_count` and `multiplicities` have no
counterpart: a Python loop is unrolled as it runs, so every iteration's
operations are recorded and the counts are already multiplied.
Collectives are counted by the result bytes of `_c10d_functional`
operations (DTensor's) and of the `c10d` operations a process group's
eager collectives dispatch (`distributed/emvs.py`'s all-reduce and
all-gather).

`peak_temp_bytes` is the most bytes the program's own allocations held at
once (inputs excluded), tracked by the lifetime of every tensor an
operation allocates.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch import roofline as rf

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_EAGER_COLLECTIVES = {"allreduce_": "all-reduce", "_allgather_base_": "all-gather"}
_ALLOCATE_ONLY = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements `t` addresses: a dimension of stride 0
    (a broadcast) counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors among a pytree's leaves."""
    leaves, _ = tree_flatten(tree)
    return [x for x in leaves if isinstance(x, torch.Tensor)]


@dataclasses.dataclass
class OpStat:
    """One dispatched operation."""

    name: str  # e.g. "aten.mm.default", "repro_torch.backproject_vote.default"
    flops: float
    flops_dtype: str  # dtype of the operands the FLOPs run on
    bytes_read: int
    bytes_written: int
    materializes: bool
    outputs: tuple  # (dtype name, shape) per tensor output


@dataclasses.dataclass
class GraphStats:
    """The totals of one traced program, in the reference's `HloStats` shape."""

    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_counts: dict[str, float]
    collective_bytes_by_kind: dict[str, float]
    flops_by_dtype: dict[str, float]
    n_ops: int
    n_materializing: int
    peak_temp_bytes: int
    by_op: dict[str, dict[str, float]]  # name -> count, flops, bytes

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def _declared_work(func, args, out) -> tuple[float, str, int, int] | None:
    """`(flops, dtype, bytes_read, bytes_written)` of a hand-written kernel
    from `launch/roofline.py`, or None for any other operation."""
    name = func.overloadpacket.__name__
    if func.namespace != "repro_torch":
        return None
    if name == "backproject_vote":
        x0, _, _, phi, _, _, w, h, _, quantized, _ = args
        s, c, e = x0.shape
        nz = phi.shape[2]
        nbytes = rf.sweep_bytes(s, c, e, nz, w, h, quantized)
        written = tensor_bytes(out)
        return float(rf.sweep_ops(nz, s * c * e)), "float32", nbytes - written, written
    if name == "depth_argmax":
        dsi = args[0]
        s, nz, h, w = dsi.shape
        total = rf.depth_argmax_bytes(s, nz, h, w, dsi.element_size())
        read = dsi.element_size() * s * nz * h * w
        return float(rf.B2_OPS_PER_VOXEL * s * nz * h * w), "float32", read, total - read
    if name == "flash_attention":
        q, k, _, causal = args
        b, hq, sq, d = q.shape
        nbytes, flops = rf.flash_work(b, hq, k.shape[1], sq, k.shape[2], d,
                                      q.element_size(), causal)
        written = tensor_bytes(out)
        return float(flops), str(q.dtype).replace("torch.", ""), nbytes - written, written
    return None


class GraphAnalysisMode(TorchDispatchMode):
    """Records every dispatched operation (see the module docstring).

    Enter it inside a `FakeTensorMode` (`analyze` does). `stats()` sums
    what was recorded; `ops` keeps every record when `keep_ops`."""

    def __init__(self, keep_ops: bool = True):
        super().__init__()
        self.keep_ops = keep_ops
        self.ops: list[OpStat] = []
        self._flops = 0.0
        self._hbm = 0
        self._flops_by_dtype: dict[str, float] = defaultdict(float)
        self._col_counts: dict[str, float] = defaultdict(float)
        self._col_bytes: dict[str, float] = defaultdict(float)
        self._by_op: dict[str, dict[str, float]] = {}
        self._n_ops = 0
        self._n_mat = 0
        self._live = 0
        self.peak_temp_bytes = 0
        self._paused = 0

    # DTensor infers each output's global shape by running the operation
    # on global-shape fake tensors (`ShardingPropagator.
    # _propagate_tensor_meta_non_cached`); that is no work of the program,
    # so the mode stands aside while it runs
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = next(n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
                    if hasattr(ShardingPropagator, n))
        real = getattr(ShardingPropagator, name)
        mode = self

        def paused(*args, **kwargs):
            mode._paused += 1
            try:
                return real(*args, **kwargs)
            finally:
                mode._paused -= 1

        self._restore = (name, real)
        setattr(ShardingPropagator, name, paused)
        return super().__enter__()

    def __exit__(self, *exc):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        setattr(ShardingPropagator, *self._restore)
        return super().__exit__(*exc)

    # --- live memory -------------------------------------------------------

    def _free(self, nbytes: int) -> None:
        self._live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        nbytes = t.numel() * t.element_size()
        self._live += nbytes
        self.peak_temp_bytes = max(self.peak_temp_bytes, self._live)
        weakref.finalize(t, self._free, nbytes)

    # --- recording ---------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._paused:
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            # a sharded program: DTensor runs the operation on each rank's
            # local shards, which this mode then records (one rank's work)
            return NotImplemented
        out = func(*args, **kwargs)
        if func.namespace != "prim":  # metadata reads (`.device`), not operations
            self._record(func, args, kwargs, out)
        return out

    def _record(self, func, args, kwargs, out) -> None:
        schema = func._schema
        ins = tensors_of((args, kwargs))
        outs = tensors_of(out)
        writes = [a for a, arg in zip(args, schema.arguments)
                  if isinstance(a, torch.Tensor) and arg.alias_info is not None
                  and arg.alias_info.is_write]
        aliased_out = any(r.alias_info is not None for r in schema.returns)
        name = str(func)
        short = func.overloadpacket.__name__
        declared = _declared_work(func, args, out)
        if declared is not None:
            flops, dtype, read, written = declared
            materializes = True
        else:
            view = aliased_out and not writes
            materializes = not view
            read = 0 if short in _ALLOCATE_ONLY or view else sum(
                tensor_bytes(t) for t in {id(t): t for t in ins}.values())
            written = 0 if short in _ALLOCATE_ONLY or view else (
                sum(tensor_bytes(t) for t in writes) if writes
                else sum(tensor_bytes(t) for t in outs))
            flops, dtype = self._flop_formula(func, args, kwargs, out, ins)
        if not aliased_out:
            for t in outs:
                self._allocated(t)
        kind = {"_c10d_functional": _COLLECTIVES, "c10d": _EAGER_COLLECTIVES}.get(
            func.namespace, {}).get(short)
        if kind is not None:
            payload = sum(tensor_bytes(t) for t in outs)
            self._col_counts[kind] += 1
            self._col_bytes[kind] += payload
        self._n_ops += 1
        self._flops += flops
        if flops:
            self._flops_by_dtype[dtype] += flops
        if materializes:
            self._n_mat += 1
            self._hbm += read + written
        row = self._by_op.setdefault(name, {"count": 0, "flops": 0.0, "bytes": 0})
        row["count"] += 1
        row["flops"] += flops
        row["bytes"] += (read + written) if materializes else 0
        if self.keep_ops:
            self.ops.append(OpStat(
                name, flops, dtype, read if materializes else 0,
                written if materializes else 0, materializes,
                tuple((str(t.dtype).replace("torch.", ""), tuple(t.shape)) for t in outs)))

    @staticmethod
    def _flop_formula(func, args, kwargs, out, ins) -> tuple[float, str]:
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func.overloadpacket)
        dtype = str(ins[0].dtype).replace("torch.", "") if ins else ""
        if formula is None:
            return 0.0, dtype
        return float(formula(*args, **kwargs, out_val=out)), dtype

    def stats(self) -> GraphStats:
        return GraphStats(
            flops=self._flops, hbm_bytes=float(self._hbm),
            collective_bytes=float(sum(self._col_bytes.values())),
            collective_counts=dict(self._col_counts),
            collective_bytes_by_kind=dict(self._col_bytes),
            flops_by_dtype=dict(self._flops_by_dtype), n_ops=self._n_ops,
            n_materializing=self._n_mat, peak_temp_bytes=self.peak_temp_bytes,
            by_op=dict(self._by_op))


def fake_mode():
    """A `FakeTensorMode` that turns any real tensor it meets (a cached
    constant, say) into a fake one instead of refusing it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


def analyze(fn: Callable[..., Any], *args, fake=None, keep_ops: bool = True,
            **kwargs) -> tuple[Any, GraphStats, GraphAnalysisMode]:
    """Run `fn(*args, **kwargs)` inside `fake` (a `fake_mode()`; the one its
    fake tensor arguments were made under) and a `GraphAnalysisMode`:
    `(result, stats, mode)`. Nothing is allocated and nothing launches: a
    tensor the program makes is fake too."""
    mode = GraphAnalysisMode(keep_ops=keep_ops)
    with fake if fake is not None else fake_mode(), mode:
        out = fn(*args, **kwargs)
    return out, mode.stats(), mode
