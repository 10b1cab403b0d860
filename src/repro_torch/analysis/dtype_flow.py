"""Abstract interpretation of aten graphs for quantization-contract linting.

Counterpart of `repro.analysis.dtype_flow`, which walks jaxprs. Here a
program runs on fake tensors (`FakeTensorMode`: shapes, dtypes and
devices; nothing is allocated or launched) while `trace_program` records
every aten operation it dispatches: its operands, its outputs, the tensors
it writes in place, and the Python line that called it. The recorded graph
is then walked, propagating per tensor:

- ``dtype`` — from the fake tensor;
- ``[lo, hi]`` — a sound worst-case interval, seeded from per-input
  contracts (e.g. "``valid`` is a 0/1 mask") and propagated through
  arithmetic, reductions, matmuls (interval x contraction size),
  scatter-adds (interval x update count) and collectives (interval x
  group size);
- ``integral`` — whether the value is provably integer-valued, the bit
  that tells a lossless int cast from one that discards fractional
  bilinear vote weights (the bilinear-truncation bug class), or a float-to-
  bool cast that turns fractional weights into whole votes (the port's
  fault C1);
- ``clip`` — literal clamp bounds the value just passed through: a
  narrowing cast is sanctioned only when its operand was clamped to a
  range a quant policy declares (e.g. int16's (-32768, 32767));
- ``known`` — whether the interval came from propagation rather than the
  dtype's default, so overflow findings are proofs, not guesses.

The graph is recorded by a `TorchDispatchMode` of its own, not by
`torch.fx.experimental.proxy_tensor.make_fx`: make_fx stops at the first
data-dependent operation (`.item()`, `nonzero`), which are exactly the
host syncs the linter must report and trace past, and it keeps no source
line per node. The recording holds what make_fx's graph holds (aten
operations over fake tensors, in execution order) plus provenance. A
Python loop is unrolled as it runs, so a loop-carried accumulation is
interpreted iteration by iteration: the reference's closed-form scan
growth has no counterpart. Views and in-place writes are followed through
alias groups: a write to a tensor widens every tensor sharing its storage.

The port's hand-written kernels enter as single operations with declared
output contracts (`repro_torch::backproject_vote`, `::depth_argmax`,
`::flash_attention`), the counterpart of the reference's recursion into
`pallas_call` bodies: B1 accumulates in int32 (every valid event of every
frame into one voxel at worst, published as a proof) and stores through
the int16 saturating clamp.

Rules observe every operation via ``Rule.on_node`` and the program outputs
via ``Rule.on_outputs``; the interpreter itself raises nothing.
"""
from __future__ import annotations

import dataclasses
import math
import os
import sys
from typing import Any, Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.analysis.findings import Finding, Provenance

Inf = float("inf")


@dataclasses.dataclass(frozen=True)
class AbsVal:
    """Abstract state of one tensor (or Python scalar) of the program."""

    dtype: Any  # torch dtype
    shape: tuple[int, ...] = ()
    weak_type: bool = False  # a Python scalar, not a tensor
    lo: float = -Inf
    hi: float = Inf
    integral: bool = False  # provably integer-valued
    known: bool = False  # interval from propagation, not the dtype default
    clip: tuple[float, float] | None = None  # literal clamp bounds just applied

    def with_(self, **kw: Any) -> "AbsVal":
        return dataclasses.replace(self, **kw)


def _is_bool(dtype: Any) -> bool:
    return dtype == torch.bool


def _is_int(dtype: Any) -> bool:
    return (isinstance(dtype, torch.dtype) and not dtype.is_floating_point
            and not dtype.is_complex and dtype != torch.bool)


def _is_float(dtype: Any) -> bool:
    return isinstance(dtype, torch.dtype) and dtype.is_floating_point


def int_range(dtype: Any) -> tuple[float, float]:
    info = torch.iinfo(dtype)
    return float(info.min), float(info.max)


def absval_default(dtype: Any, shape: tuple[int, ...] = ()) -> AbsVal:
    """The dtype's default state: bools are 0/1, ints their range (not
    "known": no proof about unconstrained inputs), floats unbounded."""
    if _is_bool(dtype):
        return AbsVal(dtype, shape, False, 0.0, 1.0, integral=True, known=True)
    if _is_int(dtype):
        lo, hi = int_range(dtype)
        return AbsVal(dtype, shape, False, lo, hi, integral=True, known=False)
    return AbsVal(dtype, shape, False, -Inf, Inf, integral=False, known=False)


def absval_of(t: torch.Tensor) -> AbsVal:
    """The default state of a (fake) tensor."""
    return absval_default(t.dtype, tuple(t.shape))


def contract(t: torch.Tensor, lo: float, hi: float, integral: bool = False) -> AbsVal:
    """An input contract: `t`'s values lie in [lo, hi] (integer-valued when
    `integral`), a promise about what callers feed the program."""
    return absval_of(t).with_(lo=float(lo), hi=float(hi), integral=bool(integral),
                              known=True)


def absval_from_literal(val: Any) -> AbsVal:
    """A Python number (or bool) operand."""
    if isinstance(val, bool):
        return AbsVal(torch.bool, (), True, float(val), float(val), True, True)
    if isinstance(val, int):
        return AbsVal(torch.int64, (), True, float(val), float(val), True, True)
    v = float(val)
    integral = math.isfinite(v) and v == math.floor(v)
    return AbsVal(torch.float32, (), True, v, v, integral, True)


def _hull(vals: Sequence[AbsVal], dtype: Any, shape: tuple[int, ...]) -> AbsVal:
    return AbsVal(dtype, shape, False,
                  min((v.lo for v in vals), default=-Inf),
                  max((v.hi for v in vals), default=Inf),
                  integral=all(v.integral for v in vals),
                  known=all(v.known for v in vals))


def _mul_bounds(a: AbsVal, b: AbsVal) -> tuple[float, float]:
    cands = []
    for x in (a.lo, a.hi):
        for y in (b.lo, b.hi):
            p = x * y
            cands.append(0.0 if math.isnan(p) else p)  # 0 * inf
    return min(cands), max(cands)


def _scale(n: float, lo: float, hi: float) -> tuple[float, float]:
    return (n * lo if math.isfinite(lo) else lo), (n * hi if math.isfinite(hi) else hi)


# ---------------------------------------------------------------------------
# Recording the program
# ---------------------------------------------------------------------------


class TRef:
    """A recorded tensor, by its index in the graph's tensor table."""

    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i

    def __repr__(self) -> str:
        return f"%{self.i}"


@dataclasses.dataclass
class Node:
    """One recorded operation."""

    target: str  # e.g. "aten._to_copy.default", "torch.cuda.synchronize"
    name: str  # the overload packet, e.g. "_to_copy"
    args: tuple  # tensors as TRef, everything else as passed
    kwargs: dict
    outs: tuple[int, ...]  # the tensor outputs' indices, pytree order
    writes: tuple[int, ...] = ()  # tensors written in place
    view: bool = False  # outputs alias the first input (a view)
    source: str = "<unknown>"
    call_stack: tuple[str, ...] = ()
    extra: dict = dataclasses.field(default_factory=dict)

    def pretty(self, meta: list) -> str:
        def show(x):
            if isinstance(x, TRef):
                dt, sh, _ = meta[x.i]
                return f"{str(dt).replace('torch.', '')}{list(sh)}"
            if isinstance(x, (list, tuple)):
                return "[" + ", ".join(show(y) for y in x) + "]"
            return repr(x)

        text = f"{self.target}({', '.join(show(a) for a in self.args)})"
        return text if len(text) <= 160 else text[:157] + "..."


@dataclasses.dataclass
class Graph:
    """A recorded program: its operations, its inputs and outputs."""

    nodes: list[Node]
    inputs: list[int]  # the flattened tensor arguments' indices
    outputs: list  # TRef per tensor output, a Python value otherwise
    meta: list  # (dtype, shape, device type) per tensor index


# host-sync operations the recorder lets the trace pass: a Python scalar
# read (`.item()`) returns this stand-in and data-dependent shapes are empty
_DYNAMIC_SHAPE_OPS = {"nonzero", "masked_select", "unique", "_unique2", "unique_consecutive"}
_TORCH_DIR = os.path.dirname(torch.__file__)
_STDLIB_DIR = os.path.dirname(os.__file__)


def _short_path(fn: str) -> str:
    fn = fn.replace(os.sep, "/")
    for marker in ("/src/", "/tests/"):
        i = fn.rfind(marker)
        if i >= 0:
            return fn[i + (5 if marker == "/src/" else 1):]
    return os.path.basename(fn)


def _leaves(x, out: list) -> list:
    """Tensors and other leaves of an operation's operands, flattened (the
    operands are tensors, scalars and lists of them; faster than pytree)."""
    if isinstance(x, (list, tuple)):
        for y in x:
            _leaves(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _leaves(y, out)
    else:
        out.append(x)
    return out


@dataclasses.dataclass(frozen=True)
class _Schema:
    writes: tuple[int, ...]  # positions of the arguments written in place
    view: bool  # the outputs alias an input without writing it
    scalar_return: Any  # what a data-dependent scalar read stands in with


_SCHEMAS: dict[Any, _Schema] = {}


def _schema_of(func) -> _Schema:
    got = _SCHEMAS.get(func)
    if got is None:
        sch = func._schema
        writes = tuple(k for k, a in enumerate(sch.arguments)
                       if a.alias_info is not None and a.alias_info.is_write)
        view = bool(sch.returns) and not writes and any(
            r.alias_info is not None for r in sch.returns)
        ret = str(sch.returns[0].type).lower() if sch.returns else ""
        got = _Schema(writes, view, {"bool": False, "float": 0.0}.get(ret, 0))
        _SCHEMAS[func] = got
    return got


class _Recorder(TorchDispatchMode):
    def __init__(self, stop_code):
        super().__init__()
        self.stop_code = stop_code
        self.nodes: list[Node] = []
        self.meta: list = []
        self._refs: dict[int, int] = {}
        self._keep: list[torch.Tensor] = []  # keeps ids unique while recording
        self._skip: dict[str, bool] = {}  # file -> not the program's own code

    def ref(self, t: torch.Tensor) -> int:
        i = self._refs.get(id(t))
        if i is None:
            i = len(self._keep)
            self._refs[id(t)] = i
            self._keep.append(t)
            self.meta.append((t.dtype, tuple(t.shape), t.device.type))
        return i

    def _enc(self, x):
        if isinstance(x, torch.Tensor):
            return TRef(self.ref(x))
        if isinstance(x, (list, tuple)):
            return type(x)(self._enc(y) for y in x)
        if isinstance(x, dict):
            return {k: self._enc(v) for k, v in x.items()}
        return x

    def provenance(self) -> tuple[str, tuple[str, ...]]:
        frames = []
        skip = self._skip
        f = sys._getframe(2)
        while f is not None and f.f_code is not self.stop_code:
            fn = f.f_code.co_filename
            s = skip.get(fn)
            if s is None:
                s = skip[fn] = (fn.startswith(_TORCH_DIR) or fn.startswith(_STDLIB_DIR)
                                or fn == __file__)
            if not s:
                frames.append(f)
            f = f.f_back
        if not frames:
            return "<unknown>", ()
        top = frames[0]
        return (f"{_short_path(top.f_code.co_filename)}:{top.f_lineno} "
                f"({top.f_code.co_name})",
                tuple(fr.f_code.co_name for fr in reversed(frames[1:])))

    def add(self, target: str, name: str, args=(), kwargs=None, out=None,
            **fields) -> Node:
        source, stack = self.provenance()
        node = Node(target=target, name=name, args=self._enc(tuple(args)),
                    kwargs=self._enc(dict(kwargs or {})),
                    outs=tuple(self.ref(t) for t in _leaves(out, [])
                               if isinstance(t, torch.Tensor)),
                    source=source, call_stack=stack, **fields)
        self.nodes.append(node)
        return node

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import (
            DataDependentOutputException,
            DynamicOutputShapeException,
        )

        kwargs = kwargs or {}
        if func.namespace == "prim":  # metadata reads (`.device`), not operations
            return func(*args, **kwargs)
        sch = _schema_of(func)
        extra: dict = {}
        try:
            out = func(*args, **kwargs)
        except DataDependentOutputException:
            # a value read back to the host: `.item()`, `.tolist()`, ...
            extra["host_readback"] = True
            out = sch.scalar_return
        except DynamicOutputShapeException:
            name = func.overloadpacket.__name__
            if name not in _DYNAMIC_SHAPE_OPS:
                raise
            extra["dynamic_shape"] = True
            x = args[0]
            out = (torch.empty((0, x.dim()), dtype=torch.long, device=x.device)
                   if name == "nonzero" else x.new_empty((0,)))
        leaves = _leaves(args, [])
        if kwargs:
            _leaves(kwargs, leaves)
        first = next((t for t in leaves if isinstance(t, torch.Tensor)), None)
        if first is not None:
            extra["in_device"] = first.device.type
            if isinstance(out, torch.Tensor):
                extra["out_device"] = out.device.type
        if func.namespace in ("c10d", "_c10d_functional"):
            group = next((a for a in leaves if type(a).__name__ in
                          ("ProcessGroup", "ScriptObject")), None)
            extra["group_size"] = _group_size(group, args)
        self.add(str(func), func.overloadpacket.__name__, args, kwargs, out,
                 writes=tuple(self.ref(args[k]) for k in sch.writes
                              if k < len(args) and isinstance(args[k], torch.Tensor)),
                 view=sch.view, extra=extra)
        return out


def _group_size(group, args) -> int:
    import torch.distributed as dist

    try:
        if group is not None:
            return int(group.size())
        name = next(a for a in args if isinstance(a, str))
        from torch.distributed.distributed_c10d import _resolve_process_group

        return int(_resolve_process_group(name).size())
    except Exception:
        return dist.get_world_size() if dist.is_initialized() else 1


def _recorded_call(fn, args, recorder):
    """The traced program's call: provenance stops at this frame."""
    return fn(*args)


def trace_program(fn: Callable[..., Any], args: Sequence[Any], fake) -> Graph:
    """Run `fn(*args)` on fake tensors (the tensors in `args`, made under
    `fake`, a `FakeTensorMode`) and record every operation it dispatches.

    `torch.cuda.synchronize` calls are recorded as operations and not made.
    """
    rec = _Recorder(_recorded_call.__code__)
    inputs = [rec.ref(t) for t in tree_flatten(tuple(args))[0]
              if isinstance(t, torch.Tensor)]
    real_sync = torch.cuda.synchronize

    def synchronize(device=None):
        rec.add("torch.cuda.synchronize", "cuda_synchronize")

    torch.cuda.synchronize = synchronize
    try:
        with fake, rec:
            out = _recorded_call(fn, tuple(args), rec)
    finally:
        torch.cuda.synchronize = real_sync
    leaves, _ = tree_flatten(out)
    outputs = [TRef(rec.ref(x)) if isinstance(x, torch.Tensor) else x for x in leaves]
    return Graph(rec.nodes, inputs, outputs, rec.meta)


# ---------------------------------------------------------------------------
# Interpretation
# ---------------------------------------------------------------------------


class Rule:
    """Base class for lint rules driven by the interpreter."""

    rule_id = "rule"

    def on_node(self, ctx: "Context", node: Node, ins: list[AbsVal],
                outs: list[AbsVal]) -> None:
        pass

    def on_outputs(self, ctx: "Context", outs: list[AbsVal]) -> None:
        pass


@dataclasses.dataclass
class Context:
    """Mutable interpreter state shared with the rules."""

    entry: str
    rules: list[Rule]
    sanctioned_clips: frozenset[tuple[float, float]] = frozenset()
    findings: list[Finding] = dataclasses.field(default_factory=list)
    # summary facts rules can publish (e.g. proved accumulator bounds)
    facts: dict[str, Any] = dataclasses.field(default_factory=dict)
    graph: Graph | None = None

    def provenance(self, node: Node) -> Provenance:
        return Provenance(primitive=node.target, source=node.source,
                          call_stack=node.call_stack,
                          eqn=node.pretty(self.graph.meta) if self.graph else "")

    def report(self, node: Node, rule: str, kind: str, message: str,
               severity: str = "error") -> None:
        self.findings.append(Finding(rule=rule, kind=kind, entry=self.entry,
                                     message=message, provenance=self.provenance(node),
                                     severity=severity))

    def note_int_bound(self, dtype: Any, lo: float, hi: float) -> None:
        """Publish a proven worst-case interval of an integer dtype."""
        name = str(dtype).replace("torch.", "")
        bounds = self.facts.setdefault("int_bounds", {})
        plo, phi = bounds.get(name, (0.0, 0.0))
        bounds[name] = (min(plo, lo), max(phi, hi))


def _bounded(lo: float, hi: float):
    """A handler for an operation whose output lies in [lo, hi] whatever
    its operands (sin, softmax, ...)."""
    def handler(self, node, args, kwargs):
        return self._arith(node, lo, hi, False, True)
    return handler


# operations whose output is a dtype conversion of one operand: the overload
# name (an in-place variant without its trailing "_") and the operand index
CONVERSIONS = {"_to_copy": 0, "to": 0, "copy": 1, "_copy_from": 0}


class DtypeFlowAnalyzer:
    """Interprets one recorded graph, feeding every operation to the rules."""

    def __init__(self, ctx: Context):
        self.ctx = ctx

    def run(self, graph: Graph, in_absvals: Sequence[AbsVal]) -> list[AbsVal]:
        self.ctx.graph = graph
        self.meta = graph.meta
        self.env: dict[int, AbsVal] = {}
        self.alias: dict[int, int] = {}  # union-find parent
        self.members: dict[int, set[int]] = {}
        for i, a in zip(graph.inputs, in_absvals):
            dt, sh, _ = graph.meta[i]
            self.env[i] = absval_default(dt, sh).with_(
                lo=a.lo, hi=a.hi, integral=a.integral, known=a.known, clip=a.clip)
        for node in graph.nodes:
            args = self._decode(node.args)
            kwargs = self._decode(node.kwargs)
            ins = [x for x in _leaves((args, kwargs), []) if isinstance(x, AbsVal)
                   and not x.weak_type]
            try:
                outs = self.eval_node(node, args, kwargs)
            except Exception:
                outs = None
            if outs is None or len(outs) != len(node.outs):
                outs = self.default_outs(node)
            for rule in self.ctx.rules:
                rule.on_node(self.ctx, node, ins, outs)
            for i, out in zip(node.outs, outs):
                self.env[i] = out
            if node.view and node.outs:
                src = next((a.i for a in _leaves(node.args, []) if isinstance(a, TRef)),
                           None)
                if src is not None:
                    for i in node.outs:
                        self._union(src, i)
            for w in node.writes:
                self._widen_aliases(w)
        outs = []
        for o in graph.outputs:
            outs.append(self.read(o.i) if isinstance(o, TRef) else absval_from_literal(o))
        for rule in self.ctx.rules:
            rule.on_outputs(self.ctx, outs)
        return outs

    # -- environment ------------------------------------------------------

    def read(self, i: int) -> AbsVal:
        got = self.env.get(i)
        if got is None:
            dt, sh, _ = self.meta[i]
            got = absval_default(dt, sh)
        return got

    def _decode(self, tree):
        if isinstance(tree, TRef):
            return self.read(tree.i)
        if isinstance(tree, (list, tuple)):
            return type(tree)(self._decode(x) for x in tree)
        if isinstance(tree, dict):
            return {k: self._decode(v) for k, v in tree.items()}
        return tree

    def _find(self, i: int) -> int:
        while self.alias.get(i, i) != i:
            i = self.alias[i]
        return i

    def _union(self, a: int, b: int) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        self.alias[rb] = ra
        self.members.setdefault(ra, {ra}).update(self.members.pop(rb, {rb}))

    def _widen_aliases(self, w: int) -> None:
        """A write to `w` changes every tensor that shares its storage: each
        member of its alias group takes the hull of its state and `w`'s."""
        new = self.read(w)
        for m in self.members.get(self._find(w), ()):
            if m == w:
                continue
            old = self.read(m)
            self.env[m] = old.with_(lo=min(old.lo, new.lo), hi=max(old.hi, new.hi),
                                    integral=old.integral and new.integral,
                                    known=old.known and new.known, clip=None)

    def default_outs(self, node: Node) -> list[AbsVal]:
        return [absval_default(*self.meta[i][:2]) for i in node.outs]

    def _shaped(self, node: Node, base: AbsVal, i: int = 0, **kw: Any) -> AbsVal:
        dt, sh, _ = self.meta[node.outs[i]]
        out = AbsVal(dt, sh, False, base.lo, base.hi,
                     integral=base.integral or _is_int(dt) or _is_bool(dt),
                     known=base.known, clip=base.clip)
        return out.with_(**kw) if kw else out

    @staticmethod
    def _val(x: Any) -> AbsVal:
        return x if isinstance(x, AbsVal) else absval_from_literal(x)

    # -- dispatch -----------------------------------------------------------

    def eval_node(self, node: Node, args: tuple, kwargs: dict) -> list[AbsVal] | None:
        if node.target.startswith("repro_torch."):
            handler = getattr(self, "_kernel_" + node.name, None)
        else:
            handler = getattr(self, "_op_" + node.name.rstrip("_"), None)
        if handler is None:
            return None
        return handler(node, args, kwargs)

    # -- structural -----------------------------------------------------------

    def _passthrough(self, node, args, kwargs):
        src = next(x for x in _leaves(args, []) if isinstance(x, AbsVal))
        return [self._shaped(node, src, k) for k in range(len(node.outs))]

    _op__unsafe_view = _op_reshape = _op_expand = _op_permute = _passthrough
    _op_transpose = _op_t = _op_squeeze = _op_unsqueeze = _op_select = _passthrough
    _op_slice = _op_narrow = _op_as_strided = _op_alias = _op_detach = _passthrough
    _op_clone = _op_contiguous = _op_flip = _op_roll = _op_repeat = _passthrough
    _op_lift_fresh = _op_lift_fresh_copy = _op_index = _op_gather = _passthrough
    _op_index_select = _op_diagonal = _op_unbind = _op_split = _passthrough
    _op_split_with_sizes = _op_chunk = _op_unfold = _op_amax = _op_amin = _passthrough
    _op_expand_as = _op_view_as = _op_flatten = _op_unflatten = _passthrough
    _op_movedim = _op_wait_tensor = _op_all_gather_into_tensor = _passthrough

    def _op_view(self, node, args, kwargs):
        if node.target.endswith(".dtype"):
            return None  # a bitcast: the default state of the new dtype
        return self._passthrough(node, args, kwargs)

    def _op_mean(self, node, args, kwargs):
        return [self._shaped(node, args[0].with_(integral=False, clip=None))]

    def _with_indices(self, node, args, kwargs, n: int):
        """(values, indices) reductions: the values keep the operand's
        bounds, the indices lie in [0, n - 1]."""
        x = args[0]
        outs = [self._shaped(node, x, 0)]
        for k in range(1, len(node.outs)):
            outs.append(self._shaped(node, AbsVal(torch.int64, lo=0.0,
                                                  hi=float(max(n - 1, 0)),
                                                  integral=True, known=True), k))
        return outs

    def _dim_size(self, x: AbsVal, args, dim_pos: int = 1) -> int:
        dim = args[dim_pos] if len(args) > dim_pos and isinstance(args[dim_pos], int) else None
        if dim is None or not x.shape:
            return int(math.prod(x.shape)) if x.shape else 1
        return int(x.shape[dim])

    def _op_max(self, node, args, kwargs):
        if len(node.outs) == 1 and len(args) == 1:
            return [self._shaped(node, args[0])]
        if len(args) == 2 and isinstance(args[1], AbsVal):  # elementwise max
            return self._op_maximum(node, args, kwargs)
        return self._with_indices(node, args, kwargs, self._dim_size(args[0], args))

    _op_min = _op_max

    def _op_sort(self, node, args, kwargs):
        return self._with_indices(node, args, kwargs, self._dim_size(args[0], args))

    _op_topk = _op_kthvalue = _op_median = _op_sort

    def _op_argmax(self, node, args, kwargs):
        n = self._dim_size(args[0], args)
        return [self._shaped(node, AbsVal(torch.int64, lo=0.0, hi=float(max(n - 1, 0)),
                                          integral=True, known=True))]

    _op_argmin = _op_argmax

    def _op_cat(self, node, args, kwargs):
        dt, sh, _ = self.meta[node.outs[0]]
        return [_hull(list(args[0]), dt, sh)]

    _op_stack = _op_cat

    def _op_where(self, node, args, kwargs):
        if len(args) < 3:
            return None
        dt, sh, _ = self.meta[node.outs[0]]
        x, y = self._val(args[1]), self._val(args[2])
        out = _hull([x, y], dt, sh)
        if x.clip == y.clip:
            out = out.with_(clip=x.clip)
        return [out]

    def _op_constant_pad_nd(self, node, args, kwargs):
        dt, sh, _ = self.meta[node.outs[0]]
        value = args[2] if len(args) > 2 else kwargs.get("value", 0.0)
        return [_hull([args[0], self._val(value)], dt, sh)]

    def _op_masked_fill(self, node, args, kwargs):
        dt, sh, _ = self.meta[node.outs[0]]
        return [_hull([args[0], self._val(args[2])], dt, sh)]

    def _op_scatter(self, node, args, kwargs):
        dt, sh, _ = self.meta[node.outs[0]]
        return [_hull([args[0], self._val(args[3])], dt, sh)]

    def _op_index_put(self, node, args, kwargs):
        accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
        if accumulate:
            return [self._accumulate(node, args[0], self._val(args[2]))]
        dt, sh, _ = self.meta[node.outs[0]]
        return [_hull([args[0], self._val(args[2])], dt, sh)]

    def _accumulate(self, node, tgt: AbsVal, upd: AbsVal) -> AbsVal:
        """A scatter-add of `upd` into `tgt`: at worst every update lands on
        one element."""
        n = math.prod(upd.shape) if upd.shape else 1
        lo = tgt.lo + n * min(0.0, upd.lo) if math.isfinite(upd.lo) else -Inf
        hi = tgt.hi + n * max(0.0, upd.hi) if math.isfinite(upd.hi) else Inf
        return self._shaped(node, AbsVal(tgt.dtype, lo=lo, hi=hi,
                                         integral=tgt.integral and upd.integral,
                                         known=tgt.known and upd.known))

    def _op_index_add(self, node, args, kwargs):
        src = args[3]
        alpha = args[4] if len(args) > 4 else kwargs.get("alpha", 1)
        lo, hi = _mul_bounds(src, self._val(alpha))
        return [self._accumulate(node, args[0], src.with_(lo=lo, hi=hi))]

    def _op_scatter_add(self, node, args, kwargs):
        return [self._accumulate(node, args[0], args[3])]

    # -- constants ------------------------------------------------------------

    def _literal_out(self, node, value: Any) -> list[AbsVal]:
        return [self._shaped(node, absval_from_literal(value).with_(weak_type=False))]

    def _op_full(self, node, args, kwargs):
        return self._literal_out(node, args[1])

    def _op_full_like(self, node, args, kwargs):
        return self._literal_out(node, args[1])

    def _op_new_full(self, node, args, kwargs):
        return self._literal_out(node, args[2])

    def _op_fill(self, node, args, kwargs):
        if isinstance(args[1], AbsVal):
            return [self._shaped(node, args[1])]
        return self._literal_out(node, args[1])

    def _op_zeros(self, node, args, kwargs):
        return self._literal_out(node, 0)

    _op_zeros_like = _op_new_zeros = _op_zero = _op_zeros

    def _op_ones(self, node, args, kwargs):
        return self._literal_out(node, 1)

    _op_ones_like = _op_new_ones = _op_ones

    def _op_scalar_tensor(self, node, args, kwargs):
        return self._literal_out(node, args[0])

    def _op_arange(self, node, args, kwargs):
        nums = [a for a in args if isinstance(a, (int, float))]
        if len(nums) == 1:
            lo, hi = 0.0, float(nums[0]) - 1
        else:
            lo, hi = float(nums[0]), float(nums[1]) - 1
        hi = max(lo, hi)
        return [self._shaped(node, AbsVal(torch.int64, lo=lo, hi=hi,
                                          integral=all(float(n).is_integer() for n in nums),
                                          known=True))]

    def _op_eye(self, node, args, kwargs):
        return [self._shaped(node, AbsVal(torch.float32, lo=0.0, hi=1.0, integral=True,
                                          known=True))]

    def _op_linspace(self, node, args, kwargs):
        a, b = float(args[0]), float(args[1])
        return [self._shaped(node, AbsVal(torch.float32, lo=min(a, b), hi=max(a, b),
                                          known=True))]

    # -- comparisons / logic ----------------------------------------------------

    def _bool_out(self, node, args, kwargs):
        return [self._shaped(node, AbsVal(torch.bool, lo=0.0, hi=1.0, integral=True,
                                          known=True), k) for k in range(len(node.outs))]

    _op_eq = _op_ne = _op_lt = _op_le = _op_gt = _op_ge = _bool_out
    _op_logical_and = _op_logical_or = _op_logical_not = _op_logical_xor = _bool_out
    _op_isnan = _op_isfinite = _op_isinf = _op_any = _op_all = _bool_out

    def _op_bitwise_and(self, node, args, kwargs):
        if _is_bool(self.meta[node.outs[0]][0]):
            return self._bool_out(node, args, kwargs)
        return None

    _op_bitwise_or = _op_bitwise_xor = _op_bitwise_not = _op_bitwise_and

    # -- arithmetic ---------------------------------------------------------------

    def _arith(self, node, lo, hi, integral, known) -> list[AbsVal]:
        dt = self.meta[node.outs[0]][0]
        return [self._shaped(node, AbsVal(dt, lo=lo, hi=hi, integral=integral,
                                          known=known), clip=None)]

    def _op_add(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        alpha = self._val(kwargs.get("alpha", args[2] if len(args) > 2 else 1))
        blo, bhi = _mul_bounds(b, alpha)
        return self._arith(node, a.lo + blo, a.hi + bhi, a.integral and b.integral
                           and alpha.integral, a.known and b.known)

    def _op_sub(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        alpha = self._val(kwargs.get("alpha", args[2] if len(args) > 2 else 1))
        blo, bhi = _mul_bounds(b, alpha)
        return self._arith(node, a.lo - bhi, a.hi - blo, a.integral and b.integral
                           and alpha.integral, a.known and b.known)

    def _op_rsub(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        return self._op_sub(node, (b, a) + tuple(args[2:]), kwargs)

    def _op_mul(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        lo, hi = _mul_bounds(a, b)
        return self._arith(node, lo, hi, a.integral and b.integral, a.known and b.known)

    def _op_addcmul(self, node, args, kwargs):
        s, t1, t2 = args[0], self._val(args[1]), self._val(args[2])
        v = self._val(kwargs.get("value", args[3] if len(args) > 3 else 1))
        plo, phi = _mul_bounds(t1, t2)
        lo, hi = _mul_bounds(AbsVal(t1.dtype, lo=plo, hi=phi), v)
        return self._arith(node, s.lo + lo, s.hi + hi,
                           s.integral and t1.integral and t2.integral and v.integral,
                           s.known and t1.known and t2.known)

    def _op_div(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        mode = kwargs.get("rounding_mode", args[2] if len(args) > 2 else None)
        if b.lo > 0 or b.hi < 0:
            cands = [a.lo / b.lo, a.lo / b.hi, a.hi / b.lo, a.hi / b.hi]
            cands = [0.0 if math.isnan(c) else c for c in cands]
            lo, hi = min(cands), max(cands)
        else:
            lo, hi = -Inf, Inf
        integral = mode in ("floor", "trunc")
        if integral:
            lo = math.floor(lo) if math.isfinite(lo) else lo
            hi = math.ceil(hi) if math.isfinite(hi) else hi
        dt = self.meta[node.outs[0]][0]
        return self._arith(node, lo, hi, integral or _is_int(dt), a.known and b.known)

    def _op_reciprocal(self, node, args, kwargs):
        return self._op_div(node, (1.0, args[0]), {})

    def _op_remainder(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        mag = max(abs(b.lo), abs(b.hi))
        if not math.isfinite(mag):
            return None
        return self._arith(node, -mag, mag, a.integral and b.integral, a.known and b.known)

    _op_fmod = _op_remainder

    def _op_neg(self, node, args, kwargs):
        a = args[0]
        return [self._shaped(node, a.with_(lo=-a.hi, hi=-a.lo, clip=None))]

    def _op_abs(self, node, args, kwargs):
        a = args[0]
        lo = 0.0 if a.lo <= 0.0 <= a.hi else min(abs(a.lo), abs(a.hi))
        return [self._shaped(node, a.with_(lo=lo, hi=max(abs(a.lo), abs(a.hi)), clip=None))]

    def _op_sign(self, node, args, kwargs):
        return self._arith(node, -1.0, 1.0, True, True)

    def _rounded(self, node, args, lo_fn, hi_fn):
        a = args[0]
        lo = lo_fn(a.lo) if math.isfinite(a.lo) else a.lo
        hi = hi_fn(a.hi) if math.isfinite(a.hi) else a.hi
        return [self._shaped(node, a.with_(lo=lo, hi=hi, integral=True, clip=None))]

    def _op_floor(self, node, args, kwargs):
        return self._rounded(node, args, math.floor, math.floor)

    def _op_ceil(self, node, args, kwargs):
        return self._rounded(node, args, math.ceil, math.ceil)

    def _op_round(self, node, args, kwargs):
        return self._rounded(node, args, math.floor, math.ceil)

    def _op_trunc(self, node, args, kwargs):
        return self._rounded(node, args, math.floor, math.ceil)

    def _op_exp(self, node, args, kwargs):
        a = args[0]
        return self._arith(node, math.exp(a.lo) if a.lo < 700 else Inf,
                           math.exp(a.hi) if a.hi < 700 else Inf, False, a.known)

    def _op_sqrt(self, node, args, kwargs):
        a = args[0]
        hi = math.sqrt(a.hi) if math.isfinite(a.hi) and a.hi > 0 else (
            0.0 if a.hi <= 0 else Inf)
        return self._arith(node, math.sqrt(a.lo) if a.lo > 0 else 0.0, hi, False, a.known)

    def _op_linalg_vector_norm(self, node, args, kwargs):
        a = args[0]
        n = math.prod(a.shape) if a.shape else 1
        mag = max(abs(a.lo), abs(a.hi))
        return self._arith(node, 0.0, math.sqrt(n) * mag if math.isfinite(mag) else Inf,
                           False, a.known)

    _op_sin = _op_cos = _op_tanh = _bounded(-1.0, 1.0)
    _op_sigmoid = _op_softmax = _op__softmax = _bounded(0.0, 1.0)
    _op_acos = _op_arccos = _bounded(0.0, math.pi)
    _op_atan2 = _bounded(-math.pi, math.pi)

    def _op_pow(self, node, args, kwargs):
        a, y = args[0], args[1]
        if not isinstance(y, int) or y < 0 or not (math.isfinite(a.lo) and math.isfinite(a.hi)):
            return None
        cands = [a.lo ** y, a.hi ** y]
        lo, hi = min(cands), max(cands)
        if y % 2 == 0 and a.lo <= 0.0 <= a.hi:
            lo = 0.0
        return self._arith(node, lo, hi, a.integral, a.known)

    def _op_nan_to_num(self, node, args, kwargs):
        a = args[0]
        nan = kwargs.get("nan", args[1] if len(args) > 1 else 0.0)
        nan = 0.0 if nan is None else float(nan)
        dt = self.meta[node.outs[0]][0]
        big = torch.finfo(dt).max if _is_float(dt) else Inf
        lo = max(a.lo, -big) if math.isfinite(big) else a.lo
        hi = min(a.hi, big) if math.isfinite(big) else a.hi
        return [self._shaped(node, a.with_(lo=min(lo, nan), hi=max(hi, nan),
                                           integral=a.integral and nan.is_integer()))]

    # -- min/max and clamp provenance ------------------------------------------

    @staticmethod
    def _literal_bound(v: Any) -> float | None:
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
        if isinstance(v, AbsVal) and v.known and v.lo == v.hi and math.isfinite(v.lo):
            return v.lo
        return None

    def _op_clamp(self, node, args, kwargs):
        x = args[0]
        lo_v = args[1] if len(args) > 1 else kwargs.get("min")
        hi_v = args[2] if len(args) > 2 else kwargs.get("max")
        lo_lit, hi_lit = self._literal_bound(lo_v), self._literal_bound(hi_v)
        lo, hi = x.lo, x.hi
        integral, known = x.integral, x.known
        for v, is_lo in ((lo_v, True), (hi_v, False)):
            if v is None:
                continue
            v = self._val(v)
            integral = integral and v.integral
            if is_lo:
                lo, hi = max(lo, v.lo), max(hi, v.lo)
            else:
                lo, hi = min(lo, v.hi), min(hi, v.hi)
        known = known or (lo_lit is not None and hi_lit is not None)
        if lo_lit is not None and hi_lit is not None:
            clip = (lo_lit, hi_lit)
        elif lo_lit is not None:
            clip = (lo_lit, x.clip[1] if x.clip else Inf)
        elif hi_lit is not None:
            clip = (x.clip[0] if x.clip else -Inf, hi_lit)
        else:
            clip = None
        return [self._shaped(node, x.with_(lo=lo, hi=hi, integral=integral, known=known,
                                           clip=clip))]

    def _op_clamp_min(self, node, args, kwargs):
        return self._op_clamp(node, (args[0], args[1], None), {})

    def _op_clamp_max(self, node, args, kwargs):
        return self._op_clamp(node, (args[0], None, args[1]), {})

    def _op_maximum(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        lit = self._literal_bound(b) if not a.weak_type else self._literal_bound(a)
        x = a if lit is not None and not a.weak_type else b
        clip = (lit, x.clip[1] if x.clip else Inf) if lit is not None else None
        return [self._shaped(node, AbsVal(a.dtype, lo=max(a.lo, b.lo), hi=max(a.hi, b.hi),
                                          integral=a.integral and b.integral,
                                          known=a.known and b.known), clip=clip)]

    def _op_minimum(self, node, args, kwargs):
        a, b = self._val(args[0]), self._val(args[1])
        lit = self._literal_bound(b) if not a.weak_type else self._literal_bound(a)
        x = a if lit is not None and not a.weak_type else b
        clip = (x.clip[0] if x.clip else -Inf, lit) if lit is not None else None
        return [self._shaped(node, AbsVal(a.dtype, lo=min(a.lo, b.lo), hi=min(a.hi, b.hi),
                                          integral=a.integral and b.integral,
                                          known=a.known and b.known), clip=clip)]

    # -- conversions --------------------------------------------------------------

    def _convert(self, node, a: AbsVal) -> list[AbsVal]:
        dt, sh, _ = self.meta[node.outs[0]]
        if _is_bool(dt):
            out = AbsVal(dt, sh, lo=0.0, hi=1.0, integral=True, known=True)
        elif _is_int(dt):
            rlo, rhi = int_range(dt)
            lo = math.floor(a.lo) if math.isfinite(a.lo) else a.lo
            hi = math.ceil(a.hi) if math.isfinite(a.hi) else a.hi
            if lo < rlo or hi > rhi:
                lo, hi = rlo, rhi  # a wrap is possible: the stored range
            out = AbsVal(dt, sh, lo=lo, hi=hi, integral=True, known=a.known, clip=a.clip)
        else:
            out = AbsVal(dt, sh, lo=a.lo, hi=a.hi, integral=a.integral, known=a.known,
                         clip=a.clip)
        return [out]

    def _op__to_copy(self, node, args, kwargs):
        return self._convert(node, args[0])

    _op_to = _op__copy_from = _op__to_copy

    def _op_copy(self, node, args, kwargs):
        return self._convert(node, self._val(args[1]))

    # -- contractions / reductions ------------------------------------------------

    def _dot(self, node, a: AbsVal, b: AbsVal, k: int) -> list[AbsVal]:
        plo, phi = _mul_bounds(a, b)
        lo, hi = _scale(k, plo, phi)
        return self._arith(node, lo, hi, a.integral and b.integral, a.known and b.known)

    def _op_mm(self, node, args, kwargs):
        return self._dot(node, args[0], args[1], args[0].shape[-1])

    _op_bmm = _op_matmul = _op_mm

    def _op_addmm(self, node, args, kwargs):
        out = self._dot(node, args[1], args[2], args[1].shape[-1])[0]
        s = args[0]
        return [out.with_(lo=out.lo + s.lo, hi=out.hi + s.hi, known=out.known and s.known,
                          integral=out.integral and s.integral)]

    def _op_sum(self, node, args, kwargs):
        a = args[0]
        dims = args[1] if len(args) > 1 and isinstance(args[1], (list, tuple)) else None
        if dims is None:
            k = math.prod(a.shape) if a.shape else 1
        else:
            k = math.prod(a.shape[d] for d in dims) if a.shape else 1
        lo, hi = _scale(k, a.lo, a.hi)
        return self._arith(node, lo, hi, a.integral, a.known)

    def _op_cumsum(self, node, args, kwargs):
        a = args[0]
        n = a.shape[args[1]] if a.shape else 1
        lo, hi = _scale(n, a.lo, a.hi)
        return self._arith(node, min(a.lo, lo), max(a.hi, hi), a.integral, a.known)

    # -- collectives ----------------------------------------------------------------

    def _op_all_reduce(self, node, args, kwargs):
        n = node.extra.get("group_size", 1)
        a = next(x for x in _leaves(args, []) if isinstance(x, AbsVal))
        lo, hi = _scale(n, a.lo, a.hi)
        return [self._shaped(node, a.with_(lo=lo, hi=hi, clip=None), k)
                for k in range(len(node.outs))]

    _op_allreduce = _op_all_reduce

    def _op__allgather_base(self, node, args, kwargs):
        # writes its first operand with the gathered second
        src = args[1]
        return [self._shaped(node, src.with_(clip=None), k) for k in range(len(node.outs))]

    # -- the hand-written kernels -----------------------------------------------------

    def _kernel_backproject_vote(self, node, args, kwargs):
        """B1: an int32 shared accumulator per voxel, every valid event of
        every frame into one voxel at worst (nearest votes weigh 1, a
        bilinear vote at most 1 in total), then the int16 saturating store
        when quantized, else float32."""
        x0, valid, phi = args[0], args[2], args[3]
        s, c, e = x0.shape
        hi_votes = float(c * e) * max(valid.hi, 0.0)
        bilinear, quantized = args[8], args[9]
        if not bilinear:
            self.ctx.note_int_bound(torch.int32, 0.0, hi_votes)
            if hi_votes > int_range(torch.int32)[1]:
                self.ctx.report(node, "dtype-flow", "int-overflow",
                                f"B1's int32 vote accumulator can wrap: {hi_votes:.0f} "
                                "votes per voxel at worst")
        dt, sh, _ = self.meta[node.outs[0]]
        if quantized:
            lo16, hi16 = int_range(torch.int16)
            return [AbsVal(dt, sh, lo=0.0, hi=min(hi_votes, hi16), integral=True,
                           known=True, clip=(lo16, hi16))]
        return [AbsVal(dt, sh, lo=0.0, hi=hi_votes, integral=not bilinear, known=True)]

    def _kernel_depth_argmax(self, node, args, kwargs):
        """B2: the depth-axis maximum of the stored DSI and its refined
        plane index, within half a plane of an integer index."""
        dsi = args[0]
        nz = dsi.shape[1]
        conf = self._shaped(node, dsi.with_(clip=None), 0)
        zf = self._shaped(node, AbsVal(torch.float32, lo=-0.5, hi=nz - 0.5, known=True), 1)
        return [conf.with_(integral=dsi.integral), zf.with_(integral=False)]

    def _kernel_flash_attention(self, node, args, kwargs):
        """B3: each output is a convex combination of rows of v."""
        v = args[2]
        return [self._shaped(node, v.with_(clip=None))]


def analyze_program(
    fn: Callable[..., Any],
    args: Sequence[Any],
    contracts: Sequence[AbsVal] | None,
    *,
    entry: str,
    rules: list[Rule],
    fake,
    sanctioned_clips: frozenset[tuple[float, float]] = frozenset(),
) -> Context:
    """Trace `fn(*args)` on the fake tensors in `args` (made under `fake`)
    and run the rules over the recorded graph.

    `contracts` — one AbsVal per flattened tensor argument (see
    `contract`), or None for the dtype defaults. Returns the populated
    `Context`.
    """
    graph = trace_program(fn, args, fake)
    if contracts is None:
        in_absvals = [absval_default(*graph.meta[i][:2]) for i in graph.inputs]
    else:
        if len(contracts) != len(graph.inputs):
            raise ValueError(f"{entry}: {len(contracts)} contracts for "
                             f"{len(graph.inputs)} inputs")
        in_absvals = list(contracts)
    ctx = Context(entry=entry, rules=rules, sanctioned_clips=sanctioned_clips)
    DtypeFlowAnalyzer(ctx).run(graph, in_absvals)
    return ctx
