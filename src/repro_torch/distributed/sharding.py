"""Sharding rules: logical roles -> partition specs -> DTensor placements.

Counterpart of `repro.distributed.sharding`. One rule table maps parameter
*roles* (inferred from tree paths) to mesh axes, with divisibility guards,
so a mesh change (16x16 single-pod vs 2x16x16 multi-pod) or an arch change
is config-only. JAX's GSPMD becomes DTensor: a spec here is a `P`, one
entry per tensor dim (None, an axis name, or a tuple of names), and
`to_placements` turns it into the `Shard`/`Replicate` placements of a
`DeviceMesh`.

Axes (launch/mesh.py): `pod` cross-pod data parallel, `data` in-pod data
parallel + FSDP, `model` tensor/expert parallel.

The reference's rules read stacked leaves: each pattern position's layers
stacked on a leading (n_superblocks,) axis, experts (n_sb, E, D, F) with
dim 1 over `model`. The port keeps one dict per layer. So every block
spec is computed on the stacked shape ((n_sb,) + the layer's shape, path
`blocks/<pattern position>/...`) and its leading entry dropped: FSDP's
size test (`_add_fsdp`'s `min_size`) then answers as the reference's does
(a (36, 4096) norm stack is sharded there; a lone (4096,) would not be).

Where the rule plus `_add_fsdp` shard the super-block dim itself (e.g.
mamba2-2.7b's (64, 4, 5120) `conv_x_w` on the production meshes, FSDP on:
`P('data', None, 'model')`), a per-layer leaf cannot hold the reference's
bytes. On such a mesh the port holds that leaf stacked, as the reference
does: the mesh layout. `stacked_paths(cfg, mesh, plan)` names those leaves
per pattern position (a pure function of the arch, the mesh's axes and the
plan); `to_mesh_layout` moves them out of the per-layer dicts into
`tree["stacks"][position]`, one (n_sb, ...) tensor each, placed by the
reference's spec unchanged; a layer reads its row (`models/model.py`).
Where no leaf is named (no mesh, FSDP off, or no rule takes the dim) the
tree stays one dict per layer. `param_specs` gives the specs of the mesh
layout, and `distribute` moves a per-layer tree into the layout of the
specs it is given, so any tree shaped like the parameters (AdamW's m and
v, checkpoints) follows.

The spec functions read only `mesh.mesh_dim_names` and `mesh.shape`, so
any object with those two attributes stands in for a mesh there (the
tests use one at the production shapes); `to_placements` and what places
tensors need a `DeviceMesh`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import ArchConfig

Tensor = torch.Tensor


class P(tuple):
    """A partition spec: one entry per tensor dim, from the first; missing
    trailing entries are None (replicated). A tuple of one axis name is
    that name, as in JAX's `PartitionSpec`."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """Which mesh axes play which role for one run."""

    batch_axes: tuple[str, ...]  # e.g. ("pod", "data") — batch dim sharding
    model_axis: str | None  # tensor/expert parallel axis
    fsdp_axes: tuple[str, ...] = ("data",)  # param-shard axes (within pod)
    fsdp: bool = True  # shard params/opt-state over fsdp_axes

    @staticmethod
    def for_mesh(mesh, fsdp: bool = True) -> "ShardingPlan":
        names = tuple(mesh.mesh_dim_names)
        model = "model" if "model" in names else None
        batch = tuple(n for n in names if n in ("pod", "data"))
        return ShardingPlan(batch_axes=batch, model_axis=model,
                            fsdp_axes=("data",) if "data" in names else (),
                            fsdp=fsdp)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axis_size(mesh, name: str | None) -> int:
    return axis_sizes(mesh).get(name, 1) if name is not None else 1


# ---------------------------------------------------------------------------
# Parameter sharding
# ---------------------------------------------------------------------------


def _param_rule(path: str, shape: tuple[int, ...], cfg: ArchConfig,
                mesh, plan: ShardingPlan) -> P:
    """Logical TP/EP spec for one (stacked) parameter leaf (no FSDP yet)."""
    tp = _axis_size(mesh, plan.model_axis)
    m = plan.model_axis
    none = P()

    def last_dim_over_model(div: int) -> P:
        if tp > 1 and div % tp == 0:
            return P(*([None] * (len(shape) - 1) + [m]))
        return none

    def dim_over_model(axis: int, div: int) -> P:
        if tp > 1 and div % tp == 0:
            spec: list = [None] * len(shape)
            spec[axis] = m
            return P(*spec)
        return none

    in_blocks = path.startswith("blocks/")

    # --- embeddings / head ---
    if path.endswith("embed/table") or path == "lm_head":
        return dim_over_model(0, shape[0])  # vocab

    if not in_blocks:
        return none  # final_norm etc.

    # --- attention ---
    if "/attn/" in path:
        hq, hkv = cfg.n_heads_eff, cfg.n_kv_heads_eff
        if path.endswith(("wq/w", "wq/b")):
            return last_dim_over_model(hq) if hq % max(tp, 1) == 0 else none
        if path.endswith(("wk/w", "wk/b", "wv/w", "wv/b")):
            return last_dim_over_model(hkv) if hkv % max(tp, 1) == 0 else none
        if path.endswith("wo/w"):
            return dim_over_model(1, hq) if hq % max(tp, 1) == 0 else none
        return none  # qk-norm scales, wo bias

    # --- MoE ---
    if "/moe/" in path:
        if "/experts/" in path:
            return dim_over_model(1, shape[1])  # (n_sb, E, ..): EP over experts
        if "/shared/" in path:
            if path.endswith(("w_gate", "w_up")):
                return last_dim_over_model(shape[-1])
            if path.endswith("w_down"):
                return dim_over_model(1, shape[1])
        return none  # router

    # --- dense MLP ---
    if "/dense/" in path or "/ffn/" in path:
        if path.endswith(("w_gate", "w_up", "b_up")):
            return last_dim_over_model(shape[-1])
        if path.endswith("w_down"):
            return dim_over_model(1, shape[1])
        return none  # b_down (output-dim bias stays replicated)

    # --- Mamba-2 (head-aligned streams shard; B/C replicate) ---
    if "/mamba/" in path:
        nh = cfg.ssm.num_heads(cfg.d_model) if cfg.ssm else 0
        head_ok = tp > 1 and nh % tp == 0
        if not head_ok:
            return none
        if path.endswith(("w_z/w", "w_x/w", "w_dt/w")):
            return P(*([None] * (len(shape) - 1) + [m]))
        if path.endswith(("conv_x_w", "conv_x_b", "norm")):
            return P(*([None] * (len(shape) - 1) + [m]))
        if path.endswith(("A_log", "dt_bias", "D")):
            return P(None, m)  # (n_sb, nh)
        if path.endswith("out_proj/w"):
            return P(None, m, None)
        return none  # w_B, w_C, conv_B*, conv_C*, biases

    return none


def _add_fsdp(spec: P, shape: tuple[int, ...], mesh, plan: ShardingPlan,
              min_size: int = 2 ** 16) -> P:
    """Shard the largest unsharded dim over the fsdp axes (if divisible)."""
    if not plan.fsdp or not plan.fsdp_axes:
        return spec
    if math.prod(shape) < min_size:
        return spec  # tiny leaves stay replicated
    fs = math.prod(_axis_size(mesh, a) for a in plan.fsdp_axes)
    if fs <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # candidate dims: unsharded, divisible; prefer the largest
    cands = [i for i in range(len(shape))
             if entries[i] is None and shape[i] % fs == 0]
    if not cands:
        return spec
    best = max(cands, key=lambda i: shape[i])
    entries[best] = plan.fsdp_axes if len(plan.fsdp_axes) > 1 else plan.fsdp_axes[0]
    return P(*entries)


def fsdp_dim(shape: tuple[int, ...], fs: int, taken: tuple[int, ...] = ()
             ) -> int | None:
    """Which dim _add_fsdp would shard: the largest free, divisible one."""
    cands = [i for i in range(len(shape))
             if i not in taken and shape[i] % fs == 0]
    return max(cands, key=lambda i: shape[i]) if cands else None


def map_with_path(tree: Any, fn, path: tuple = ()):
    """`tree` (dicts, lists, tuples, NamedTuples) with each leaf replaced
    by fn(path, leaf), path the keys and indices down to it; None kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_with_path(getattr(tree, f), fn, path + (f,))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(v, fn, path + (i,)) for i, v in enumerate(tree))
    return None if tree is None else fn(path, tree)


# ---------------------------------------------------------------------------
# The mesh layout: leaves held stacked over super-blocks
# ---------------------------------------------------------------------------

STACKS = "stacks"  # the mesh layout's key of the stacked leaves


def _leaf_paths(tree, path: tuple = ()):
    """(path, leaf) of each leaf of nested dicts, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_paths(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def _nest(items) -> dict:
    """Nested dicts from (path, value) pairs."""
    out: dict = {}
    for path, v in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def _without(tree: dict, paths) -> dict:
    """A copy of nested dicts without the leaves at `paths`."""
    out = {}
    for k, v in tree.items():
        inner = [p[1:] for p in paths if p[0] == k]
        if not inner:
            out[k] = v
        elif not (len(inner) == 1 and inner[0] == ()):
            out[k] = _without(v, inner)
    return out


def _stacked_spec(pos: int, sub: tuple, stacked: tuple[int, ...], cfg: ArchConfig, mesh,
                  plan: ShardingPlan) -> P:
    """The reference's spec of the stacked leaf `blocks/<pos>/<sub>`."""
    where = "/".join(str(p) for p in ("blocks", pos) + tuple(sub))
    return _add_fsdp(_param_rule(where, stacked, cfg, mesh, plan), stacked, mesh, plan)


def stacked_paths(cfg: ArchConfig, mesh, plan: ShardingPlan) -> tuple[tuple[tuple, ...], ...]:
    """Per pattern position, the paths within a layer's dict (e.g.
    ("mamba", "conv_x_w")) of the leaves the port holds stacked on `mesh`:
    those whose reference spec shards the super-block dim. Every entry is
    empty where no rule takes that dim."""
    from repro_torch.models.model import layer_shapes

    n_sb = cfg.n_superblocks()
    return tuple(
        tuple(sub for sub, x in _leaf_paths(layer)
              if (_stacked_spec(pos, sub, (n_sb,) + tuple(x.shape), cfg, mesh, plan)
                  + (None,))[0] is not None)
        for pos, layer in enumerate(layer_shapes(cfg)))


def layout_of(tree) -> tuple[tuple[tuple, ...], ...] | None:
    """The stacked paths of a tree in the mesh layout (read from its
    `stacks`), or None for a tree of one dict per layer."""
    if not isinstance(tree, dict) or STACKS not in tree:
        return None
    return tuple(tuple(p for p, _ in _leaf_paths(s)) for s in tree[STACKS])


def to_mesh_layout(tree: dict, paths, stack=torch.stack) -> dict:
    """`tree` (the parameters, or any tree shaped like them, one dict per
    layer) with the leaves `paths` names (`stacked_paths`) taken out of
    every layer's dict and stacked over super-blocks by `stack` (a list of
    leaves, super-block order, -> one leaf), under `tree["stacks"]`, one
    dict per pattern position. A tree already in a mesh layout, or `paths`
    naming nothing, comes back as it is."""
    if STACKS in tree or not any(paths):
        return tree
    blocks, n = tree["blocks"], len(paths)
    stacks = [_nest((sub, stack([_get(blocks[sb + pos], sub)
                                 for sb in range(0, len(blocks), n)])) for sub in subs)
              for pos, subs in enumerate(paths)]
    out = {k: [_without(layer, paths[i % n]) for i, layer in enumerate(blocks)]
           if k == "blocks" else v for k, v in tree.items()}
    out[STACKS] = stacks
    return out


def layer_rows(stacks: list, n_sb: int) -> list[dict]:
    """Every layer's rows of `stacks` (the mesh layout's stacked leaves,
    one dict per pattern position), in layer order: each stack split into
    its super-blocks' rows by one `unbind` (its gradient stacks them
    back)."""
    rows = [[(sub, t.unbind(0)) for sub, t in _leaf_paths(s)] for s in stacks]
    return [_nest((sub, r[sb]) for sub, r in rows[pos])
            for sb in range(n_sb) for pos in range(len(stacks))]


def with_rows(layer: dict, rows: dict) -> dict:
    """A layer's dict with its stacked leaves' rows put back."""
    if not rows:
        return layer
    out = dict(layer)
    for k, v in rows.items():
        out[k] = with_rows(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


def _stack_shapes(leaves) -> Tensor:
    """The stack of `leaves` as a meta tensor: its shape only."""
    return torch.empty((len(leaves),) + tuple(leaves[0].shape), device="meta")


def _per_layer(stacked: P, ndim: int, what: str) -> P:
    """A stacked leaf's spec without its leading super-block entry."""
    entries = list(stacked) + [None] * (ndim + 1 - len(stacked))
    if entries[0] is not None:
        raise ValueError(f"{what}: the reference's spec shards the super-block dim over "
                         f"{entries[0]!r}; on this mesh the leaf is held stacked "
                         "(`stacked_paths`, `to_mesh_layout`)")
    return P(*entries[1:])


def param_spec(path: tuple, shape: tuple[int, ...], cfg: ArchConfig, mesh,
               plan: ShardingPlan) -> P:
    """The spec of one leaf of the port's parameter tree, at `path` (keys
    and list indices, e.g. ("blocks", 3, "attn", "wq", "w")): the
    reference's spec of the stacked leaf (`blocks/<pattern position>/...`,
    shape (n_sb,) + shape) without its super-block entry; for a stacked
    leaf of the mesh layout (("stacks", <pattern position>, ...), its
    whole stacked shape), the reference's spec unchanged."""
    shape = tuple(shape)
    if path[0] == STACKS:
        return _stacked_spec(path[1], path[2:], shape, cfg, mesh, plan)
    if path[0] == "blocks":
        pos = path[1] % len(cfg.pattern())
        spec = _stacked_spec(pos, path[2:], (cfg.n_superblocks(),) + shape, cfg, mesh, plan)
        return _per_layer(spec, len(shape), "parameter " + "/".join(
            str(p) for p in ("blocks", pos) + path[2:]))
    where = "/".join(str(p) for p in path)
    return _add_fsdp(_param_rule(where, shape, cfg, mesh, plan), shape, mesh, plan)


def param_specs(cfg: ArchConfig, params: Any, mesh, plan: ShardingPlan) -> Any:
    """A `P` per leaf of the port's parameter tree in its layout on `mesh`
    (tensors or anything with a `.shape`): `param_spec` of each leaf of the
    mesh layout, the per-layer tree moved into it first (shapes only) where
    `stacked_paths` names a leaf."""
    tree = to_mesh_layout(params, stacked_paths(cfg, mesh, plan), stack=_stack_shapes)
    return map_with_path(tree, lambda path, x: param_spec(path, tuple(x.shape), cfg, mesh, plan))


# ---------------------------------------------------------------------------
# Batch / activation / decode-state sharding
# ---------------------------------------------------------------------------


def batch_spec(shape: tuple[int, ...], mesh, plan: ShardingPlan) -> P:
    """Shard dim 0 (global batch) over the batch axes, if divisible."""
    bs = math.prod(_axis_size(mesh, a) for a in plan.batch_axes)
    if shape and bs > 1 and shape[0] % bs == 0:
        return P(plan.batch_axes, *([None] * (len(shape) - 1)))
    return P(*([None] * len(shape)))


def decode_state_specs(cfg: ArchConfig, state: Any, mesh, plan: ShardingPlan) -> Any:
    """Decode-state sharding, a `P` per field of the port's per-layer state
    (a `KVCache` or an `SSMState` per layer), as the reference's rule gives
    for its stacked state, the super-block entry dropped.

    KV caches: batch over the batch axes and sequence over `model`; at
    batch 1 (long context) the sequence takes every batch axis and
    `model`. SSD states shard heads over `model`."""
    tp = _axis_size(mesh, plan.model_axis)
    m = plan.model_axis
    n_pat = len(cfg.pattern())
    n_sb = cfg.n_superblocks()
    bs = math.prod(_axis_size(mesh, a) for a in plan.batch_axes)

    def rule(p: str, shape: tuple[int, ...]) -> P:
        batch = shape[1] if len(shape) > 1 else 1
        batch_ok = bs > 1 and batch % bs == 0
        is_kv = ("/k" in p or "/v" in p) and len(shape) == 5
        if is_kv:
            seq = shape[2]
            if batch_ok:  # batch over (pod, data); sequence over model
                if tp > 1 and seq % tp == 0:
                    return P(None, plan.batch_axes, m, None, None)
                return P(None, plan.batch_axes, None, None, None)
            # batch=1: sequence over every batch axis + model
            seq_axes = tuple(a for a in (plan.batch_axes + ((m,) if m else ()))
                             if _axis_size(mesh, a) > 1)
            total = math.prod(_axis_size(mesh, a) for a in seq_axes)
            if seq_axes and seq % total == 0:
                return P(None, None, seq_axes, None, None)
            return P(*([None] * len(shape)))
        if batch_ok and len(shape) > 1:
            return P(None, plan.batch_axes, *([None] * (len(shape) - 2)))
        # SSD state (n_sb, B, H, N, P): heads over model
        if p.endswith("ssd") and len(shape) == 5 and tp > 1 and shape[2] % tp == 0:
            return P(None, None, m, None, None)
        return P(*([None] * len(shape)))

    def leaf(path, x):
        shape = tuple(x.shape)
        where = "/".join(str(p) for p in (path[0] % n_pat,) + path[1:])
        return _per_layer(rule(where, (n_sb,) + shape), len(shape), f"state {where}")

    return map_with_path(list(state), leaf)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements
# ---------------------------------------------------------------------------


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`: `Shard(d)` on each mesh dim
    named by entry d (a tuple entry names several, which must follow the
    mesh's own order, so the dim splits major-to-minor as JAX splits it),
    `Replicate()` on the others and on every mesh dim of size 1 (the same
    layout, without DTensor's refusals to reshape a dim sharded there)."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    placements: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for i in idx:
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} used twice")
            if sizes[i] > 1:
                placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (the reference's `NamedSharding`)."""

    mesh: Any
    spec: P

    @property
    def placements(self) -> tuple:
        return to_placements(self.spec, self.mesh)

    def place(self, t: Tensor) -> DTensor:
        """`t`, the same full tensor on every rank, as a DTensor on the
        mesh: each rank keeps its own shard (no communication)."""
        if t.device.type != self.mesh.device_type:
            t = t.to(self.mesh.device_type)
        return distribute_tensor(t, self.mesh, self.placements, src_data_rank=None)


def tree_shardings(spec_tree: Any, mesh) -> Any:
    """Each `P` of a tree bound to `mesh` as a `NamedSharding`."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields"):
        return type(spec_tree)(*(tree_shardings(v, mesh) for v in spec_tree))
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(tree_shardings(v, mesh) for v in spec_tree)
    return spec_tree


def distribute(tree: Any, spec_tree: Any, mesh, *, src_data_rank: int | None = 0) -> Any:
    """Each tensor of `tree` placed on `mesh` by its spec: a DTensor whose
    local shard is this rank's part (every rank passes the full tensor;
    `distribute_tensor` keeps the values of rank `src_data_rank`, or with
    None each rank's own, which moves nothing). A tree of one dict per
    layer is moved into the specs' mesh layout first (`in_layout_of`)."""
    def place(t, spec):
        if t is None:
            return None
        return distribute_tensor(t.detach(), mesh, to_placements(spec, mesh),
                                 src_data_rank=src_data_rank)

    return _zip_map(in_layout_of(tree, spec_tree), spec_tree, place)


def in_layout_of(tree: Any, like: Any) -> Any:
    """`tree` moved into the mesh layout of `like` (specs, shardings or
    tensors), where `like` is in one and `tree` is not."""
    paths = layout_of(like)
    if paths is None or layout_of(tree) is not None:
        return tree
    return to_mesh_layout(tree, paths)


def _zip_map(tree: Any, other: Any, fn):
    if isinstance(tree, dict):
        return {k: _zip_map(v, other[k], fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_zip_map(a, b, fn) for a, b in zip(tree, other)))
    if isinstance(tree, (list, tuple)) and not isinstance(other, P):
        return type(tree)(_zip_map(a, b, fn) for a, b in zip(tree, other))
    return fn(tree, other)


def shard_offset(t: DTensor, dim: int) -> int:
    """Where this rank's shard of DTensor `t` starts along `dim` (the mesh
    dims that shard it split it in their order, as `torch.chunk` does)."""
    coord = t.device_mesh.get_coordinate()
    size, offset = t.shape[dim], 0
    for i, p in enumerate(t.placements):
        if p == Shard(dim):
            chunk = -(-size // t.device_mesh.shape[i])
            offset += coord[i] * chunk
            size = max(0, min(chunk, size - coord[i] * chunk))
    return offset


def constrain(x: Tensor, mesh, spec: P) -> Tensor:
    """`x` redistributed to `spec` on `mesh` (the reference's sharding
    constraint): a DTensor is redistributed, a plain tensor, the same on
    every rank, is distributed."""
    placements = to_placements(spec, mesh)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements)
    return distribute_tensor(x, mesh, placements)
