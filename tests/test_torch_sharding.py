"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's, on the CPU, without processes.

The rules read only a mesh's axis names and sizes, so both sides take a
stand-in mesh at the production shapes, single (16, 16) and multi
(2, 16, 16): the reference's with `axis_names` and a `shape` dict, the
port's with `mesh_dim_names` and a `shape` tuple. Parameter shapes come
from `jax.eval_shape` (reference, stacked) and meta tensors (port, one
dict per layer). For every LM arch, with FSDP on and off, each port leaf's
spec equals the reference's spec of its stacked leaf, entry for entry:
with the super-block entry dropped for a per-layer leaf, and unchanged
for a leaf the port holds stacked (where the reference shards the
super-block dim itself: the mesh layout of `sharding.py`). `decode_state_specs` is held
the same way for `decode_32k` and `long_500k`. `to_placements` is checked
on a small gloo-free fake mesh.
"""
from __future__ import annotations

import types

import jax
import pytest
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as jshd
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.configs.shapes import LM_CELLS, cell_skipped
from repro_torch.distributed import sharding as shd
from repro_torch.models import model as TM

LM_ARCHS = ["kimi-k2-1t-a32b", "deepseek-moe-16b", "musicgen-large", "stablelm-3b",
            "qwen3-8b", "starcoder2-15b", "qwen1.5-4b", "jamba-1.5-large-398b",
            "llava-next-mistral-7b", "mamba2-2.7b"]
MESHES = {"single": {"data": 16, "model": 16}, "multi": {"pod": 2, "data": 16, "model": 16}}


def _meshes(kind: str):
    axes = MESHES[kind]
    ref = types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))
    port = types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))
    return ref, port


def _norm(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _ref_by_path(tree) -> dict:
    return {jshd._path_str(p): s for p, s in jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from _port_leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_specs_match_reference(arch, mesh_kind, fsdp):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    jmesh, tmesh = _meshes(mesh_kind)
    jplan = jshd.ShardingPlan.for_mesh(jmesh, fsdp=fsdp)
    tplan = shd.ShardingPlan.for_mesh(tmesh, fsdp=fsdp)
    assert (tplan.batch_axes, tplan.model_axis, tplan.fsdp_axes) == \
        (jplan.batch_axes, jplan.model_axis, jplan.fsdp_axes)
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    ref = _ref_by_path(jshd.param_specs(jcfg, shapes, jmesh, jplan))
    tparams = TM.init_params(tcfg, generator=None, device="meta")
    n_pat, n_sb = len(tcfg.pattern()), tcfg.n_superblocks()
    specs = shd.param_specs(tcfg, tparams, tmesh, tplan)
    layout = shd.to_mesh_layout(tparams, shd.stacked_paths(tcfg, tmesh, tplan))
    held = set()  # reference leaves the port holds, per layer or stacked
    n_per_layer = n_stacked = 0
    for path, leaf in _port_leaves(layout):
        got = specs
        for k in path:
            got = got[k]
        assert got == shd.param_spec(path, tuple(leaf.shape), tcfg, tmesh, tplan), path
        got = _norm(got)
        if path[0] == "blocks":  # the reference's entry for the super-block dim dropped
            key = "/".join(str(p) for p in ("blocks", path[1] % n_pat) + path[2:])
            want = _norm(ref[key])
            want = want + (None,) * (leaf.dim() + 1 - len(want))
            assert want[0] is None, (path, want)
            assert got + (None,) * (leaf.dim() - len(got)) == want[1:], (path, got, want)
            n_per_layer += 1
        elif path[0] == shd.STACKS:  # stacked: the reference's spec as it is
            key = "/".join(str(p) for p in ("blocks",) + path[1:])
            assert leaf.shape[0] == n_sb and want_dim0(ref[key]) is not None, path
            assert got == _norm(ref[key]), (path, got, ref[key])
            n_stacked += 1
        else:
            key = "/".join(str(p) for p in path)
            want = _norm(ref[key])
            assert got + (None,) * (leaf.dim() - len(got)) == \
                want + (None,) * (leaf.dim() - len(want)), path
        held.add(key)
    assert held == set(ref), set(ref) ^ held
    assert n_per_layer > 0
    assert n_stacked == sum(len(p) for p in shd.stacked_paths(tcfg, tmesh, tplan))


def want_dim0(spec):
    """The reference spec's entry for dim 0, None where it has none."""
    return (_norm(spec) + (None,))[0]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,cell", [
    ("qwen3-8b", "decode_32k"), ("deepseek-moe-16b", "decode_32k"),
    ("mamba2-2.7b", "decode_32k"), ("jamba-1.5-large-398b", "decode_32k"),
    ("mamba2-2.7b", "long_500k"), ("jamba-1.5-large-398b", "long_500k")])
def test_decode_state_specs_match_reference(arch, cell, mesh_kind):
    jcfg, tcfg = j_get_config(arch), get_config(arch)
    c = LM_CELLS[cell]
    assert not cell_skipped(tcfg, c)
    jmesh, tmesh = _meshes(mesh_kind)
    jplan, tplan = jshd.ShardingPlan.for_mesh(jmesh), shd.ShardingPlan.for_mesh(tmesh)
    shapes = jax.eval_shape(lambda: JM.init_decode_state(jcfg, c.global_batch, c.seq_len))
    ref = _ref_by_path(jshd.decode_state_specs(jcfg, shapes, jmesh, jplan))
    state = TM.init_decode_state(tcfg, c.global_batch, c.seq_len, device="meta")
    specs = shd.decode_state_specs(tcfg, state, tmesh, tplan)
    n_pat = len(tcfg.pattern())
    n = 0
    for i, layer in enumerate(state):
        for field in layer._fields:
            leaf = getattr(layer, field)
            if leaf is None:
                continue
            want = _norm(ref[f"{i % n_pat}/{field}"])
            want = want + (None,) * (leaf.dim() + 1 - len(want))
            got = _norm(getattr(specs[i], field))
            assert want[0] is None and got + (None,) * (leaf.dim() - len(got)) == want[1:], \
                (i, field, got, want)
            n += 1
    assert n == sum(1 for layer in state for t in layer if t is not None)


def test_batch_spec_and_fsdp_dim_match_reference():
    for kind in MESHES:
        jmesh, tmesh = _meshes(kind)
        jplan, tplan = jshd.ShardingPlan.for_mesh(jmesh), shd.ShardingPlan.for_mesh(tmesh)
        for shape in [(256, 4096), (32, 32768, 4096), (1, 524288), (48, 7), ()]:
            assert _norm(shd.batch_spec(shape, tmesh, tplan)) == \
                _norm(jshd.batch_spec(shape, jmesh, jplan)), (kind, shape)
    for shape, fs, taken in [((64, 2048, 1408), 16, (0,)), ((36, 4096), 16, ()),
                             ((7, 9), 16, ()), ((32, 32, 8), 8, (1,))]:
        assert shd.fsdp_dim(shape, fs, taken) == jshd.fsdp_dim(shape, fs, taken)


def test_to_placements_orders_tuple_entries_by_the_mesh():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 4, 2))
    assert shd.to_placements(shd.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.to_placements(shd.P(), mesh) == (Replicate(),) * 3
    assert shd.to_placements(shd.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="order"):
        shd.to_placements(shd.P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        shd.to_placements(shd.P("data", "data"), mesh)


def test_stacked_dim_sharding_raises_naming_the_leaf():
    """mamba2-2.7b's conv_x_w stack (64, 4, 5120) on the single mesh: the
    reference's FSDP takes the 64-layer dim. The port holds that leaf
    stacked there, placed P('data', None, 'model'): each data rank keeps 4
    of the 64 layers' rows. Its per-layer spec raises, naming the leaf."""
    jcfg, tcfg = j_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    jmesh, tmesh = _meshes("single")
    plan = shd.ShardingPlan.for_mesh(tmesh)
    ref = jshd.param_specs(jcfg, jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)), jmesh,
        jshd.ShardingPlan.for_mesh(jmesh))
    assert _norm(ref["blocks"][0]["mamba"]["conv_x_w"]) == ("data", None, "model")
    assert shd.stacked_paths(tcfg, tmesh, plan) == (
        (("mamba", "conv_x_w"), ("mamba", "conv_x_b"), ("mamba", "norm")),)
    specs = shd.param_specs(tcfg, TM.init_params(tcfg, generator=None, device="meta"),
                            tmesh, plan)
    assert specs["stacks"][0]["mamba"]["conv_x_w"] == shd.P("data", None, "model")
    assert "conv_x_w" not in specs["blocks"][0]["mamba"]
    assert shd.to_placements(specs["stacks"][0]["mamba"]["conv_x_w"], tmesh) == (
        Shard(0), Shard(2))
    assert 64 // dict(zip(tmesh.mesh_dim_names, tmesh.shape))["data"] == 4
    with pytest.raises(ValueError, match="blocks/0/mamba/conv_x_w"):
        shd.param_spec(("blocks", 0, "mamba", "conv_x_w"), (4, 5120), tcfg, tmesh, plan)
    # FSDP off: no leaf is stacked, the tree stays one dict per layer
    off = shd.ShardingPlan.for_mesh(tmesh, fsdp=False)
    assert shd.stacked_paths(tcfg, tmesh, off) == ((),)


def test_mesh_layout_round_trips_bitwise():
    """A small tree moved into the mesh layout and read back per layer
    (`layer_rows`, `with_rows`) gives every leaf back bitwise, and the
    reference's stacked tree (`interop.lm_params_stacked`) is the same from
    either layout."""
    import dataclasses

    import torch

    from repro_torch import interop

    cfg = dataclasses.replace(get_config("mamba2-2.7b").reduced(), n_layers=3)
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            dtype=torch.float32, device="cpu")
    paths = ((("mamba", "conv_x_w"), ("mamba", "norm")),)
    layout = shd.to_mesh_layout(params, paths)
    assert shd.layout_of(layout) == paths and shd.layout_of(params) is None
    assert layout["stacks"][0]["mamba"]["conv_x_w"].shape == (3,) + tuple(
        params["blocks"][0]["mamba"]["conv_x_w"].shape)
    rows = shd.layer_rows(layout["stacks"], cfg.n_superblocks())
    for a, layer, r in zip(params["blocks"], layout["blocks"], rows):
        back = shd.with_rows(layer, r)
        for path, t in _port_leaves(a):
            got = back
            for k in path:
                got = got[k]
            assert torch.equal(got, t), path
    want, got = (interop.lm_params_stacked(t, cfg) for t in (params, layout))
    flat = dict(_port_leaves(want))
    assert dict(_port_leaves(got)).keys() == flat.keys()
    for path, t in _port_leaves(got):
        assert torch.equal(t, flat[path]), path
    assert torch.equal(shd.in_layout_of(params, layout)["stacks"][0]["mamba"]["norm"],
                       layout["stacks"][0]["mamba"]["norm"])
