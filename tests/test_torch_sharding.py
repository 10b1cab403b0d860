"""The port's sharding rules (`repro_torch.distributed.sharding`) against
the reference's, on the CPU, without processes.

The rules read only a mesh's axis names and sizes, so both sides take a
stand-in mesh at the production shapes, single (16, 16) and multi
(2, 16, 16): the reference's with `axis_names` and a `shape` dict, the
port's with `mesh_dim_names` and a `shape` tuple. Parameter shapes come
from `jax.eval_shape` (reference, stacked) and meta tensors (port, one
dict per layer). For every LM arch, with FSDP on and off, each port leaf's
spec equals the reference's spec of its stacked leaf with the super-block
entry dropped, entry for entry; where the reference shards the super-block
dim itself, the port raises naming the leaf. `decode_state_specs` is held
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


def _held(port_spec_of, ref_specs: dict, leaves, ref_key) -> int:
    """Each port leaf's spec (or its raise) against the reference's."""
    n = 0
    for path, leaf in leaves:
        want = _norm(ref_specs[ref_key(path)])
        want = want + (None,) * (leaf.dim() + 1 - len(want))
        if want[0] is not None:
            with pytest.raises(shd.StackedDimSharding, match=ref_key(path)):
                port_spec_of(path, leaf)
            continue
        got = _norm(port_spec_of(path, leaf))
        got = got + (None,) * (leaf.dim() - len(got))
        assert got == want[1:], (path, got, want)
        n += 1
    return n


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
    n_pat = len(tcfg.pattern())

    def ref_key(path):
        if path[0] == "blocks":
            return "/".join(str(p) for p in ("blocks", path[1] % n_pat) + path[2:])
        return "/".join(str(p) for p in path)

    def top_level(path, leaf):
        want = _norm(ref[ref_key(path)])
        return want + (None,) * (leaf.dim() - len(want))

    leaves = list(_port_leaves(tparams))
    blocks = [(p, x) for p, x in leaves if p[0] == "blocks"]
    for path, leaf in leaves:
        if path[0] != "blocks":
            got = _norm(shd.param_spec(path, tuple(leaf.shape), tcfg, tmesh, tplan))
            assert got + (None,) * (leaf.dim() - len(got)) == top_level(path, leaf), path
    n = _held(lambda path, x: shd.param_spec(path, tuple(x.shape), tcfg, tmesh, tplan),
              ref, blocks, ref_key)
    assert n > 0
    if n == len(blocks):  # the whole tree maps, leaf for leaf as above
        specs = shd.param_specs(tcfg, tparams, tmesh, tplan)
        for path, leaf in leaves:
            got = specs
            for k in path:
                got = got[k]
            assert got == shd.param_spec(path, tuple(leaf.shape), tcfg, tmesh, tplan)
    else:
        with pytest.raises(shd.StackedDimSharding):
            shd.param_specs(tcfg, tparams, tmesh, tplan)


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
    reference's FSDP takes the 64-layer dim; the port cannot and says so."""
    jcfg, tcfg = j_get_config("mamba2-2.7b"), get_config("mamba2-2.7b")
    jmesh, tmesh = _meshes("single")
    ref = jshd.param_specs(jcfg, jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)), jmesh,
        jshd.ShardingPlan.for_mesh(jmesh))
    assert _norm(ref["blocks"][0]["mamba"]["conv_x_w"])[0] == "data"
    with pytest.raises(shd.StackedDimSharding, match="blocks/0/mamba/conv_x_w"):
        shd.param_spec(("blocks", 0, "mamba", "conv_x_w"), (4, 5120), tcfg, tmesh,
                       shd.ShardingPlan.for_mesh(tmesh))
