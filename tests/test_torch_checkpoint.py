"""Checkpoints across packages and the host half of fault tolerance.

A TrainState saved by either package restores in the other: the same npz
keys, shapes and stored dtypes (bfloat16 as its uint16 bits), the same
manifest fields, every leaf bitwise, the reference's stacked super-block
layout on disk. Rolling cleanup, the preemption drain, the straggler
watchdog and the elastic re-mesh plan behave as the reference's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as j_get_config
from repro.distributed import fault_tolerance as j_ft
from repro.models import model as JM
from repro.training import checkpoint as j_ckpt
from repro.training.train_step import TrainOptions as JTrainOptions
from repro.training.train_step import init_train_state as j_init_train_state
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.models import model as TM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import OptState
from repro_torch.training.train_step import (
    TrainOptions,
    TrainState,
    init_train_state,
    make_train_step,
)

FAMILIES = {"dense": ("qwen3-8b", 2), "moe": ("deepseek-moe-16b", 2),
            "hybrid": ("jamba-1.5-large-398b", 8)}


def _configs(family: str):
    arch, n_layers = FAMILIES[family]
    return (dataclasses.replace(j_get_config(arch).reduced(), n_layers=n_layers),
            dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _ref_state(family: str):
    jcfg, tcfg = _configs(family)
    return jcfg, tcfg, j_init_train_state(jax.random.PRNGKey(4), jcfg, JTrainOptions())


def _port_like(tcfg, dtype=torch.bfloat16):
    return init_train_state(torch.Generator().manual_seed(9), tcfg,
                            TrainOptions(param_dtype=dtype), device="cpu")


def _assert_same_state(tstate: TrainState, jstate, tcfg) -> None:
    """Every leaf: dtype and bits (bf16 compared through float32, exact)."""
    want = _by_path(jstate._asdict())
    got = _by_path({"params": interop.lm_params_stacked(tstate.params, tcfg),
                    "opt": OptState(step=tstate.opt.step,
                                    m=interop.lm_params_stacked(tstate.opt.m, tcfg),
                                    v=interop.lm_params_stacked(tstate.opt.v, tcfg))})
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert str(got[k].dtype) == f"torch.{w.dtype}", k
        np.testing.assert_array_equal(_np(got[k]), _np(w), err_msg=k)


@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, family):
    """A bf16 TrainState (params bf16, norms float32, m and v float32, not
    zero) saved by the reference."""
    jcfg, tcfg, jstate = _ref_state(family)
    jstate = jstate._replace(opt=jstate.opt._replace(
        step=jnp.int32(1), m=jax.tree.map(lambda p: 0.5 * p.astype(jnp.float32), jstate.params),
        v=jax.tree.map(lambda p: jnp.square(p.astype(jnp.float32)), jstate.params)))
    j_ckpt.save(str(tmp_path), 7, jstate)
    assert ckpt.latest(str(tmp_path)) == 7
    got = ckpt.restore(str(tmp_path), 7, _port_like(tcfg), tcfg)
    assert got.opt.step.dtype == torch.int32 and int(got.opt.step) == 1
    _assert_same_state(got, jstate, tcfg)


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, family):
    jcfg, tcfg, jlike = _ref_state(family)
    tstate = _port_like(tcfg)
    tstate, _ = make_train_step(tcfg, TrainOptions())(
        tstate, {k: torch.from_numpy(v)
                 for k, v in TokenStream(DataConfig(tcfg.vocab_size, 8, 2)).batch(0).items()})
    ckpt.save(str(tmp_path), 3, tstate, tcfg, extra={"who": "port"})
    restored = j_ckpt.restore(str(tmp_path), 3, jax.eval_shape(lambda: jlike))
    _assert_same_state(tstate, restored, tcfg)
    # and back: the port restores its own checkpoint bitwise
    again = ckpt.restore(str(tmp_path), 3, _port_like(tcfg), tcfg)
    for x, y in zip(pytree.tree_leaves(tstate), pytree.tree_leaves(again)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_files_match_the_reference_format(tmp_path):
    """The same tree saved by both: the same npz keys, shapes and stored
    dtypes (bf16 as uint16) and the same manifest fields."""
    tree = {"a": jnp.arange(6.0, dtype=jnp.bfloat16).reshape(2, 3),
            "b": (jnp.int32(3), {"c": jnp.ones((4,), jnp.float32)})}
    j_ft.save_checkpoint(str(tmp_path / "ref"), 1, tree)
    ttree = {"a": torch.arange(6.0).reshape(2, 3).to(torch.bfloat16),
             "b": (torch.tensor(3, dtype=torch.int32), {"c": torch.ones(4)})}
    ft.save_checkpoint(str(tmp_path / "port"), 1, ttree)
    files = {}
    for who in ("ref", "port"):
        d = tmp_path / who / "step_0000000001"
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        files[who] = (arrays, json.loads((d / ft.MANIFEST).read_text()))
    (ra, rm), (pa, pm) = files["ref"], files["port"]
    assert sorted(ra) == sorted(pa) == ["a", "b/0", "b/1/c"]
    for k in ra:
        assert ra[k].dtype == pa[k].dtype and ra[k].shape == pa[k].shape, k
        np.testing.assert_array_equal(ra[k], pa[k])
    for field in ("keys", "shapes", "dtypes", "step", "extra"):
        assert rm[field] == pm[field], field


def test_checkpoint_rolling_cleanup_and_shape_check(tmp_path):
    tree = {"x": torch.arange(4.0)}
    for s in (1, 2, 3, 4, 5):
        ft.save_checkpoint(str(tmp_path), s, tree, keep_last=2)
    assert ft.all_steps(str(tmp_path)) == [4, 5] == j_ft.all_steps(str(tmp_path))
    assert ft.latest_step(str(tmp_path)) == 5 and ft.latest_step(str(tmp_path / "no")) is None
    back = ft.restore_checkpoint(str(tmp_path), 5, {"x": torch.zeros(4)})
    assert torch.equal(back["x"], tree["x"])
    with pytest.raises(ValueError, match="shape"):
        ft.restore_checkpoint(str(tmp_path), 5, {"x": torch.zeros(5)})


def test_restore_with_shardings_places_each_leaf(tmp_path):
    """`shardings=`: each leaf goes to its sharding's `place` (a DTensor
    on that sharding's mesh in the elastic path; the 4 -> 2 rank restore
    runs on gloo ranks in `tests/test_torch_lm_distributed.py`)."""
    tree = {"x": torch.arange(4.0), "y": (torch.ones(2, 3, dtype=torch.bfloat16),)}
    ft.save_checkpoint(str(tmp_path), 1, tree)
    seen = []

    class Sharding:
        def __init__(self, tag):
            self.tag = tag

        def place(self, t):
            seen.append(self.tag)
            return (self.tag, t)

    back = ft.restore_checkpoint(str(tmp_path), 1, tree,
                                 shardings={"x": Sharding("x"), "y": (Sharding("y"),)})
    assert seen == ["x", "y"]
    assert back["x"][0] == "x" and torch.equal(back["x"][1], tree["x"])
    assert back["y"][0][1].dtype == torch.bfloat16 and torch.equal(back["y"][0][1], tree["y"][0])


def test_lm_params_to_numpy_inverts_from_numpy():
    """The port's tree to the reference's stacked layout and back, bitwise,
    for the hybrid's 8-position pattern over two super-blocks."""
    jcfg, tcfg = _configs("hybrid")
    jcfg, tcfg = (dataclasses.replace(c, n_layers=16) for c in (jcfg, tcfg))
    tp = TM.init_params(tcfg, generator=torch.Generator().manual_seed(2), device="cpu")
    tree = interop.lm_params_to_numpy(tp, tcfg)
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda: JM.init_params(jax.random.PRNGKey(0), jcfg)))
    assert jax.tree.map(lambda a: a.shape, tree) == shapes
    back = interop.lm_params_from_numpy(tree, tcfg, device="cpu", dtype=torch.bfloat16)
    for x, y in zip(pytree.tree_leaves(tp), pytree.tree_leaves(back)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---------------------------------------------------------------------------
# preemption, stragglers, elastic restarts
# ---------------------------------------------------------------------------


def test_preemption_handler():
    h = ft.PreemptionHandler(signals=(signal.SIGUSR1,))
    assert not h.should_drain
    os.kill(os.getpid(), signal.SIGUSR1)
    assert h.should_drain
    h.restore()


@pytest.mark.parametrize("times", [
    [1.0] * 10 + [5.0, 5.0, 1.0],
    [1.0, 2.0, 1.5] * 4 + [9.0, 1.0, 9.0, 9.0, 9.0],
    [0.5 + 0.1 * i for i in range(40)] + [100.0]])
def test_straggler_monitor_matches_reference(times):
    mine, ref = ft.StragglerMonitor(window=16, patience=2), j_ft.StragglerMonitor(window=16,
                                                                               patience=2)
    assert [mine.observe(t) for t in times] == [ref.observe(t) for t in times]
    mon = ft.StragglerMonitor(window=16, patience=2)
    assert [mon.observe(t) for t in [1.0] * 10 + [5.0, 5.0, 1.0]][-3:] == ["warn", "drain", None]


@pytest.mark.parametrize("n", [16, 17, 255, 256, 448, 512, 513, 1000])
def test_elastic_mesh_shape_matches_reference(n):
    assert ft.elastic_mesh_shape(n, model=16, pod_size=256) == \
        j_ft.elastic_mesh_shape(n, model=16, pod_size=256)
    with pytest.raises(ValueError):
        ft.elastic_mesh_shape(8, model=16)


def test_plan_elastic_restart_matches_reference(tmp_path):
    for s in (10, 20):
        ft.save_checkpoint(str(tmp_path), s, {"x": torch.zeros(2)})
    mine = ft.plan_elastic_restart(str(tmp_path), 512, 448)
    ref = j_ft.plan_elastic_restart(str(tmp_path), 512, 448)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.describe() == ref.describe() and mine.resume_step == 20
