"""FSDP on the super-block dim over `torch.distributed`, on the CPU.

Where the reference's rule plus `_add_fsdp` shard a stacked leaf's leading
(n_superblocks,) dim, the port holds that leaf stacked (the mesh layout of
`repro_torch.distributed.sharding`). The model here is mamba2-2.7b reduced
at d_model 1024 and 8 layers (52.3 M parameters): a small model where the
rule takes that dim of `conv_x_w` (8, 4, 2048) on a (data=2, model=2)
mesh, `P('data', None, 'model')` (d_model 256 at 32 layers does too, at
four times the layers to dispatch).

The parent makes the weights and batches from seeds and runs the
reference's unsharded float32 train step (two microbatches, remat) and
its `loss_fn` gradient; a gloo group of 4
ranks, then one of 2, is spawned once for the module, as
`tests/test_torch_lm_distributed.py` does, and each rank reports every
case:

* the layout: the stacked leaf placed (Shard(0), Shard(2)) in the
  parameters, m and v, each rank's shard the reference's rows and
  columns bitwise, and one rank's parameter bytes the sum over the
  reference's leaves of each leaf's bytes over the sizes of the mesh axes
  in its spec;
* the gradient of `loss_fn` on the placed parameters (each stack gathered,
  rows read per layer, the gradient reduce-scattered back) against the
  reference's `jax.grad`, each leaf within GRAD_RTOL of its largest
  magnitude (`tests/test_torch_training.py`'s rule);
* AdamW on the mesh layout: one `adamw_update` of the placed state with
  the reference's gradients against the unsharded update with the same
  gradients, parameters, m and v within PARAM_ATOL;
* two FSDP train steps on the (2, 2) mesh, each against the port's
  unsharded step from the same state (the sharded state gathered), and
  the first against the reference's step: loss within 2e-4 and grad norm
  within 1e-3 relative (the tolerances of `tests/test_torch_training.py`
  and `tests/test_torch_lm_distributed.py`). Parameters after a step are
  held through the AdamW case above: AdamW's first update moves a weight
  by +-lr by the sign of its gradient, so a gradient near 0 that rounds
  the other way moves it 2 lr from the other package's (the port's
  unsharded step lands 8.5e-4 from the reference's after one step at
  d_model 256 x 32 layers), and later steps drift apart from there;
* elastic restore: the 4-rank state saved (rank 0 writes) and restored by
  the 2-rank group onto a (1, 2) and a (2, 1) mesh, where no leaf is
  stacked, bitwise, each leaf in its placements;
* the reduced mamba2's prefill on a (1, 2) mesh, its heads split over
  `model` (`models/model.py::_mamba_local`), against the unsharded
  prefill: logits and every decode-state field within 1e-5 of their
  largest magnitude.

The parent then reads the checkpoint with the reference's own `restore`:
bitwise the 4-rank state through `interop.lm_params_to_numpy`.
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import types
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from gloo_group import assert_case, check, outcomes
from repro_torch import interop
from repro_torch.configs import get_config

D_MODEL, N_LAYERS = 1024, 8
MESH4 = (2, 2)
RESTORE_MESHES = ((1, 2), (2, 1))
STEP_LOSS_ATOL, GNORM_REL, PARAM_ATOL, GRAD_RTOL = 2e-4, 1e-3, 1e-5, 1e-4
PREFILL_ATOL = 1e-5  # of the largest magnitude: float32, a sum split over two ranks
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, MICROBATCHES = 2, 8, 16, 2
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)


def _cfg():
    return dataclasses.replace(get_config("mamba2-2.7b").reduced(), d_model=D_MODEL,
                               n_layers=N_LAYERS)


def _opts():
    from repro_torch.training import optimizer as TO
    from repro_torch.training.train_step import TrainOptions

    return TrainOptions(microbatches=MICROBATCHES, remat=True, param_dtype=torch.float32,
                        opt=TO.AdamWConfig(**OPT))


def _fresh(params0):
    from repro_torch.training import optimizer as TO
    from repro_torch.training.train_step import TrainState

    params = interop.lm_params_from_numpy(params0, _cfg(), device="cpu")
    return TrainState(params=params, opt=TO.init_opt_state(params, _opts().opt))


def _batches(spec) -> list[dict]:
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in spec["batches"]]


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------


def _flat(tree) -> dict:
    return {pytree.keystr(p): x for p, x in pytree.tree_flatten_with_path(tree)[0]}


def _ranks(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=300))
    out: dict = {}
    try:
        if world == 4:
            _train_cases(spec, tmp, out)
        else:
            _restore_cases(tmp, out)
            _prefill_case(out)
    finally:
        with open(os.path.join(tmp, f"out{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def _train_cases(spec: dict, tmp: str, out: dict) -> None:
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.training.train_step import (TrainState, make_model_ctx, make_train_step,
                                                 place_state, state_specs)

    cfg, opts = _cfg(), _opts()
    mesh = make_host_mesh(*MESH4)
    plan = shd.ShardingPlan.for_mesh(mesh)
    state = _fresh(spec["params0"])
    specs = state_specs(cfg, state, mesh, plan)
    placed = place_state(state, specs, mesh)

    def layout():
        assert shd.stacked_paths(cfg, mesh, plan) == ((("mamba", "conv_x_w"),),)
        stack = placed.params["stacks"][0]["mamba"]["conv_x_w"]
        assert specs.params["stacks"][0]["mamba"]["conv_x_w"] == shd.P("data", None, "model")
        d_inner = 2 * D_MODEL
        assert stack.placements == (Shard(0), Shard(2)) and stack.shape == (N_LAYERS, 4, d_inner)
        assert all("conv_x_w" not in layer["mamba"] for layer in placed.params["blocks"])
        d, m = mesh.get_coordinate()
        want = spec["params0"]["blocks"][0]["mamba"]["conv_x_w"]
        rows, cols = N_LAYERS // MESH4[0], d_inner // MESH4[1]
        want = want[d * rows:(d + 1) * rows, :, m * cols:(m + 1) * cols]
        assert np.array_equal(stack.to_local().numpy(), want)
        for tree in (placed.opt.m, placed.opt.v):
            assert tree["stacks"][0]["mamba"]["conv_x_w"].placements == (Shard(0), Shard(2))
        local = sum(t.to_local().numel() * t.element_size()
                    for t in pytree.tree_leaves(placed.params))
        assert local == spec["rank_param_bytes"], (local, spec["rank_param_bytes"])
    check(out, "layout", layout)

    def grads():
        batch = _batches(spec)[0]
        leaves, tree = pytree.tree_flatten(placed.params)
        live = [t.detach().requires_grad_() for t in leaves]
        ctx = make_model_ctx(cfg, mesh, opts)
        loss, _ = M.loss_fn(pytree.tree_unflatten(live, tree), batch["tokens"].long(),
                            batch["targets"].long(), cfg, ctx=ctx)
        with M._on_mesh(ctx):
            got = torch.autograd.grad(loss, live)
        got = pytree.tree_unflatten([g.full_tensor() for g in got], tree)
        want = _flat(spec["ref_grads"])
        for path, g in _flat(interop.lm_params_stacked(got, cfg)).items():
            w = want[path]
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_RTOL * float(np.abs(w).max()), (path, err)
    check(out, "grads", grads)

    def adamw():
        from torch.distributed.tensor import distribute_tensor

        from repro_torch.training.optimizer import OptState

        g = interop.lm_params_from_numpy(spec["ref_grads"], cfg, device="cpu")
        plain = _fresh(spec["params0"])
        p_want, o_want, _ = adamw_update(plain.params, g, plain.opt, opts.opt)
        sh = shd.tree_shardings(specs, mesh)

        def place(tree, shardings):  # each rank keeps its own shard: no communication
            return pytree.tree_map(lambda t, s: s.place(t), shd.in_layout_of(tree, shardings),
                                   shardings)

        st = _fresh(spec["params0"])
        with M._on_mesh(make_model_ctx(cfg, mesh, opts)):
            p_got, o_got, _ = adamw_update(
                place(st.params, sh.params), place(g, sh.params),
                OptState(st.opt.step, place(st.opt.m, sh.opt.m), place(st.opt.v, sh.opt.v)),
                opts.opt)
        for got, want in ((p_got, p_want), (o_got.m, o_want.m), (o_got.v, o_want.v)):
            want = shd.in_layout_of(want, got)
            for (path, a), b in zip(pytree.tree_flatten_with_path(got)[0],
                                    pytree.tree_leaves(want)):
                local = distribute_tensor(b, mesh, a.placements, src_data_rank=None).to_local()
                err = float((a.to_local() - local).abs().max())
                assert err <= PARAM_ATOL, (pytree.keystr(path), err)
    check(out, "adamw", adamw)

    def train():
        step = make_train_step(cfg, opts, mesh)
        plain_step = make_train_step(cfg, opts)
        nonlocal placed
        for i, batch in enumerate(_batches(spec)):
            # the parameters gathered (a copy: a replicated leaf's full_tensor()
            # is its local tensor); a step's loss and grad norm read no AdamW state
            params = pytree.tree_map(lambda t: t.full_tensor().clone(), placed.params)
            start = TrainState(params=params, opt=init_opt_state(params, opts.opt))
            placed, m = step(placed, batch)
            _, want = plain_step(start, batch)
            wants = [want] + ([spec["ref"]] if i == 0 else [])
            for want in wants:
                loss, gn = (float(m[k].full_tensor()) for k in ("loss", "grad_norm"))
                assert abs(loss - float(want["loss"])) <= STEP_LOSS_ATOL, (i, loss, want)
                assert abs(gn - float(want["grad_norm"])) <= GNORM_REL * float(
                    want["grad_norm"]), (i, gn, want)
        stack = placed.params["stacks"][0]["mamba"]["conv_x_w"]
        assert stack.placements == (Shard(0), Shard(2))
        assert all(bool(torch.isfinite(t.to_local()).all())
                   for t in pytree.tree_leaves(placed.params))
        ckpt.save(os.path.join(tmp, "ckpt"), TRAIN_STEPS, placed, cfg)
        whole = pytree.tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t,
                                placed)
        if dist.get_rank() == 0:
            torch.save(whole, os.path.join(tmp, "saved_state.pt"))
        dist.barrier()
    check(out, "train", train)


def _prefill_case(out: dict) -> None:
    """The reduced mamba2's prefill on a (1, 2) mesh (its 8 heads split over
    `model`: `model.py::_mamba_local`) against the unsharded prefill."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M

    def run():
        cfg = get_config("mamba2-2.7b").reduced()
        params = M.init_params(cfg, generator=torch.Generator().manual_seed(1),
                               dtype=torch.float32, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, size=(2, 40)))
        want, want_state = M.prefill(params, tokens, cfg, 64)
        mesh = make_host_mesh(1, 2)
        plan = shd.ShardingPlan.for_mesh(mesh)
        placed = shd.distribute(params, shd.param_specs(cfg, params, mesh, plan), mesh)
        got, state = M.prefill(placed, tokens, cfg, 64,
                               ctx=M.ModelCtx(mesh=mesh, batch_axes=("data",)))
        err = float((got.full_tensor() - want).abs().max())
        assert err <= PREFILL_ATOL * float(want.abs().max()), err
        for a, b in zip(state, want_state):
            for name, x, y in zip(a._fields, a, b):
                err = float((x.full_tensor() - y).abs().max())
                assert err <= PREFILL_ATOL * max(float(y.abs().max()), 1.0), (name, err)
    check(out, "prefill", run)


def _restore_cases(tmp: str, out: dict) -> None:
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_step import state_specs

    cfg = _cfg()
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        params0 = pickle.load(f)["params0"]
    saved = torch.load(os.path.join(tmp, "saved_state.pt"), weights_only=False)
    for shape in RESTORE_MESHES:
        def run(shape=shape):
            mesh = make_host_mesh(*shape)
            plan = shd.ShardingPlan.for_mesh(mesh)
            assert not any(shd.stacked_paths(cfg, mesh, plan))
            like = _fresh(params0)
            specs = state_specs(cfg, like, mesh, plan)
            back = ckpt.restore(os.path.join(tmp, "ckpt"), TRAIN_STEPS, like, cfg,
                                shardings=shd.tree_shardings(specs, mesh))
            assert "stacks" not in back.params
            for (p, a), s in zip(pytree.tree_flatten_with_path(back.params)[0],
                                 pytree.tree_leaves(specs.params,
                                                    is_leaf=lambda x: isinstance(x, shd.P))):
                assert a.placements == shd.to_placements(s, mesh), pytree.keystr(p)
            for got, want in ((back.params, saved.params), (back.opt.m, saved.opt.m),
                              (back.opt.v, saved.opt.v)):
                got = _flat(interop.lm_params_stacked(
                    pytree.tree_map(lambda t: t.full_tensor(), got), cfg))
                want = _flat(interop.lm_params_stacked(want, cfg))
                assert sorted(got) == sorted(want)
                for path, a in got.items():
                    assert a.dtype == want[path].dtype and torch.equal(a, want[path]), path
            assert int(back.opt.step) == int(saved.opt.step) == TRAIN_STEPS
        check(out, ("restore", shape), run)


# ---------------------------------------------------------------------------
# The parent: inputs, both packages' unsharded steps, one spawn per group
# ---------------------------------------------------------------------------


def _jcfg():
    from repro.configs import get_config as j_get_config

    return dataclasses.replace(j_get_config("mamba2-2.7b").reduced(), d_model=D_MODEL,
                               n_layers=N_LAYERS)


def _reference_first_step(params0, batch) -> dict:
    """The reference's unsharded float32 train step from `params0`: its
    loss and grad norm."""
    import jax
    import jax.numpy as jnp

    from repro.training import optimizer as JO
    from repro.training.train_step import TrainOptions as JTrainOptions
    from repro.training.train_step import init_train_state, make_train_step

    jopts = JTrainOptions(microbatches=MICROBATCHES, remat=True, param_dtype=jnp.float32,
                          opt=JO.AdamWConfig(**OPT))
    state = init_train_state(jax.random.PRNGKey(0), _jcfg(), jopts)._replace(
        params=jax.tree.map(jnp.asarray, params0))
    _, m = make_train_step(_jcfg(), jopts)(state, {k: jnp.asarray(v) for k, v in batch.items()})
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def _rank_param_bytes(shapes, mesh_axes: dict) -> int:
    """One rank's parameter bytes by the reference's specs on a (data,
    model) mesh: each leaf's bytes over the sizes of the axes it names."""
    import jax

    from repro.distributed import sharding as jshd

    mesh = types.SimpleNamespace(axis_names=tuple(mesh_axes), shape=dict(mesh_axes))
    specs = jshd.param_specs(_jcfg(), shapes, mesh, jshd.ShardingPlan.for_mesh(mesh))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        split = 1
        for entry in spec:
            for axis in ((entry,) if isinstance(entry, str) else (entry or ())):
                split *= mesh_axes[axis]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // split
    return total


def _reference_grads(params0, batch) -> dict:
    """The reference's float32 `loss_fn` gradient at `params0` on `batch`."""
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM

    def loss(p):
        return JM.loss_fn(p, jnp.asarray(batch["tokens"]), jnp.asarray(batch["targets"]),
                          _jcfg())[0]

    return jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        jax.tree.map(jnp.asarray, params0)))


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.models import model as JM
    from repro_torch.training.data import DataConfig, TokenStream

    tmp = str(tmp_path_factory.mktemp("stacked_fsdp"))
    init = lambda: JM.init_params(jax.random.PRNGKey(0), _jcfg(), dtype=jnp.float32)  # noqa: E731
    params0 = jax.tree.map(np.asarray, init())
    data = TokenStream(DataConfig(_cfg().vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batches = [data.batch(i) for i in range(TRAIN_STEPS)]
    spec = {"params0": params0, "batches": batches,
            "ref": _reference_first_step(params0, batches[0]),
            "ref_grads": _reference_grads(params0, batches[0]),
            "rank_param_bytes": _rank_param_bytes(jax.eval_shape(init),
                                                  dict(zip(("data", "model"), MESH4)))}
    with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
        pickle.dump(spec, f)
    return types.SimpleNamespace(tmp=tmp, data=spec, ranks={})



def test_stacked_leaf_holds_the_reference_bytes(spec):
    assert_case(outcomes(_ranks, spec, 4), "layout")


def test_stacked_gradient_matches_reference(spec):
    assert_case(outcomes(_ranks, spec, 4), "grads")


def test_adamw_on_the_mesh_layout_matches_unsharded(spec):
    assert_case(outcomes(_ranks, spec, 4), "adamw")


def test_fsdp_train_matches_unsharded_and_reference(spec):
    assert_case(outcomes(_ranks, spec, 4), "train")


@pytest.mark.parametrize("shape", RESTORE_MESHES)
def test_elastic_restore_of_stacked_state_four_ranks_to_two(spec, shape):
    assert_case(outcomes(_ranks, spec, 2), ("restore", shape))


def test_mamba_prefill_on_a_model_split_mesh(spec):
    assert_case(outcomes(_ranks, spec, 2), "prefill")


def test_stacked_checkpoint_restores_in_the_reference(spec):
    """The 4-rank checkpoint read by the reference's `restore`: its
    parameters, m and v are the 4-rank state's, bitwise."""
    import jax

    from repro.training import checkpoint as j_ckpt
    from repro.training import optimizer as JO
    from repro.training.train_step import TrainOptions as JTrainOptions
    from repro.training.train_step import init_train_state

    assert_case(outcomes(_ranks, spec, 4), "train")
    jopts = JTrainOptions(microbatches=MICROBATCHES, remat=True,
                          param_dtype=jax.numpy.float32, opt=JO.AdamWConfig(**OPT))
    like = jax.eval_shape(lambda: init_train_state(jax.random.PRNGKey(0), _jcfg(), jopts))
    back = j_ckpt.restore(os.path.join(spec.tmp, "ckpt"), TRAIN_STEPS, like)
    saved = torch.load(os.path.join(spec.tmp, "saved_state.pt"), weights_only=False)
    assert "stacks" in saved.params
    for got, want in ((back.params, saved.params), (back.opt.m, saved.opt.m),
                      (back.opt.v, saved.opt.v)):
        got = _flat(jax.tree.map(np.asarray, got))
        want = _flat(interop.lm_params_to_numpy(want, _cfg()))
        assert sorted(got) == sorted(want)
        for path, a in got.items():
            assert np.array_equal(a, want[path]), path
    assert int(back.opt.step) == TRAIN_STEPS
