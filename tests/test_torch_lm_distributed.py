"""The port's multi-device LM code over `torch.distributed`, on the CPU.

Each gloo group (4 ranks, then 2) is spawned once for the module with
`gloo_group.outcomes` and a `FileStore` under a temporary
directory, as `tests/test_torch_sharded.py` does. The parent makes every
input from a seed with numpy and the reference's outputs with JAX; the
ranks run the port and hold it to them, and each rank reports every
case's outcome. Each test below reads one case.

* `EPShard.moe` (psum, a2a, zero3, bf16 combine) on 2 and 4 ranks against
  the reference's single-device `moe_apply`, float32, within its own
  distributed test's 1e-4 (`tests/test_distributed.py`, capacity factor 16
  so no token drops); the bf16 combine within bf16's rounding of the
  partial sums (2^-7 of the output's largest magnitude).
* The EP gradient: the reference's `EPShard` under `jax.grad` on a forced
  2-device host mesh (a child process) against the port's on 2 ranks, for
  every parameter and the tokens, within 1e-4 of the gradient's largest
  magnitude. Both equal the single-device gradient.
* `SeqShard.decode_attention` on 2 and 4 ranks against the reference's
  `attention_decode`, within 1e-5, at a length where some ranks hold no
  valid key.
* `compressed_psum` on 2 ranks: the mean bitwise equal to the mean of the
  reference's `compress_decompress` of each rank's gradient plus residual,
  and each new residual bitwise, over two steps.
* `make_train_step(mesh=)` for the reduced qwen3-8b in float32, on a (2, 2)
  and a (1, 2) ("data", "model") mesh, state placed by `state_specs`,
  two microbatches: two steps against the reference's unsharded step,
  losses within 2e-4, grad norms within 1e-3 relative, parameters within
  1e-5 (the tolerances of `tests/test_torch_training.py`).
* Elastic restore: the 4-rank state saved (`training.checkpoint.save`,
  rank 0 writes), restored by the 2-rank group onto its own mesh
  (`restore(shardings=)`), bitwise, each leaf in its placements.
* `ModelCtx(mesh, batch_axes, ep_shard)`: the reduced deepseek-moe-16b's
  prefill on 2 ranks with EP equals the unsharded prefill within 1e-4.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
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

EP_TOKENS = 64
EP_ATOL = 1e-4
BF16_COMBINE_REL = 2.0 ** -7
GRAD_REL = 1e-4
DECODE_ATOL = 1e-5
DECODE_LENGTHS = (37, 10)  # 10: ranks past the first slice hold no valid key
STEP_LOSS_ATOL, GNORM_REL, PARAM_ATOL = 2e-4, 1e-3, 1e-5
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 2, 8, 16
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)
# (name, dispatch, zero3, bf16 combine, mesh (data, model)) per group size
EP_CASES = {
    2: [("psum", "psum", False, False, (1, 2)), ("a2a", "a2a", False, False, (1, 2)),
        ("zero3", "psum", True, False, (2, 1)), ("bf16", "psum", False, True, (1, 2))],
    4: [("psum", "psum", False, False, (1, 4)), ("a2a", "a2a", False, False, (2, 2)),
        ("zero3", "psum", True, False, (2, 2)), ("bf16", "psum", False, True, (2, 2))],
}
TRAIN_MESHES = {4: (2, 2), 2: (1, 2)}


def _moe_cfg():
    cfg = get_config("deepseek-moe-16b").reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))


def _train_cfg():
    return dataclasses.replace(get_config("qwen3-8b").reduced(), n_layers=2)


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------


def _close(got: torch.Tensor, want, atol: float, what: str) -> None:
    want = torch.as_tensor(np.asarray(want))
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float((got.detach().to(torch.float32) - want.to(torch.float32)).abs().max())
    assert err <= atol, f"{what}: max |diff| {err} > {atol}"


def _ranks(rank: int, world: int, tmp: str) -> None:
    with open(os.path.join(tmp, "spec.pkl"), "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, f"store{world}"), world),
                            rank=rank, world_size=world, timeout=timedelta(seconds=120))
    out: dict = {}
    try:
        _ep_cases(world, spec, out)
        _decode_cases(world, spec, out)
        if world == 2:
            _grad_case(spec, out)
            _compression_case(rank, spec, out)
            _ctx_case(spec, out)
        _train_case(world, spec, tmp, out)
    finally:
        with open(os.path.join(tmp, f"out{world}_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()


def _moe_inputs(spec):
    params = pytree.tree_map(torch.from_numpy, spec["moe_params"])
    return params, torch.from_numpy(spec["moe_x"])


def _ep_cases(world: int, spec: dict, out: dict) -> None:
    from repro_torch.distributed.expert_parallel import EPShard
    from repro_torch.launch.mesh import make_host_mesh

    cfg = _moe_cfg()
    params, x = _moe_inputs(spec)
    want = spec["moe_y"]
    for name, dispatch, zero3, bf16, (data, model) in EP_CASES[world]:
        def run(dispatch=dispatch, zero3=zero3, bf16=bf16, data=data, model=model):
            mesh = make_host_mesh(data, model)
            ep = EPShard(mesh, dispatch=dispatch, zero3=zero3,
                         combine_dtype=torch.bfloat16 if bf16 else torch.float32)
            y, m = ep.moe(params, x, cfg)
            atol = BF16_COMBINE_REL * float(np.abs(want).max()) if bf16 else EP_ATOL
            _close(y, want, atol, f"ep {dispatch}")
            assert float(m["moe_drop_frac"]) == 0.0
        check(out, ("ep", name), run)


def _grad_case(spec: dict, out: dict) -> None:
    from repro_torch.distributed.expert_parallel import EPShard
    from repro_torch.launch.mesh import make_host_mesh

    def run():
        cfg = _moe_cfg()
        params, x = _moe_inputs(spec)
        leaves, tree = pytree.tree_flatten(params)
        live = [t.clone().requires_grad_() for t in leaves + [x]]
        ep = EPShard(make_host_mesh(1, 2))
        y, m = ep.moe(pytree.tree_unflatten(live[:-1], tree), live[-1], cfg)
        loss = (y * torch.from_numpy(spec["moe_ct"])).sum() + m["moe_aux"]
        grads = torch.autograd.grad(loss, live)
        want = spec["ref_grads"]
        paths = [pytree.keystr(p) for p, _ in pytree.tree_flatten_with_path(params)[0]]
        assert sorted(paths + ["x"]) == sorted(want)
        for g, path in zip(grads, paths + ["x"]):
            _close(g, want[path], GRAD_REL * float(np.abs(want[path]).max()), path)
    check(out, "grad", run)


def _decode_cases(world: int, spec: dict, out: dict) -> None:
    from repro_torch.distributed.flash_decode import SeqShard
    from repro_torch.launch.mesh import make_host_mesh

    q, k, v = (torch.from_numpy(spec["dec"][n]) for n in "qkv")
    for length in DECODE_LENGTHS:
        def run(length=length):
            got = SeqShard(make_host_mesh(world, 1)).decode_attention(q, k, v, length)
            _close(got, spec["dec"][length], DECODE_ATOL, f"decode at {length}")
        check(out, ("decode", length), run)


def _compression_case(rank: int, spec: dict, out: dict) -> None:
    from repro_torch.distributed import compression as C

    def run():
        c = spec["comp"]
        grads = [{k: torch.from_numpy(v) for k, v in g.items()} for g in c["grads"][rank]]
        state = C.init_state(grads[0])
        for step, g in enumerate(grads):
            mean, state = C.compressed_psum(g, state)
            for name in g:
                assert torch.equal(mean[name], torch.from_numpy(c["mean"][step][name])), name
                assert torch.equal(state.residual[name],
                                   torch.from_numpy(c["residual"][rank][step][name])), name
    check(out, "compression", run)


def _ctx_case(spec: dict, out: dict) -> None:
    """The reduced deepseek-moe-16b's prefill through ModelCtx on a (1, 2)
    mesh with EP, against the unsharded prefill."""
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.expert_parallel import EPShard
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import model as M

    def run():
        cfg = _moe_cfg()
        params = interop.lm_params_from_numpy(spec["lm_params"], cfg, device="cpu")
        tokens = torch.from_numpy(spec["lm_tokens"])
        want, want_state = M.prefill(params, tokens, cfg, 32)
        mesh = make_host_mesh(1, 2)
        plan = shd.ShardingPlan.for_mesh(mesh)
        placed = shd.distribute(params, shd.param_specs(cfg, params, mesh, plan), mesh)
        ctx = M.ModelCtx(mesh=mesh, batch_axes=("data",), ep_shard=EPShard(mesh))
        got, state = M.prefill(placed, tokens, cfg, 32, ctx=ctx)
        _close(got.full_tensor(), want.numpy(), EP_ATOL, "prefill logits")
        for i, (a, b) in enumerate(zip(state, want_state)):
            _close(a.k.full_tensor(), b.k.numpy(), EP_ATOL, f"layer {i} K cache")
            _close(a.v.full_tensor(), b.v.numpy(), EP_ATOL, f"layer {i} V cache")
    check(out, "ctx", run)


def _train_case(world: int, spec: dict, tmp: str, out: dict) -> None:
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as TO
    from repro_torch.training.train_step import (TrainOptions, TrainState, make_train_step,
                                                 place_state, state_specs)

    cfg = _train_cfg()
    opts = TrainOptions(microbatches=2, remat=True, param_dtype=torch.float32,
                        opt=TO.AdamWConfig(**OPT))
    mesh = make_host_mesh(*TRAIN_MESHES[world])
    plan = shd.ShardingPlan.for_mesh(mesh)
    tr = spec["train"]
    ckpt_dir = os.path.join(tmp, "ckpt")

    def fresh():
        params = interop.lm_params_from_numpy(tr["params0"], cfg, device="cpu")
        return TrainState(params=params, opt=TO.init_opt_state(params, opts.opt))

    def run():
        state = fresh()
        specs = state_specs(cfg, state, mesh, plan)
        state = place_state(state, specs, mesh)
        step = make_train_step(cfg, opts, mesh)
        for i in range(TRAIN_STEPS):
            batch = {k: torch.from_numpy(v) for k, v in tr["batches"][i].items()}
            state, m = step(state, batch)
            loss = float(m["loss"].full_tensor())
            assert abs(loss - tr["losses"][i]) <= STEP_LOSS_ATOL, (i, loss, tr["losses"][i])
            gn = float(m["grad_norm"].full_tensor())
            assert abs(gn - tr["gnorms"][i]) <= GNORM_REL * tr["gnorms"][i], (i, gn)
        got = interop.lm_params_to_numpy(pytree.tree_map(lambda t: t.full_tensor(),
                                                         state.params), cfg)
        want = {pytree.keystr(p): x for p, x in pytree.tree_flatten_with_path(tr["params"])[0]}
        got = {pytree.keystr(p): x for p, x in pytree.tree_flatten_with_path(got)[0]}
        assert sorted(got) == sorted(want)
        for path, a in got.items():
            err = float(np.abs(a - want[path]).max())
            assert err <= PARAM_ATOL, (path, err)
        if world == 4:  # the elastic case's source: saved by rank 0, as full arrays
            ckpt.save(ckpt_dir, TRAIN_STEPS, state, cfg)
            full = pytree.tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                                   else t, state)
            if dist.get_rank() == 0:
                torch.save(full, os.path.join(tmp, "saved_state.pt"))
            dist.barrier()
    check(out, ("train", world), run)

    if world == 2:
        def restore():
            like = fresh()
            specs = state_specs(cfg, like, mesh, plan)
            back = ckpt.restore(ckpt_dir, TRAIN_STEPS, like, cfg,
                                shardings=shd.tree_shardings(specs, mesh))
            saved = torch.load(os.path.join(tmp, "saved_state.pt"), weights_only=False)
            for (p, a), b, s in zip(pytree.tree_flatten_with_path(back.params)[0],
                                    pytree.tree_leaves(saved.params),
                                    pytree.tree_leaves(specs.params,
                                                       is_leaf=lambda x: isinstance(x, shd.P))):
                assert a.placements == shd.to_placements(s, mesh), pytree.keystr(p)
                assert a.dtype == b.dtype and torch.equal(a.full_tensor(), b), pytree.keystr(p)
            for tree, ref in ((back.opt.m, saved.opt.m), (back.opt.v, saved.opt.v)):
                for a, b in zip(pytree.tree_leaves(tree), pytree.tree_leaves(ref)):
                    assert torch.equal(a.full_tensor(), b)
            assert int(back.opt.step) == int(saved.opt.step) == TRAIN_STEPS
        check(out, "elastic", restore)


# ---------------------------------------------------------------------------
# The parent: inputs, reference outputs, one spawn per group size
# ---------------------------------------------------------------------------

REF_GRAD_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
sys.path.insert(0, sys.argv[1])
import dataclasses, pickle
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.distributed.expert_parallel import EPShard

with open(sys.argv[2], "rb") as f:
    d = pickle.load(f)
cfg = get_config("deepseek-moe-16b").reduced()
cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=16.0))
mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
ep = EPShard(mesh)
params = jax.tree.map(jnp.asarray, d["params"])
ct = jnp.asarray(d["ct"])

def loss(p, x):
    y, m = ep.moe(p, x, cfg)
    return jnp.sum(y * ct) + m["moe_aux"]

gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(d["x"]))
out = {jax.tree_util.keystr(p): np.asarray(g) for p, g in
       jax.tree_util.tree_flatten_with_path(gp)[0]}
out["x"] = np.asarray(gx)
with open(sys.argv[3], "wb") as f:
    pickle.dump(out, f)
"""


def _reference_train(cfg_params, tcfg) -> dict:
    """The reference's unsharded float32 train step over TRAIN_STEPS
    batches: losses, grad norms, final parameters."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.training import optimizer as JO
    from repro.training.train_step import TrainOptions as JTrainOptions
    from repro.training.train_step import init_train_state, make_train_step
    from repro_torch.training.data import DataConfig, TokenStream

    jcfg = dataclasses.replace(j_get_config("qwen3-8b").reduced(), n_layers=tcfg.n_layers)
    jopts = JTrainOptions(microbatches=2, remat=True, param_dtype=jnp.float32,
                          opt=JO.AdamWConfig(**OPT))
    state = init_train_state(jax.random.PRNGKey(0), jcfg, jopts)._replace(
        params=jax.tree.map(jnp.asarray, cfg_params))
    step = jax.jit(make_train_step(jcfg, jopts))
    data = TokenStream(DataConfig(tcfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH))
    batches, losses, gnorms = [], [], []
    for i in range(TRAIN_STEPS):
        b = data.batch(i)
        batches.append(b)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), state.params)
    return {"batches": batches, "losses": losses, "gnorms": gnorms, "params": params}


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    """Every input and reference output the ranks need, pickled once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.distributed.compression import compress_decompress
    from repro.models import model as JM
    from repro.models.attention import attention_decode
    from repro.models.moe import init_moe, moe_apply

    tmp = str(tmp_path_factory.mktemp("lm_distributed"))
    rng = np.random.default_rng(0)
    # EP: the reference distributed test's layer and tokens
    jcfg = j_get_config("deepseek-moe-16b").reduced()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=16.0))
    jp = init_moe(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    x = rng.normal(size=(EP_TOKENS, jcfg.d_model)).astype(np.float32)
    y_ref, _ = moe_apply(jp, jnp.asarray(x), jcfg)
    moe_params = jax.tree.map(np.asarray, jp)
    ct = rng.normal(size=x.shape).astype(np.float32)
    # the reference EP gradient on a forced 2-device host mesh
    with open(os.path.join(tmp, "grad_in.pkl"), "wb") as f:
        pickle.dump({"params": moe_params, "x": x, "ct": ct}, f)
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    subprocess.run([sys.executable, "-c", REF_GRAD_SCRIPT, src,
                    os.path.join(tmp, "grad_in.pkl"), os.path.join(tmp, "grad_out.pkl")],
                   check=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    with open(os.path.join(tmp, "grad_out.pkl"), "rb") as f:
        ref_grads = pickle.load(f)
    grad_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(jp)[0]] + ["x"]
    # decode: the reference distributed test's shapes
    q = rng.normal(size=(2, 1, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    dec = {"q": q, "k": k, "v": v}
    for length in DECODE_LENGTHS:
        dec[length] = np.asarray(attention_decode(jnp.asarray(q), jnp.asarray(k),
                                                  jnp.asarray(v), jnp.int32(length)))
    # compression: two ranks' gradients over two steps, the reference's
    # round trip of each (gradient + residual), their mean
    grads = [[{"w": (rng.normal(size=(8, 8)) * s).astype(np.float32),
               "b": (rng.normal(size=(300,)) * s).astype(np.float32)}
              for s in (1.0, 1e-3)] for _ in range(2)]
    res = [{n: np.zeros_like(a) for n, a in grads[r][0].items()} for r in range(2)]
    means, residuals = [], [[], []]
    for step in range(2):
        sent = []
        for r in range(2):
            gf = {n: grads[r][step][n] + res[r][n] for n in res[r]}
            sr = {n: np.asarray(compress_decompress(jnp.asarray(a))) for n, a in gf.items()}
            res[r] = {n: gf[n] - sr[n] for n in gf}
            residuals[r].append(res[r])
            sent.append(sr)
        means.append({n: (sent[0][n] + sent[1][n]) / np.float32(2) for n in sent[0]})
    # the MoE model's prefill and the dense model's train steps
    mcfg = _moe_cfg()
    lm_params = jax.tree.map(np.asarray, JM.init_params(
        jax.random.PRNGKey(5), dataclasses.replace(
            j_get_config("deepseek-moe-16b").reduced(), moe=jcfg.moe), dtype=jnp.float32))
    tcfg = _train_cfg()
    jtcfg = dataclasses.replace(j_get_config("qwen3-8b").reduced(), n_layers=tcfg.n_layers)
    params0 = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jtcfg,
                                                      dtype=jnp.float32))
    data = {"moe_params": moe_params, "moe_x": x, "moe_y": np.asarray(y_ref), "moe_ct": ct,
            "ref_grads": ref_grads, "grad_paths": grad_paths, "dec": dec,
            "comp": {"grads": grads, "mean": means, "residual": residuals},
            "lm_params": lm_params,
            "lm_tokens": rng.integers(0, mcfg.vocab_size, size=(2, 12)).astype(np.int64),
            "train": {"params0": params0, **_reference_train(params0, tcfg)}}
    with open(os.path.join(tmp, "spec.pkl"), "wb") as f:
        pickle.dump(data, f)
    return types.SimpleNamespace(tmp=tmp, data=data, ranks={})



@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("case", ["psum", "a2a", "zero3", "bf16"])
def test_expert_parallel_matches_single_device_moe(spec, world, case):
    """The module's first test; the 4-rank case comes first, so each group
    is spawned under the time limit of a test of its own."""
    assert_case(outcomes(_ranks, spec, world), ("ep", case))


def test_expert_parallel_gradient_matches_reference_ep(spec):
    """The reference's EP gradient (2 forced host devices) is the
    single-device gradient; the port's on 2 gloo ranks equals it."""
    assert_case(outcomes(_ranks, spec, 2), "grad")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("length", DECODE_LENGTHS)
def test_seq_shard_decode_matches_reference(spec, world, length):
    assert_case(outcomes(_ranks, spec, world), ("decode", length))


def test_compressed_psum_matches_reference_round_trip(spec):
    assert_case(outcomes(_ranks, spec, 2), "compression")


def test_model_ctx_prefill_with_expert_parallelism(spec):
    assert_case(outcomes(_ranks, spec, 2), "ctx")


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_train_step_matches_reference(spec, world):
    assert_case(outcomes(_ranks, spec, world), ("train", world))


def test_elastic_restore_four_ranks_to_two(spec):
    assert_case(outcomes(_ranks, spec, 2), "elastic")
