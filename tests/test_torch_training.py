"""Parity of the port's training slice with the JAX reference, on the CPU.

The same numpy inputs (and the reference's random weights, carried across
with `interop.lm_params_from_numpy`) go to both packages. Tolerances:
  * attention cores, float32: outputs and gradients within ATTN_ATOL
    (7.2e-7 measured at 32 keys, 4.6e-6 at 1,024: the packages sum the
    products in other orders);
  * `loss_fn` at float32: the loss and its parts within 5e-5, the logit
    tolerance of tests/test_torch_lm.py (9.5e-7 measured); each gradient
    leaf within GRAD_RTOL of that leaf's largest reference gradient (2.4e-5
    measured, on the hybrid's 8 layers; dense and MoE 1.5e-6);
  * AdamW: parameters, m and v within ADAMW_RTOL (XLA:CPU fuses the
    update's multiply-adds by the host's instruction set; PyTorch rounds
    each operation), the global norm within NORM_RTOL (the leaves' squares
    are summed in another association);
  * train steps: losses within STEP_LOSS_ATOL of the reference's over
    TRAIN_STEPS steps; AdamW turns gradient differences near 0 into
    +-lr steps, so parameters are not compared after the first step;
  * TokenStream batches and remat against no remat in the port: exact.

Checkpoints and the fault-tolerance helpers: tests/test_torch_checkpoint.py.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.training import optimizer as JO
from repro.training.data import DataConfig as JDataConfig
from repro.training.data import TokenStream as JTokenStream
from repro.training.train_step import TrainOptions as JTrainOptions
from repro.training.train_step import init_train_state as j_init_train_state
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.training import optimizer as TO
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.train_step import (
    TrainOptions,
    TrainState,
    init_train_state,
    make_model_ctx,
    make_train_step,
)

ATTN_ATOL = 1e-5
LOSS_ATOL = 5e-5
GRAD_RTOL = 1e-4
ADAMW_RTOL = 2e-6
NORM_RTOL = 2e-6
STEP_LOSS_ATOL = 2e-4
TRAIN_STEPS = 3

# each family at a reduced width; the hybrid keeps its 8-layer pattern
FAMILIES = {"dense": ("qwen3-8b", 2), "moe": ("deepseek-moe-16b", 2),
            "ssm": ("mamba2-2.7b", 2), "hybrid": ("jamba-1.5-large-398b", 8)}


def _configs(family: str):
    arch, n_layers = FAMILIES[family]
    return (dataclasses.replace(j_get_config(arch).reduced(), n_layers=n_layers),
            dataclasses.replace(get_config(arch).reduced(), n_layers=n_layers))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _params(family: str, dtype=jnp.float32, seed: int = 1):
    jcfg, tcfg = _configs(family)
    jp = JM.init_params(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def _by_path(tree) -> dict:
    return {jax.tree_util.keystr(p): a for p, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_grads(tp, tcfg, toks, tgts, ctx=TM.ModelCtx()):
    leaves, spec = pytree.tree_flatten(tp)
    live = [p.detach().clone().requires_grad_() for p in leaves]
    loss, aux = TM.loss_fn(pytree.tree_unflatten(live, spec), torch.from_numpy(toks).long(),
                           torch.from_numpy(tgts).long(), tcfg, ctx=ctx)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, pytree.tree_unflatten(list(grads), spec)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def _attention_case(fn_j, fn_t, s: int, seed: int):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(2, s, 4, 8)).astype(np.float32)  # GQA: 4 query heads
    k, v = (rng.normal(size=(2, s, 2, 8)).astype(np.float32) for _ in range(2))
    dout = rng.normal(size=q.shape).astype(np.float32)
    want, vjp = jax.vjp(fn_j, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = fn_t(tq, tk, tv)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATTN_ATOL, rtol=0)
    for name, g, w in zip("qkv", got_g, want_g):
        np.testing.assert_allclose(_np(g), _np(w), atol=ATTN_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 12])
def test_attention_full_matches_reference(s, causal):
    _attention_case(lambda q, k, v: JA.attention_full(q, k, v, causal=causal),
                    lambda q, k, v: TA.attention_full(q, k, v, causal=causal), s, s)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,chunk", [(32, 8), (16, 16), (24, 8)])
def test_attention_blockwise_matches_reference(s, chunk, causal):
    """S a multiple of the chunk: several chunks, one chunk, an odd count."""
    _attention_case(lambda q, k, v: JA.attention_blockwise(q, k, v, causal=causal, chunk=chunk),
                    lambda q, k, v: TA.attention_blockwise(q, k, v, causal=causal, chunk=chunk),
                    s, s + chunk)


def test_attention_blockwise_refuses_a_partial_chunk():
    x = torch.zeros((1, 12, 2, 8))
    with pytest.raises(ValueError, match="multiple of 8"):
        TA.attention_blockwise(x, x, x, chunk=8)


def test_dense_core_dispatches_as_the_reference(monkeypatch):
    """Full attention up to FULL_ATTN_MAX_SEQ keys (bitwise the full
    core), blockwise above, with BLOCKWISE_CHUNK keys per chunk."""
    assert (TA.FULL_ATTN_MAX_SEQ, TA.BLOCKWISE_CHUNK) == (JA.FULL_ATTN_MAX_SEQ,
                                                          JA.BLOCKWISE_CHUNK)
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(1, 16, 2, 8)).astype(np.float32))
    assert torch.equal(TA.attention_dense_core(x, x, x), TA.attention_full(x, x, x))
    monkeypatch.setattr(TA, "FULL_ATTN_MAX_SEQ", 0)
    monkeypatch.setattr(JA, "FULL_ATTN_MAX_SEQ", 0)
    _attention_case(JA.attention_core, TA.attention_dense_core, JA.BLOCKWISE_CHUNK, 4)


def test_bf16_attention_full_rounds_as_the_reference():
    """bf16 in: scores and probabilities rounded to bf16 as the reference's
    einsums round them (within one bf16 ulp of O(1) outputs)."""
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(2, 16, 4, 16)).astype(np.float32) for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    want = JA.attention_full(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = TA.attention_full(*(torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
                              for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2 ** -7, rtol=0)


def test_training_forward_never_reaches_the_kernel(monkeypatch):
    """`forward`, `loss_fn` and their backward run the plain cores: the
    flash-attention op (no autograd) would raise; prefill still calls it."""
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise AssertionError("the training path reached flash_attention")

    _, tcfg, _, tp = _params("dense")
    toks = np.random.default_rng(2).integers(1, tcfg.vocab_size, (2, 8)).astype(np.int32)
    monkeypatch.setattr(TA, "flash_attention", refuse)
    for remat in (False, True):
        loss, _, grads = _port_grads(tp, tcfg, toks, toks, TM.ModelCtx(remat=remat))
        assert torch.isfinite(loss)
    assert not calls
    with pytest.raises(AssertionError, match="reached flash_attention"):
        TM.prefill(tp, torch.from_numpy(toks).long(), tcfg, 16)


# ---------------------------------------------------------------------------
# loss_fn, remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_fn_and_grads_match_reference(family):
    jcfg, tcfg, jp, tp = _params(family)
    rng = np.random.default_rng(11)
    toks, tgts = (rng.integers(1, tcfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(2))
    (jl, jaux), jg = jax.value_and_grad(JM.loss_fn, has_aux=True)(
        jp, jnp.asarray(toks), jnp.asarray(tgts), jcfg)
    tl, taux, tg = _port_grads(tp, tcfg, toks, tgts)
    assert tl.dtype == torch.float32 and sorted(taux) == sorted(jaux)
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL
    for name in jaux:
        assert abs(float(taux[name]) - float(jaux[name])) <= LOSS_ATOL, name
    assert (float(taux["moe_aux"]) > 0) == (tcfg.moe is not None)
    got, want = _by_path(interop.lm_params_to_numpy(tg, tcfg)), _by_path(jg)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=0, err_msg=key,
                                   atol=GRAD_RTOL * max(float(np.abs(w).max()), 1e-30))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_remat_is_bitwise_in_the_port(family):
    """Checkpointed super-blocks recompute the same forward: loss, its
    parts and every gradient bitwise (the MoE's dispatch and combine too)."""
    _, tcfg, _, tp = _params(family)
    rng = np.random.default_rng(12)
    toks, tgts = (rng.integers(1, tcfg.vocab_size, (2, 16)).astype(np.int32) for _ in range(2))
    l0, a0, g0 = _port_grads(tp, tcfg, toks, tgts)
    l1, a1, g1 = _port_grads(tp, tcfg, toks, tgts, TM.ModelCtx(remat=True))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a0[k], a1[k]) for k in a0)
    for x, y in zip(pytree.tree_leaves(g0), pytree.tree_leaves(g1)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1e9, 0.5])
def test_adamw_update_matches_reference(param_dtype, state_dtype, clip):
    """Three steps from the same state and gradients: parameters, m, v,
    the learning rate and the global norm; clipping on and off."""
    rng = np.random.default_rng(5)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    p0 = {"w": rng.normal(size=(6, 5)), "b": rng.normal(size=(5,)),
          "stack": rng.normal(size=(2, 3, 4))}
    jp = {k: jnp.asarray(v, jdt[param_dtype]) for k, v in p0.items()}
    tp = {k: torch.from_numpy(_np(v).copy()).to(tdt[param_dtype]) for k, v in jp.items()}
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=clip)
    jcfg = JO.AdamWConfig(state_dtype=jdt[state_dtype], **kw)
    tcfg = TO.AdamWConfig(state_dtype=tdt[state_dtype], **kw)
    jst, tst = JO.init_opt_state(jp, jcfg), TO.init_opt_state(tp, tcfg)
    for i in range(3):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        jp, jst, jm = JO.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, jcfg)
        tp, tst, tm = TO.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                                      tst, tcfg)
        assert int(tst.step) == int(jst.step) == i + 1 and tst.step.dtype == torch.int32
        assert float(tm["lr"]) == float(jm["lr"])
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=NORM_RTOL)
        for k in p0:
            assert str(tp[k].dtype) == f"torch.{jp[k].dtype}"
            assert str(tst.m[k].dtype) == f"torch.{jst.m[k].dtype}"
            tol = ADAMW_RTOL if param_dtype == state_dtype == "float32" else 2 ** -7
            for got, want in ((tp[k], jp[k]), (tst.m[k], jst.m[k]), (tst.v[k], jst.v[k])):
                np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                           atol=tol * float(np.abs(_np(want)).max()), err_msg=k)


def test_adamw_matches_a_numpy_transcription():
    """tests/test_training.py's literal numpy transcription of one step."""
    cfg = TO.AdamWConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                         weight_decay=0.1, grad_clip=1e9)
    w = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = {"w": torch.from_numpy(w.copy())}
    g = {"w": torch.full((2, 3), 0.5)}
    newp, newst, _ = TO.adamw_update(p, g, TO.init_opt_state(p, cfg), cfg)
    lr = float(TO.cosine_lr(cfg, torch.tensor(1, dtype=torch.int32)))
    m1 = 0.1 * 0.5 / (1 - 0.9)
    v1 = 0.05 * 0.25 / (1 - 0.95)
    want = w - lr * (m1 / (np.sqrt(v1) + cfg.eps) + 0.1 * w)
    np.testing.assert_allclose(newp["w"].numpy(), want, rtol=1e-5)
    assert int(newst.step) == 1
    assert newp["w"] is p["w"], "the update is in place"


def test_weight_decay_skips_vectors():
    cfg = TO.AdamWConfig(peak_lr=1e-3, warmup_steps=0, total_steps=10, weight_decay=1.0)
    p = {"w": torch.ones((2, 2)), "scale": torch.ones((4,))}
    g = {"w": torch.zeros((2, 2)), "scale": torch.zeros((4,))}
    newp, _, _ = TO.adamw_update(p, g, TO.init_opt_state(p, cfg), cfg)
    assert float((newp["scale"] - 1.0).abs().max()) == 0.0  # no decay
    assert float((newp["w"] - 1.0).abs().max()) > 0.0  # decayed


@pytest.mark.parametrize("family", list(FAMILIES))
def test_weight_decay_follows_the_stacked_layout(family):
    """Decay alone (zero gradients) on a model's trees: the reference
    decays every leaf of two or more dimensions in its stacked layout,
    which takes in the 1-D block norms, biases and Mamba-2 vectors (a
    leaf of zeros stays zero); the port's per-layer tree decays the same
    leaves, to ADAMW_RTOL."""
    jcfg, tcfg, jp, tp = _params(family)
    kw = dict(peak_lr=1e-2, warmup_steps=0, total_steps=10, weight_decay=0.5)
    jo, to = JO.AdamWConfig(**kw), TO.AdamWConfig(**kw)
    jp1, _, _ = JO.adamw_update(jp, jax.tree.map(jnp.zeros_like, jp), JO.init_opt_state(jp, jo), jo)
    tp1, _, _ = TO.adamw_update(tp, pytree.tree_map(torch.zeros_like, tp),
                                TO.init_opt_state(tp, to), to)
    j0, j1 = _by_path(jp), _by_path(jp1)
    t1 = _by_path(interop.lm_params_to_numpy(tp1, tcfg))
    assert sorted(t1) == sorted(j1)
    moves = {k: np.ndim(v) >= 2 and bool(np.any(_np(v) != 0)) for k, v in j0.items()}
    # one layer's vectors (2-D when stacked) are among the decayed leaves
    assert any(m and np.ndim(j0[k]) == 2 and k.startswith("['blocks']") for k, m in moves.items())
    for k in j1:
        assert (not np.array_equal(_np(j1[k]), _np(j0[k]))) == moves[k], k
        assert (not np.array_equal(t1[k], _np(j0[k]))) == moves[k], k
        np.testing.assert_allclose(t1[k], _np(j1[k]), rtol=ADAMW_RTOL, atol=0, err_msg=k)


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 12_345])
def test_cosine_schedule_matches_reference_and_bounds(step):
    cfg = TO.AdamWConfig(peak_lr=3e-4, warmup_steps=100, total_steps=10_000)
    lr = float(TO.cosine_lr(cfg, torch.tensor(step, dtype=torch.int32)))
    assert lr == float(JO.cosine_lr(JO.AdamWConfig(peak_lr=3e-4, warmup_steps=100,
                                                   total_steps=10_000), jnp.int32(step)))
    assert 0.0 <= lr <= cfg.peak_lr * (1 + 1e-6)
    if step >= cfg.total_steps:
        assert lr == pytest.approx(cfg.peak_lr * cfg.min_lr_frac, rel=1e-3)


def test_grad_clip_caps_update_norm():
    cfg = TO.AdamWConfig(peak_lr=1.0, warmup_steps=0, total_steps=10, grad_clip=1.0,
                         weight_decay=0.0)
    p = {"w": torch.zeros((4, 4))}
    g = {"w": torch.full((4, 4), 100.0)}
    _, st, m = TO.adamw_update(p, g, TO.init_opt_state(p, cfg), cfg)
    assert float(m["grad_norm"]) == pytest.approx(400.0)
    # the effective m is the clipped gradient
    assert float(st.m["w"].abs().max()) <= 0.1 * (100.0 / 400.0) * 1.01


def test_global_norm_groups_many_leaves(monkeypatch):
    """Updates in groups of leaves (GROUP_ELEMENTS) equal one group's."""
    rng = np.random.default_rng(9)
    base = {f"l{i}": rng.normal(size=(3, 7)).astype(np.float32) for i in range(5)}
    grads = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in base.items()}
    cfg = TO.AdamWConfig(warmup_steps=0, total_steps=5, grad_clip=0.1)
    outs = []
    for group in (TO.GROUP_ELEMENTS, 45):
        monkeypatch.setattr(TO, "GROUP_ELEMENTS", group)
        p = {k: torch.from_numpy(v.copy()) for k, v in base.items()}
        outs.append(TO.adamw_update(p, grads, TO.init_opt_state(p, cfg), cfg))
    assert len(TO._groups(5, [21] * 5)) == 3
    for k in base:
        assert torch.equal(outs[0][0][k], outs[1][0][k])
        assert torch.equal(outs[0][1].v[k], outs[1][1].v[k])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,seq,batch,seed,step", [
    (97, 16, 4, 3, 7), (512, 33, 2, 0, 0), (50_304, 64, 3, 5, 123)])
def test_token_stream_is_bitwise_the_reference(vocab, seq, batch, seed, step):
    want = JTokenStream(JDataConfig(vocab, seq, batch, seed=seed)).batch(step)
    got = TokenStream(DataConfig(vocab, seq, batch, seed=seed)).batch(step)
    for k in ("tokens", "targets"):
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    assert (got["targets"][:, :-1] == got["tokens"][:, 1:]).all()
    stream = iter(TokenStream(DataConfig(vocab, seq, batch, seed=seed)))
    np.testing.assert_array_equal(next(stream)["tokens"],
                                  JTokenStream(JDataConfig(vocab, seq, batch, seed=seed))
                                  .batch(0)["tokens"])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

_OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=20)


def _run_steps(family: str, microbatches: int, remat: bool, steps: int = TRAIN_STEPS):
    """The same float32 weights and TokenStream batches through both
    packages' train steps; returns the per-step metrics of each."""
    jcfg, tcfg, jp, tp = _params(family, seed=0)
    jopts = JTrainOptions(microbatches=microbatches, remat=remat, param_dtype=jnp.float32,
                          opt=JO.AdamWConfig(**_OPT))
    topts = TrainOptions(microbatches=microbatches, remat=remat, param_dtype=torch.float32,
                         opt=TO.AdamWConfig(**_OPT))
    jstate = j_init_train_state(jax.random.PRNGKey(0), jcfg, jopts)._replace(params=jp)
    tstate = TrainState(params=tp, opt=TO.init_opt_state(tp, topts.opt))
    jstep = jax.jit(j_make_train_step(jcfg, jopts))
    tstep = make_train_step(tcfg, topts)
    data = TokenStream(DataConfig(tcfg.vocab_size, 16, 4))
    jm, tm = [], []
    for i in range(steps):
        b = data.batch(i)
        jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        jm.append({k: float(v) for k, v in m.items()})
        tstate, m = tstep(tstate, {k: torch.from_numpy(v) for k, v in b.items()})
        tm.append({k: float(v) for k, v in m.items()})
    return jm, tm, tstate


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_train_steps_match_reference(family, microbatches):
    jm, tm, state = _run_steps(family, microbatches, remat=microbatches == 2)
    assert int(state.opt.step) == TRAIN_STEPS
    for i, (j, t) in enumerate(zip(jm, tm)):
        assert sorted(t) == sorted(j)
        for k in ("loss", "nll", "zloss", "moe_aux"):
            assert abs(t[k] - j[k]) <= STEP_LOSS_ATOL, (i, k, t[k], j[k])
        assert t["lr"] == j["lr"]
        assert t["grad_norm"] == pytest.approx(j["grad_norm"], rel=1e-3), i


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_microbatches_agree(family):
    """One and two microbatches see the same tokens: losses within
    STEP_LOSS_ATOL (the MoE's expert capacity depends on the microbatch's
    token count, so its losses differ in both packages alike)."""
    _, m1, _ = _run_steps(family, 1, remat=False)
    _, m2, _ = _run_steps(family, 2, remat=True)
    for a, b in zip(m1, m2):
        assert abs(a["loss"] - b["loss"]) <= STEP_LOSS_ATOL
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-4)


def test_microbatches_split_interleaved(monkeypatch):
    """Microbatch i takes rows i, i + mb, ... (the reference's swapaxes
    split), seen through the tokens loss_fn receives."""
    seen = []
    real = TM.loss_fn

    def spy(params, tokens, targets, cfg, **kw):
        seen.append(tokens.clone())
        return real(params, tokens, targets, cfg, **kw)

    monkeypatch.setattr(TM, "loss_fn", spy)
    _, tcfg = _configs("dense")
    opts = TrainOptions(microbatches=2, param_dtype=torch.float32)
    state = init_train_state(torch.Generator().manual_seed(0), tcfg, opts, device="cpu")
    toks = torch.arange(6 * 4, dtype=torch.int32).reshape(6, 4) % tcfg.vocab_size
    make_train_step(tcfg, opts)(state, {"tokens": toks, "targets": toks})
    assert [s[:, 0].tolist() for s in seen] == [[0, 8, 16], [4, 12, 20]]


def test_bf16_training_lowers_the_loss():
    _, tcfg = _configs("dense")
    opts = TrainOptions(microbatches=2, opt=TO.AdamWConfig(peak_lr=3e-3, warmup_steps=2,
                                                           total_steps=12,
                                                           state_dtype=torch.bfloat16))
    state = init_train_state(torch.Generator().manual_seed(0), tcfg, opts, device="cpu")
    assert state.params["embed"]["table"].dtype == torch.bfloat16
    assert state.opt.m["blocks"][0]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert state.params["final_norm"]["scale"].dtype == torch.float32
    step = make_train_step(tcfg, opts)
    data = TokenStream(DataConfig(tcfg.vocab_size, 32, 8))
    losses = []
    for i in range(12):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in data.batch(i).items()})
        assert all(torch.isfinite(v) for v in m.values())
        losses.append(float(m["loss"]))
    assert state.params["embed"]["table"].dtype == torch.bfloat16
    assert losses[-1] < losses[0] - 0.1, losses


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_make_model_ctx_matches_reference_on_meshes(family):
    """The context the step runs under, port against reference, on
    stand-in meshes (the function reads only axis names and sizes): batch
    axes, EP where the experts divide `model` with the knobs' dispatch,
    combine type and zero3, sequence parallelism, remat."""
    import types

    from repro.training.train_step import make_model_ctx as j_make_model_ctx

    jcfg, tcfg = _configs(family)
    assert make_model_ctx(tcfg, None, TrainOptions()).remat
    assert make_model_ctx(tcfg, None, TrainOptions()).mesh is None
    for axes in ({"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4},
                 {"data": 8, "model": 1}, {"data": 2, "model": 3}):
        jmesh = types.SimpleNamespace(axis_names=tuple(axes), shape=dict(axes))
        tmesh = types.SimpleNamespace(mesh_dim_names=tuple(axes), shape=tuple(axes.values()))
        for knobs in ({}, {"ep_dispatch": "a2a", "moe_combine_bf16": True, "ep_zero3": True,
                           "seq_parallel": True, "remat": False}, {"use_ep": False}):
            want = j_make_model_ctx(jcfg, jmesh, JTrainOptions(**knobs))
            got = make_model_ctx(tcfg, tmesh, TrainOptions(**knobs))
            assert got.mesh is tmesh and got.batch_axes == want.batch_axes
            assert (got.seq_axis, got.remat) == (want.seq_axis, want.remat)
            assert (got.ep_shard is None) == (want.ep_shard is None), (axes, knobs)
            if want.ep_shard is not None:
                assert got.ep_shard.token_axes == want.ep_shard.token_axes
                assert got.ep_shard.dispatch == want.ep_shard.dispatch
                assert got.ep_shard.zero3 == want.ep_shard.zero3
                assert str(got.ep_shard.combine_dtype).removeprefix("torch.") == \
                    jnp.dtype(want.ep_shard.combine_dtype).name
    assert [f.name for f in dataclasses.fields(TrainOptions)] == \
        [f.name for f in dataclasses.fields(JTrainOptions)]


