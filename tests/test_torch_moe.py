"""Parity of the port's MoE layer (`repro_torch.models.moe`) with the JAX
reference, on the CPU.

The reference's random weights are carried across as numpy arrays; the
tokens are numpy draws fed to both. Tolerances:
  * float32: gates and the aux loss within 1e-6, the layer output within
    1e-5 (the packages sum the expert matmuls and the combine in other
    orders: the reference scatter-adds in (expert, slot) order, the port
    gathers and sums over k); expert ids, the dispatch and the dropped
    fraction equal;
  * bfloat16 activations and weights: MOE_BF16_ATOL absolute and
    MOE_BF16_REL_L2 relative L2 on the output, and each output within
    MOE_BF16_ULPS bf16 ulps of its own magnitude plus as many of the
    output's rms (the rule the card's full-width check uses), ids equal.
    Both round the expert matmuls' outputs to bf16 (2^-8 relative), with
    other summation orders inside them.
Equal ids need no near-tie in the router: every test asserts that the
reference's k-th and (k+1)-th probabilities are at least NEAR_TIE apart,
so a failure there names its cause.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import moe as JMoE
from repro_torch.configs import get_config
from repro_torch.models import moe as TMoE

GATE_ATOL = 1e-6
Y_ATOL = 1e-5
MOE_BF16_ATOL, MOE_BF16_REL_L2 = 2e-2, 1e-2
MOE_BF16_ULPS = 2
NEAR_TIE = 1e-5


def _configs(capacity_factor=1.25, mlp_variant="swiglu", shared=1):
    """The reduced deepseek-moe-16b (8 experts, top-2) in both packages."""
    out = []
    for cfg in (j_get_config("deepseek-moe-16b").reduced(),
                get_config("deepseek-moe-16b").reduced()):
        moe = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor,
                                  num_shared_experts=shared)
        out.append(dataclasses.replace(cfg, moe=moe, mlp_variant=mlp_variant))
    return out


def _torch_tree(tree, dtype=None):
    """A reference parameter tree as torch tensors, leaf dtypes kept (or
    `dtype` for every leaf but the float32 router)."""
    if isinstance(tree, dict):
        return {k: (_torch_tree(v) if k == "router" else _torch_tree(v, dtype))
                for k, v in tree.items()}
    t = torch.from_numpy(np.asarray(jnp.asarray(tree, jnp.float32)).copy())
    return t.to(dtype or getattr(torch, str(tree.dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_no_near_tie(jparams, x, k: int) -> None:
    logits = np.asarray(x, np.float64) @ np.asarray(jparams["router"]["w"], np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = np.sort(p / p.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    gap = float((p[:, k - 1] - p[:, k]).min())
    assert gap >= NEAR_TIE, f"a router near-tie ({gap:.3g}) would make ids ambiguous"


def _layer(seed: int, dtype=jnp.float32, **kw):
    jcfg, tcfg = _configs(**kw)
    jp = JMoE.init_moe(jax.random.PRNGKey(seed), jcfg, dtype=dtype)
    return jcfg, tcfg, jp, _torch_tree(jp)


def _tokens(seed: int, t: int, d: int) -> np.ndarray:
    """Normal draws around one shared direction, so the router favours
    some experts and a capacity factor of 1.25 drops tokens."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, d)) + 1.5 * rng.normal(size=(1, d))).astype(np.float32)


def test_init_moe_tree_matches_reference():
    jcfg, tcfg = _configs()
    jp = JMoE.init_moe(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = TMoE.init_moe(torch.Generator().manual_seed(0), tcfg, dtype=torch.bfloat16,
                       device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_t = {tuple(p): v for p, v in _paths(tp)}
    assert len(flat_j) == len(flat_t)
    for path, leaf in flat_j:
        key = tuple(k.key for k in path)
        assert tuple(flat_t[key].shape) == leaf.shape, key
        assert str(flat_t[key].dtype) == f"torch.{leaf.dtype}", key
    assert tp["router"]["w"].dtype == torch.float32
    for pos, kind in ((0, "kind_moe"), (1, "kind_moe")):
        assert kind in TMoE.init_moe_or_dense(torch.Generator(), tcfg, pos, device="cpu")
    jamba = get_config("jamba-1.5-large-398b").reduced()
    assert "kind_dense" in TMoE.init_moe_or_dense(torch.Generator(), jamba, 1,
                                                   device="cpu")
    assert "kind_moe" in TMoE.init_moe_or_dense(torch.Generator(), jamba, 2, device="cpu")


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("t", [1, 4, 48])
def test_router_probs_matches_reference(t):
    jcfg, tcfg, jp, tp = _layer(0)
    x = _tokens(t, t, jcfg.d_model)
    _assert_no_near_tie(jp, x, jcfg.moe.top_k)
    jg, ji, ja = JMoE.router_probs(jp, jnp.asarray(x), jcfg.moe)
    tg, ti, ta = TMoE.router_probs(tp, torch.from_numpy(x), tcfg.moe)
    assert tg.dtype == torch.float32 and ta.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=GATE_ATOL, rtol=0)
    np.testing.assert_allclose(float(ta), float(ja), atol=GATE_ATOL, rtol=0)


def test_capacity_matches_reference():
    for arch in ("deepseek-moe-16b", "kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        for reduced in (False, True):
            jm, tm = j_get_config(arch), get_config(arch)
            if reduced:
                jm, tm = jm.reduced(), tm.reduced()
            for cf in (0.5, 1.0, 1.25, 2.0, 16.0):
                jmc = dataclasses.replace(jm.moe, capacity_factor=cf)
                tmc = dataclasses.replace(tm.moe, capacity_factor=cf)
                for t in (1, 2, 3, 7, 16, 33, 512, 4096, 1 << 20):
                    assert TMoE._capacity(t, tmc) == JMoE._capacity(t, jmc), (arch, cf, t)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mlp_variant", ["swiglu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [1.25, 16.0])
def test_moe_apply_matches_reference(capacity_factor, mlp_variant, shared):
    """At capacity factor 1.25 tokens are dropped, at 16 none."""
    jcfg, tcfg, jp, tp = _layer(1, capacity_factor=capacity_factor,
                                mlp_variant=mlp_variant, shared=shared)
    assert ("shared" in tp) == bool(shared)
    x = _tokens(2, 40, jcfg.d_model)
    _assert_no_near_tie(jp, x, jcfg.moe.top_k)
    jy, jm = JMoE.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, tm = TMoE.moe_apply(tp, torch.from_numpy(x), tcfg)
    assert ty.dtype == torch.float32 and ty.shape == (40, tcfg.d_model)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=Y_ATOL, rtol=0)
    assert isinstance(tm["moe_drop_frac"], torch.Tensor)
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    assert (float(tm["moe_drop_frac"]) > 0) == (capacity_factor < 2)
    np.testing.assert_allclose(float(tm["moe_aux"]), float(jm["moe_aux"]),
                               atol=GATE_ATOL, rtol=0)


def _bf16_ulp(a):
    """The spacing of bfloat16 numbers at |a| (8 significant bits)."""
    _, e = np.frexp(np.maximum(np.abs(np.asarray(a, np.float32)), np.float32(2.0 ** -126)))
    return np.ldexp(np.float32(1.0), e - 8)


def test_moe_apply_bf16_matches_reference():
    """bf16 weights and activations, the router in float32, as served."""
    jcfg, tcfg, jp, _ = _layer(3, dtype=jnp.bfloat16)
    tp = _torch_tree(jp)
    assert tp["experts"]["w_up"].dtype == torch.bfloat16
    assert tp["router"]["w"].dtype == torch.float32
    x = _tokens(7, 64, jcfg.d_model)
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    _assert_no_near_tie(jp, xb, jcfg.moe.top_k)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    _, ji, _ = JMoE.router_probs(jp, jx, jcfg.moe)
    _, ti, _ = TMoE.router_probs(tp, tx, tcfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    jy, jm = JMoE.moe_apply(jp, jx, jcfg)
    ty, tm = TMoE.moe_apply(tp, tx, tcfg)
    assert ty.dtype == torch.bfloat16
    g, w = _np(ty), _np(jy)
    np.testing.assert_allclose(g, w, atol=MOE_BF16_ATOL, rtol=0)
    assert np.linalg.norm(g - w) / np.linalg.norm(w) <= MOE_BF16_REL_L2
    rms = np.sqrt(np.mean(np.square(w)))
    ulps = MOE_BF16_ULPS * (_bf16_ulp(w) + _bf16_ulp(rms))
    assert (np.abs(g - w) <= ulps).all(), float((np.abs(g - w) / ulps).max())
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])


def test_dispatch_keeps_first_tokens_and_combines_each_once():
    """Every expert keeps its first `cap` tokens in token order (the stable
    sort); a kept (token, k) pair is combined once, a dropped one not at
    all: with identity-like experts the output counts the kept pairs."""
    jcfg, tcfg, jp, tp = _layer(5, capacity_factor=0.5, shared=0)
    t, k, e = 24, tcfg.moe.top_k, tcfg.moe.num_experts
    x = torch.from_numpy(_tokens(6, t, tcfg.d_model))
    _, idx, _ = TMoE.router_probs(tp, x, tcfg.moe)
    cap = TMoE._capacity(t, tcfg.moe)
    kept = np.zeros((t, k), bool)
    seen = np.zeros(e, int)
    for j in range(t * k):
        ex = int(idx.reshape(-1)[j])
        kept[j // k, j % k] = seen[ex] < cap
        seen[ex] += 1
    assert 0 < kept.sum() < t * k
    _, m = TMoE.moe_apply(tp, x, tcfg)
    assert float(m["moe_drop_frac"]) == pytest.approx(1 - kept.mean(), abs=1e-7)
    # gelu experts of a one-hot weight: each kept pair adds gelu(1) * gate
    d, f = tcfg.d_model, tcfg.moe.d_ff_expert
    cfg = dataclasses.replace(tcfg, mlp_variant="gelu")
    eye = torch.zeros((e, d, f))
    eye[:, 0, 0] = 1.0
    down = torch.zeros((e, f, d))
    down[:, 0, 0] = 1.0
    ones = torch.zeros((t, d))
    ones[:, 0] = 1.0
    p = {"router": tp["router"], "experts": {"w_gate": eye, "w_up": eye, "w_down": down}}
    gates, idx2, _ = TMoE.router_probs(p, ones, cfg.moe)
    y, _ = TMoE.moe_apply(p, ones, cfg)
    assert torch.equal(idx2[0], idx2[-1])  # identical tokens route alike
    g1 = torch.nn.functional.gelu(torch.tensor(1.0), approximate="tanh")
    cap2 = TMoE._capacity(t, cfg.moe)
    want = torch.tensor([float(gates[i].sum()) if i < cap2 else 0.0 for i in range(t)])
    torch.testing.assert_close(y[:, 0], g1 * want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("ep_size", [2, 4])
def test_expert_slices_sum_to_the_single_device_layer(ep_size):
    """`moe_apply(ep_size=, ep_index=)` on one rank's expert slice, with no
    axis (no all-reduce): the slices' routed outputs summed over the ranks
    equal the whole layer's, within float32 rounding (1e-5), and each
    slice carries the shared experts once. The collective runs in
    `tests/test_torch_lm_distributed.py` on gloo ranks."""
    jcfg, tcfg, jp, tp = _layer(3, capacity_factor=16.0)
    x = torch.from_numpy(_tokens(4, 64, tcfg.d_model))
    y_full, m_full = TMoE.moe_apply(tp, x, tcfg)
    shared = TMoE.mlp(tp["shared"], x, tcfg.mlp_variant).to(torch.float32)
    e_loc = tcfg.moe.num_experts // ep_size
    routed = torch.zeros_like(y_full)
    for r in range(ep_size):
        p = {**tp, "experts": {k: w[r * e_loc:(r + 1) * e_loc]
                               for k, w in tp["experts"].items()}}
        y, m = TMoE.moe_apply(p, x, tcfg, ep_size=ep_size, ep_index=r)
        assert float(m["moe_aux"]) == float(m_full["moe_aux"])
        routed += y - shared
    torch.testing.assert_close(routed + shared, y_full, atol=1e-5, rtol=0)
    y_ref, _ = JMoE.moe_apply(jp, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose((routed + shared).numpy(), np.asarray(y_ref), atol=1e-4)
    with pytest.raises(ValueError, match="split"):
        TMoE.moe_apply(tp, x, tcfg, ep_size=3)
