"""Parity of the port's Mamba-2 layer (`repro_torch.models.mamba2`) with the
JAX reference, on the CPU.

Numpy inputs from a seed go through both packages. Tolerances (float32):
  * the chunked SSD core, a layer's prefill output and every `SSMState`
    field, and a run of decode steps: SSD_ATOL = 1e-5 absolute;
  * the SSD at the model's decay rates and chunks up to the full width's
    256: the SSD takes differences of within-chunk cumulative decays that
    cancel (cum[t] - cum[u], with |cum| in the thousands), so both
    packages land off the exact answer by their own float32 rounding. A
    float64 run of the plain recurrence is the witness: the port's error
    against it stays within SSD_WITNESS_RATIO of the reference's own
    (measured 0.24-1.14);
  * `_softplus`, `_causal_conv`, `_conv_step`: 1e-6.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mamba2 as JM2
from repro_torch.configs import get_config
from repro_torch.models import mamba2 as TM2

SSD_ATOL = 1e-5
SSD_WITNESS_RATIO = 1.5
ELEM_ATOL = 1e-6


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, atol, what=""):
    assert got.shape == tuple(np.shape(want)), (what, got.shape, np.shape(want))
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0, err_msg=what)


@pytest.fixture(scope="module")
def layer():
    """The reduced mamba2-2.7b layer (d 64, 8 heads of 16, d_state 16,
    chunk 32) in float32, the reference's weights carried across."""
    jcfg = j_get_config("mamba2-2.7b").reduced()
    tcfg = get_config("mamba2-2.7b").reduced()
    jp = JM2.init_mamba2(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = {k: {"w": _t(v["w"])} if isinstance(v, dict) else _t(v)
          for k, v in jax.tree.map(np.asarray, jp).items()}
    return jcfg, tcfg, jp, tp


def test_init_mamba2_tree_matches_reference():
    jcfg = j_get_config("jamba-1.5-large-398b").reduced()
    tcfg = get_config("jamba-1.5-large-398b").reduced()
    jp = JM2.init_mamba2(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = TM2.init_mamba2(torch.Generator().manual_seed(0), tcfg, dtype=torch.bfloat16,
                         device="cpu")
    assert sorted(tp) == sorted(jp)
    for k, v in jp.items():
        leaf, tleaf = (v["w"], tp[k]["w"]) if isinstance(v, dict) else (v, tp[k])
        assert tuple(tleaf.shape) == leaf.shape, k
        assert str(tleaf.dtype) == f"torch.{leaf.dtype}", k
    for k in ("A_log", "dt_bias", "D", "norm"):
        assert tp[k].dtype == torch.float32
    np.testing.assert_allclose(tp["A_log"].numpy(), np.asarray(jp["A_log"]),
                               atol=ELEM_ATOL, rtol=0)


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-1e4, 1e4, 41), np.linspace(-30, 30, 601),
                        [0.0, 15.0, 20.0, 20.5, 25.0, 88.0, 1e30, -1e30]]).astype(np.float32)
    np.testing.assert_allclose(TM2._softplus(_t(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               atol=ELEM_ATOL, rtol=1e-7)


def test_causal_conv_and_conv_step_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 12)).astype(np.float32)
    w = rng.normal(size=(4, 12)).astype(np.float32)
    b = rng.normal(size=(12,)).astype(np.float32)
    _close(TM2._causal_conv(_t(x), _t(w), _t(b)),
           JM2._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)), ELEM_ATOL)
    win = rng.normal(size=(2, 3, 12)).astype(np.float32)
    for dtype in (jnp.float32, jnp.bfloat16):  # a bf16 input promotes as JAX does
        xt = jnp.asarray(x[:, 0]).astype(dtype)
        jo, jw = JM2._conv_step(jnp.asarray(win), xt, jnp.asarray(w), jnp.asarray(b))
        to, tw = TM2._conv_step(_t(win), _t(_np(xt)).to(getattr(torch, str(dtype.dtype))),
                                _t(w), _t(b))
        assert tw.dtype == torch.float32
        _close(to, jo, ELEM_ATOL, "conv step out")
        _close(tw, jw, 0.0, "conv step window")


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("s", [16, 21])
@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference(chunk, s, with_h0):
    """Lengths that are and are not chunk multiples, with and without h0."""
    rng = np.random.default_rng(100 * chunk + s)
    bt, h, p, n = 2, 2, 4, 8
    args = [rng.normal(size=(bt, s, h, p)), rng.normal(size=(bt, s, h)),
            np.abs(rng.normal(size=h)) + 0.3, rng.normal(size=(bt, s, n)),
            rng.normal(size=(bt, s, n)), rng.normal(size=h)]
    args = [a.astype(np.float32) for a in args]
    h0 = rng.normal(size=(bt, h, n, p)).astype(np.float32) if with_h0 else None
    jy, jh = JM2.ssd_chunked(*map(jnp.asarray, args), chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TM2.ssd_chunked(*map(_t, args), chunk, h0=None if h0 is None else _t(h0))
    assert th.dtype == torch.float32
    _close(ty, jy, SSD_ATOL, "y")
    _close(th, jh, SSD_ATOL, "h_final")


def _recurrence_float64(x, dt, A, B, C, D, h0):
    """The SSD as its definition, one step at a time in float64:
    h_t = exp(-dt_t A) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t + D x_t."""
    x, dt, A, B, C, D = (np.asarray(a, np.float64) for a in (x, dt, A, B, C, D))
    bt, s, h, p = x.shape
    dt = np.logaddexp(dt, 0.0)
    hs = np.zeros((bt, h, B.shape[-1], p)) if h0 is None else h0.astype(np.float64)
    ys = np.empty_like(x)
    for t in range(s):
        hs = (hs * np.exp(-dt[:, t] * A[None])[..., None, None]
              + np.einsum("bn,bh,bhp->bhnp", B[:, t], dt[:, t], x[:, t]))
        ys[:, t] = np.einsum("bn,bhnp->bhp", C[:, t], hs) + x[:, t] * D[None, :, None]
    return ys, hs


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk,s", [(16, 16), (32, 64), (32, 100), (64, 128), (64, 200),
                                     (128, 300), (256, 512)])
def test_ssd_chunked_against_float64_recurrence(chunk, s, with_h0):
    """At the model's decay rates (A from 1 to 16 over 8 heads) and long
    chunks the port is as close to the exact SSD as the reference is."""
    rng = np.random.default_rng(100 * chunk + s)
    bt, h, p, n = 2, 8, 4, 8
    args = [rng.normal(size=(bt, s, h, p)), rng.normal(size=(bt, s, h)),
            np.linspace(1.0, 16.0, h), rng.normal(size=(bt, s, n)),
            rng.normal(size=(bt, s, n)), rng.normal(size=h)]
    args = [a.astype(np.float32) for a in args]
    h0 = rng.normal(size=(bt, h, n, p)).astype(np.float32) if with_h0 else None
    jy, jh = JM2.ssd_chunked(*map(jnp.asarray, args), chunk,
                             h0=None if h0 is None else jnp.asarray(h0))
    ty, th = TM2.ssd_chunked(*map(_t, args), chunk, h0=None if h0 is None else _t(h0))
    y64, h64 = _recurrence_float64(*args, h0)
    for name, got, want, exact in (("y", ty, jy, y64), ("h_final", th, jh, h64)):
        err_port = np.abs(_np(got).astype(np.float64) - exact).max()
        err_ref = np.abs(_np(want).astype(np.float64) - exact).max()
        assert err_port <= SSD_WITNESS_RATIO * err_ref, (name, err_port, err_ref)


@pytest.mark.parametrize("s", [2, 21, 40])
def test_mamba2_prefill_matches_reference(layer, s):
    """Outputs and every SSMState field; s = 2 pads the conv tails, s = 40
    spans two chunks of 32."""
    jcfg, tcfg, jp, tp = layer
    x = np.random.default_rng(s).normal(size=(2, s, tcfg.d_model)).astype(np.float32)
    jo, js = JM2.mamba2_prefill(jp, jnp.asarray(x), jcfg)
    to, ts = TM2.mamba2_prefill(tp, _t(x), tcfg)
    _close(to, jo, SSD_ATOL, "out")
    for name in TM2.SSMState._fields:
        _close(getattr(ts, name), getattr(js, name), SSD_ATOL, name)
    _close(TM2.mamba2_forward(tp, _t(x), tcfg), jo, SSD_ATOL, "forward")


def test_mamba2_decode_steps_match_reference(layer):
    """A prefill of 21 tokens, then 6 decode steps, the reference's state
    threaded beside the port's; and from the zero state."""
    jcfg, tcfg, jp, tp = layer
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 27, tcfg.d_model)).astype(np.float32)
    _, js = JM2.mamba2_prefill(jp, jnp.asarray(x[:, :21]), jcfg)
    _, ts = TM2.mamba2_prefill(tp, _t(x[:, :21]), tcfg)
    zj = JM2.mamba2_init_state(jcfg, 2)
    zt = TM2.mamba2_init_state(tcfg, 2, device="cpu")
    for name in TM2.SSMState._fields:
        assert getattr(zt, name).dtype == torch.float32
        _close(getattr(zt, name), getattr(zj, name), 0.0, name)
    for i in range(21, 27):
        xi = x[:, i:i + 1]
        jo, js = JM2.mamba2_decode_step(jp, jnp.asarray(xi), js, jcfg)
        to, ts = TM2.mamba2_decode_step(tp, _t(xi), ts, tcfg)
        _close(to, jo, SSD_ATOL, f"step {i}")
        for name in TM2.SSMState._fields:
            _close(getattr(ts, name), getattr(js, name), SSD_ATOL, f"step {i} {name}")
        jo, zj = JM2.mamba2_decode_step(jp, jnp.asarray(xi), zj, jcfg)
        to, zt = TM2.mamba2_decode_step(tp, _t(xi), zt, tcfg)
        _close(to, jo, SSD_ATOL, f"step {i} from zero")


def test_prefill_then_decode_equals_forward(layer):
    """The port's own consistency, as the reference's model test holds it:
    prefill of 21 tokens and 11 decode steps against one forward of 32."""
    _, tcfg, _, tp = layer
    cfg = dataclasses.replace(tcfg, ssm=dataclasses.replace(tcfg.ssm, chunk_size=8))
    x = _t(np.random.default_rng(8).normal(size=(2, 32, cfg.d_model)).astype(np.float32))
    full = TM2.mamba2_forward(tp, x, cfg)
    out, st = TM2.mamba2_prefill(tp, x[:, :21], cfg)
    outs = [out]
    for i in range(21, 32):
        o, st = TM2.mamba2_decode_step(tp, x[:, i:i + 1], st, cfg)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    assert float((got - full).abs().max()) < 1e-3 * max(float(full.abs().max()), 1.0)
