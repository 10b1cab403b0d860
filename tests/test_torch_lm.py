"""Parity of the port's LM serving path with the JAX reference, on the CPU.

The reference's random weights are carried across with
`interop.lm_params_from_numpy`; inputs are numpy arrays fed to both.
Tolerances:
  * float32: logits within 5e-5 absolute (they are O(1); the packages sum
    matrix products in other orders and their sin/cos/rsqrt differ in the
    last bit, about 3e-6 measured), caches within 1e-5;
  * bfloat16: logits within 0.1 absolute and 2% relative L2. Both round
    every activation to bf16 (2^-8 relative), at other points: XLA fuses
    and orders the matmul sums differently, and the port's prefill
    attention keeps scores and probabilities in float32 where the
    reference's `attention_full` rounds them (ROADMAP §C);
  * int8 KV codes and everything integer: bitwise.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.archs import REGISTRY as J_REGISTRY
from repro.models import attention as JA
from repro.models import kv_cache as JKV
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import Request as JRequest
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.archs import REGISTRY
from repro_torch.launch import serve
from repro_torch.models import attention as TA
from repro_torch.models import kv_cache as TKV
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving.engine import Engine, EngineConfig, Request

F32_LOGIT_ATOL = 5e-5
F32_CACHE_ATOL = 1e-5
BF16_LOGIT_ATOL, BF16_LOGIT_REL_L2 = 0.1, 2e-2
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Small tensors: few intra-op threads leave the cores to the test
    workers running beside this module."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _configs(n_layers: int = 2):
    """The reduced qwen3-8b in both packages (qk-norm, GQA), `n_layers` deep."""
    return (dataclasses.replace(j_get_config("qwen3-8b").reduced(), n_layers=n_layers),
            dataclasses.replace(get_config("qwen3-8b").reduced(), n_layers=n_layers))


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lm(request):
    dtype = request.param
    jcfg, tcfg = _configs()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=J_DTYPES[dtype])
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return dtype, jcfg, tcfg, jp, tp


def _logits_close(got, want, dtype: str, what: str) -> None:
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    assert np.isfinite(g).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=F32_LOGIT_ATOL, rtol=0, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, atol=BF16_LOGIT_ATOL, rtol=0, err_msg=what)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= BF16_LOGIT_REL_L2, (what, rel)


def _caches_close(tstate, jstate, dtype: str) -> None:
    """Per-layer port caches against the reference's super-block stack."""
    jc = jstate[0]
    for i, tc in enumerate(tstate):
        for name in ("k", "v"):
            got, want = _np(getattr(tc, name)), _np(getattr(jc, name)[i])
            if dtype == "float32":
                np.testing.assert_allclose(got, want, atol=F32_CACHE_ATOL, rtol=0)
            else:
                np.testing.assert_allclose(got, want, atol=0.1, rtol=0.05)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_matches_reference():
    assert sorted(REGISTRY) == sorted(J_REGISTRY)
    for name, jcfg in J_REGISTRY.items():
        tcfg = REGISTRY[name]
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg), name
        if jcfg.family == "emvs":
            continue
        assert tcfg.active_params() == jcfg.active_params(), name
        assert tcfg.total_params() == jcfg.total_params(), name
        assert tcfg.pattern() == jcfg.pattern() and tcfg.head_dim == jcfg.head_dim
        assert dataclasses.asdict(tcfg.reduced()) == dataclasses.asdict(jcfg.reduced())


# ---------------------------------------------------------------------------
# layers, rope, kv cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layers_match_reference(dtype):
    rng = np.random.default_rng(0)
    jd, td = J_DTYPES[dtype], T_DTYPES[dtype]
    tol = 1e-5 if dtype == "float32" else 3e-2
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jd), _t(x, td)
    np.testing.assert_allclose(_np(TL.rms_norm(tx, _t(scale), 1e-6)),
                               _np(JL.rms_norm(jx, jnp.asarray(scale), 1e-6)), atol=tol)
    w = {k: (rng.normal(size=s) * 0.1).astype(np.float32) for k, s in
         (("w_gate", (64, 96)), ("w_up", (64, 96)), ("w_down", (96, 64)),
          ("b_up", (96,)), ("b_down", (64,)))}
    jw = {k: jnp.asarray(v).astype(jd) for k, v in w.items()}
    tw = {k: _t(v, td) for k, v in w.items()}
    np.testing.assert_allclose(_np(TL.dense(tx, tw["w_up"], tw["b_up"])),
                               _np(JL.dense(jx, jw["w_up"], jw["b_up"])), atol=tol)
    for variant in ("swiglu", "gelu"):
        np.testing.assert_allclose(_np(TL.mlp(tw, tx, variant)),
                                   _np(JL.mlp(jw, jx, variant)), atol=tol, err_msg=variant)
    table = rng.normal(size=(50, 64)).astype(np.float32)
    toks = rng.integers(0, 50, (2, 5))
    jt, tt = jnp.asarray(table).astype(jd), _t(table, td)
    np.testing.assert_array_equal(_np(TL.embed(_t(toks), tt)),
                                  _np(JL.embed(jnp.asarray(toks), jt)))
    got = TL.unembed(tx, tt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(JL.unembed(jx, jt)), atol=1e-4, rtol=1e-5)


def test_rope_matches_reference():
    """sin/cos of the packages differ in the last bit (ROADMAP C1)."""
    rng = np.random.default_rng(1)
    pos = np.array([[0, 1, 2, 7, 63, 511, 1023]], np.int32)
    for theta in (1e4, 1e6):
        js, jc = JA.rope_sincos(jnp.asarray(pos), 16, theta)
        ts, tc = TA.rope_sincos(_t(pos), 16, theta)
        np.testing.assert_allclose(_np(ts), _np(js), atol=2e-6)
        np.testing.assert_allclose(_np(tc), _np(jc), atol=2e-6)
    x = rng.normal(size=(1, 7, 4, 16)).astype(np.float32)
    js, jc = JA.rope_sincos(jnp.asarray(pos), 16, 1e6)
    ts, tc = TA.rope_sincos(_t(pos), 16, 1e6)
    np.testing.assert_allclose(_np(TA.apply_rope(_t(x), ts, tc)),
                               _np(JA.apply_rope(jnp.asarray(x), js, jc)), atol=1e-5)


def test_kv_cache_int8_codes_bitwise():
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 9, 2, 16)) * rng.uniform(0.01, 10, (3, 9, 2, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0  # an all-zero row: scale 0, codes 0
    x[1, 1, 0, :4] = [0.5, -0.5, 1.5, -2.5]  # halves after scaling are rare; keep ties
    jq, js = JKV._quantize(jnp.asarray(x))
    tq, ts = TKV._quantize(_t(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _np(TKV.dequantize(tq, ts)), _np(JKV.dequantize(jq, js)))


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_cache_writes_match_reference(quantized):
    rng = np.random.default_rng(3)
    b, smax, hkv, d = 3, 12, 2, 16
    new = rng.normal(size=(2, b, 5, hkv, d)).astype(np.float32)
    jc = JKV.init_cache(b, smax, hkv, d, quantized=quantized)
    tc = TKV.init_cache(b, smax, hkv, d, quantized=quantized)
    jc = JKV.write_cache(jc, jnp.asarray(new[0]), jnp.asarray(new[1]), jnp.int32(2))
    tc = TKV.write_cache(tc, _t(new[0]), _t(new[1]), 2)
    # past the end: dynamic_update_slice clamps the offset to smax - 5
    jc = JKV.write_cache(jc, jnp.asarray(new[1]), jnp.asarray(new[0]), jnp.int32(10))
    tc = TKV.write_cache(tc, _t(new[1]), _t(new[0]), 10)
    one = rng.normal(size=(2, b, 1, hkv, d)).astype(np.float32)
    pos = np.array([0, 7, smax], np.int32)  # the last slot writes nothing
    jc = JKV.write_cache_batched(jc, jnp.asarray(one[0]), jnp.asarray(one[1]),
                                 jnp.asarray(pos))
    tc = TKV.write_cache_batched(tc, _t(one[0]), _t(one[1]), _t(pos).long())
    for a, bb in zip(tc, jc):
        assert (a is None) == (bb is None)
        if a is not None:
            assert a.dtype == getattr(torch, str(bb.dtype))
            np.testing.assert_array_equal(_np(a), _np(bb))
    for a, bb in zip(TKV.read_cache(tc), JKV.read_cache(jc)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(a), _np(bb))
    assert TKV.cache_bytes(tc) == JKV.cache_bytes(jc)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def test_param_tree_carries_across(lm):
    dtype, jcfg, tcfg, jp, tp = lm
    assert TM.param_count(tp) == JM.param_count(jp)
    assert len(tp["blocks"]) == tcfg.n_layers
    assert tp["blocks"][0]["attn"]["wq"]["w"].dtype == T_DTYPES[dtype]
    assert tp["final_norm"]["scale"].dtype == torch.float32
    np.testing.assert_array_equal(_np(tp["blocks"][1]["ffn"]["dense"]["w_up"]),
                                  _np(jp["blocks"][0]["ffn"]["dense"]["w_up"][1]))


def test_prefill_and_decode_match_reference(lm):
    """prefill (with logit_index), decode_step and decode_step_batched:
    logits and caches. The port's state is updated in place, so the
    reference's states are threaded alongside."""
    dtype, jcfg, tcfg, jp, tp = lm
    rng = np.random.default_rng(4)
    toks = rng.integers(1, tcfg.vocab_size, (2, 16)).astype(np.int32)
    jl, js = JM.prefill(jp, jnp.asarray(toks), jcfg, 32, logit_index=jnp.int32(11))
    tl, ts = TM.prefill(tp, _t(toks).long(), tcfg, 32, logit_index=11)
    _logits_close(tl, jl, dtype, "prefill")
    _caches_close(ts, js, dtype)

    nxt = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)[:, None]
    jl, js = JM.decode_step(jp, js, jnp.asarray(nxt), jnp.int32(16), jcfg)
    tl, ts = TM.decode_step(tp, ts, _t(nxt).long(), 16, tcfg)
    _logits_close(tl, jl, dtype, "decode_step")

    lens = np.array([17, 9], np.int32)
    jl, js = JM.decode_step_batched(jp, js, jnp.asarray(nxt), jnp.asarray(lens), jcfg)
    tl, ts = TM.decode_step_batched(tp, ts, _t(nxt).long(), _t(lens).long(), tcfg)
    _logits_close(tl, jl, dtype, "decode_step_batched")
    _caches_close(ts, js, dtype)


def test_forward_matches_reference():
    jcfg, tcfg = _configs()
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(5).integers(1, tcfg.vocab_size, (2, 12)).astype(np.int32)
    jl, _ = JM.forward(jp, jnp.asarray(toks), jcfg)
    tl, aux = TM.forward(tp, _t(toks).long(), tcfg)
    _logits_close(tl, jl, "float32", "forward")
    assert float(aux) == 0.0


def test_bf16_prefill_attention_keeps_float32_scores():
    """ROADMAP §C (known divergences): in bf16 the port's prefill
    attention is the reference's kernel semantics (float32 scores and
    probabilities), closer to `attention_ref` than to `attention_full`,
    which rounds both to bf16."""
    rng = np.random.default_rng(6)
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in
               ((2, 32, 4, 16), (2, 32, 2, 16), (2, 32, 2, 16)))
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    got = _np(TA.attention_core(*(_t(a, torch.bfloat16) for a in (q, k, v))))
    from repro.kernels.flash_attention.ref import attention_ref

    kernel = _np(attention_ref(*(a.swapaxes(1, 2) for a in (jq, jk, jv)))).swapaxes(1, 2)
    full = _np(JA.attention_full(jq, jk, jv))
    err_kernel, err_full = np.abs(got - kernel).max(), np.abs(got - full).max()
    assert err_kernel <= 2e-2 and err_full <= 5e-2
    assert err_kernel < err_full, (err_kernel, err_full)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serving_lm():
    """test_serving.py's model (reduced qwen3-8b, PRNGKey(0)) in float32."""
    jcfg = j_get_config("qwen3-8b").reduced()
    tcfg = get_config("qwen3-8b").reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_engine_matches_reference_engine(serving_lm, kv_quantized):
    """test_serving.py's scenario: 5 prompts, 2 slots, bucket 16, 6 tokens;
    float32 weights, bf16 or int8 KV. Generated tokens are equal."""
    jcfg, tcfg, jp, tp = serving_lm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, tcfg.vocab_size, size=p).astype(np.int32)
               for p in (5, 9, 14, 7, 11)]
    kw = dict(slots=2, max_len=64, prefill_buckets=(16,), kv_quantized=kv_quantized)
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jeng = JEngine(jcfg, jp, JEngineConfig(**kw), eos_id=-1)
    teng = Engine(tcfg, tp, EngineConfig(**kw), eos_id=-1)
    assert teng.state[0].k.dtype == (torch.int8 if kv_quantized else torch.bfloat16)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_done(1000)
    teng.run_until_done(1000)
    assert teng.step_count == jeng.step_count
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == 6
        assert tr.generated == jr.generated, (tr.rid, tr.generated, jr.generated)


def test_serve_runs_on_cpu_reduced(capsys):
    reqs = serve.main(["--arch", "qwen3-8b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert [len(r.generated) for r in reqs] == [4, 4, 4] and all(r.done for r in reqs)
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# devices and what is not ported
# ---------------------------------------------------------------------------


def test_entry_points_need_cpu_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    _, tcfg = _configs(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(tcfg, generator=torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_decode_state(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.lm_params_from_numpy({"blocks": ({},)}, tcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3-8b", "--reduced"])
    params = TM.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    assert params["lm_head"].device.type == "cpu"
    assert params["embed"]["table"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b", "jamba-1.5-large-398b"])
def test_moe_and_ssm_families_serve_on_cpu(arch, capsys):
    """The MoE, SSM and hybrid families initialize and serve through the
    launcher on the CPU (they raised NotImplementedError before their port)."""
    cfg = get_config(arch).reduced()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    kinds = [("attn" in b, "mamba" in b, "ffn" in b) for b in params["blocks"]]
    assert len(kinds) == cfg.n_layers
    assert [k[1] for k in kinds] == [kind == "mamba" for kind in cfg.pattern()]
    assert all(k[2] for k in kinds) == (cfg.family != "ssm")
    reqs = serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4"])
    assert [len(r.generated) for r in reqs] == [4, 4, 4] and all(r.done for r in reqs)
    assert "served 3 requests / 12 tokens" in capsys.readouterr().out


def test_model_ctx_fields_and_constrain_without_mesh():
    """Every reference `ModelCtx` field exists and is accepted (the mesh
    ones act in `tests/test_torch_lm_distributed.py`); without a mesh
    `constrain` and `unshard` give their input back."""
    assert [f.name for f in dataclasses.fields(TM.ModelCtx)] == \
        [f.name for f in dataclasses.fields(JM.ModelCtx)]
    ctx = TM.ModelCtx(ep_shard=object(), seq_shard=object(), batch_axes=("data",),
                      seq_axis="model", kv_quantized=True, remat=True)
    assert ctx.kv_quantized and ctx.remat and ctx.batch_axes == ("data",)
    x = torch.ones(2, 3, 4)
    assert TM.ModelCtx().constrain(x) is x and ctx.constrain(x) is x
    tree = {"a": x}
    assert ctx.unshard(tree) is tree


@pytest.mark.parametrize("arch", ["musicgen-large", "llava-next-mistral-7b",
                                  "starcoder2-15b"])
def test_other_attention_only_archs_match_reference(arch):
    """gelu MLPs and QKV bias (musicgen, starcoder2), and the frontend
    embeddings the reference stubs (audio frames added, vision patches in
    front), through `forward` and `prefill` in float32."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(2), jcfg, dtype=jnp.float32)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(1, tcfg.vocab_size, (1, 12)).astype(np.int32)
    fe = None
    if tcfg.frontend is not None:
        n = 12 if tcfg.frontend == "audio_frames" else tcfg.n_frontend_tokens
        fe = rng.normal(size=(1, n, tcfg.d_model)).astype(np.float32)
    jfe, tfe = (None, None) if fe is None else (jnp.asarray(fe), _t(fe))
    jl, _ = JM.forward(jp, jnp.asarray(toks), jcfg, frontend_embed=jfe)
    tl, _ = TM.forward(tp, _t(toks).long(), tcfg, frontend_embed=tfe)
    _logits_close(tl, jl, "float32", f"{arch} forward")
    jl, _ = JM.prefill(jp, jnp.asarray(toks), jcfg, 16, frontend_embed=jfe)
    tl, _ = TM.prefill(tp, _t(toks).long(), tcfg, 16, frontend_embed=tfe)
    _logits_close(tl, jl, "float32", f"{arch} prefill")


# ---------------------------------------------------------------------------
# MoE, SSM and hybrid families
# ---------------------------------------------------------------------------

# SSM states in float32, within SSM_STATE_RTOL of the largest magnitude of
# the layer's field. The hybrid's 8-layer stack carries each layer's float32
# differences into the next, so its deepest Mamba-2 states differ by a
# share of their magnitude that depends on the host's rounding: up to 1.0e-5
# measured on an AVX-512 AMD host (layer 5's SSD state, 2.57e-5 on 2.58;
# layer 7's is 1.13e-4 on 21.5). The reference alone moves its layer-7 SSD
# state by 2.05e-5 when XLA:CPU is kept from fused multiply-adds
# (`XLA_FLAGS=--xla_cpu_max_isa=AVX`); with both packages kept from them
# the case passes (tests/test_torch_pipeline.py::
# test_host_rounding_cases_hold_without_fma). The one-layer SSM measures 3.8e-7.
SSM_STATE_RTOL = {"ssm": 3e-6, "hybrid": 3e-5}
FAMILY_ARCHS = ["deepseek-moe-16b", "kimi-k2-1t-a32b", "mamba2-2.7b",
                "jamba-1.5-large-398b"]


@pytest.fixture(scope="module", params=[(a, d) for a in FAMILY_ARCHS
                                        for d in ("float32", "bfloat16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def family_lm(request):
    arch, dtype = request.param
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(3), jcfg, dtype=J_DTYPES[dtype])
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return dtype, jcfg, tcfg, jp, tp


def _family_states_close(tstate, jstate, cfg, dtype: str) -> None:
    """Per-layer port states against the reference's per-position stacks:
    KV caches as `_caches_close`, SSM states within SSM_STATE_RTOL of their
    magnitude in float32 (within 0.1 and 5% with bf16 activations, as the
    caches)."""
    pat = cfg.pattern()
    assert len(tstate) == cfg.n_layers
    for i, ts in enumerate(tstate):
        js = jax.tree.map(lambda a: a[i // len(pat)], jstate[i % len(pat)])
        assert type(ts).__name__ == type(js).__name__, (i, type(ts), type(js))
        for name in ts._fields:
            got, want = getattr(ts, name), getattr(js, name)
            if got is None:
                assert want is None
                continue
            assert str(got.dtype) == f"torch.{want.dtype}", (i, name)
            if dtype == "float32":
                atol = (F32_CACHE_ATOL if pat[i % len(pat)] == "attn"
                        else SSM_STATE_RTOL[cfg.family] * float(np.abs(_np(want)).max()))
                np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0,
                                           err_msg=f"layer {i} {name}")
            else:
                np.testing.assert_allclose(_np(got), _np(want), atol=0.1, rtol=0.05,
                                           err_msg=f"layer {i} {name}")


def test_families_match_reference(family_lm):
    """forward (logits and MoE aux), prefill, decode_step and
    decode_step_batched of the reduced deepseek-moe-16b, kimi-k2, mamba2
    and jamba (8 layers: Mamba-2 at 0-3 and 5-7, attention at 4, MoE on
    even positions): logits, KV caches and SSM states.

    In bf16 the reference runs op by op (`jax.disable_jit`): XLA's fused
    scan body keeps some bf16 intermediates in float32, and through
    jamba's 8 layers its compiled forward lands 2.98 from its own op-by-op
    logits, where the port, which rounds after every operation, lands
    within 0.031 of the op-by-op ones."""
    dtype, jcfg, tcfg, jp, tp = family_lm
    if dtype == "bfloat16":
        with jax.disable_jit():
            _family_steps(dtype, jcfg, tcfg, jp, tp)
    else:
        _family_steps(dtype, jcfg, tcfg, jp, tp)


def _family_steps(dtype, jcfg, tcfg, jp, tp) -> None:
    rng = np.random.default_rng(9)
    toks = rng.integers(1, tcfg.vocab_size, (2, 14)).astype(np.int32)
    jl, ja = JM.forward(jp, jnp.asarray(toks), jcfg)
    tl, ta = TM.forward(tp, _t(toks).long(), tcfg)
    _logits_close(tl, jl, dtype, "forward")
    assert ta.dtype == torch.float32 and (float(ta) > 0) == (tcfg.moe is not None)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6 if dtype == "float32"
                               else 1e-3, rtol=0)

    jl, js = JM.prefill(jp, jnp.asarray(toks), jcfg, 24)
    tl, ts = TM.prefill(tp, _t(toks).long(), tcfg, 24)
    _logits_close(tl, jl, dtype, "prefill")
    _family_states_close(ts, js, tcfg, dtype)

    nxt = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)[:, None]
    for cur in (14, 15):
        jl, js = JM.decode_step(jp, js, jnp.asarray(nxt), jnp.int32(cur), jcfg)
        tl, ts = TM.decode_step(tp, ts, _t(nxt).long(), cur, tcfg)
        _logits_close(tl, jl, dtype, f"decode_step at {cur}")
        nxt = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)[:, None]

    lens = np.array([16, 9], np.int32)
    jl, js = JM.decode_step_batched(jp, js, jnp.asarray(nxt), jnp.asarray(lens), jcfg)
    tl, ts = TM.decode_step_batched(tp, ts, _t(nxt).long(), _t(lens).long(), tcfg)
    _logits_close(tl, jl, dtype, "decode_step_batched")
    _family_states_close(ts, js, tcfg, dtype)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b"])
def test_family_engine_matches_reference_engine(arch):
    """test_serving.py's exact-length scenario (an 11-token prompt, bucket
    16) with two more requests on 2 slots, float32 weights: the greedy
    tokens are equal, SSM and hybrid archs prefill each prompt at its
    exact length and their slots' states are spliced on admission."""
    jcfg, tcfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, size=p).astype(np.int32)
               for p in (11, 5, 11)]
    kw = dict(slots=2, max_len=64, prefill_buckets=(16,))
    jreqs = [JRequest(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    treqs = [Request(rid=i, prompt=p, max_new_tokens=5) for i, p in enumerate(prompts)]
    jeng = JEngine(jcfg, jp, JEngineConfig(**kw), eos_id=-1)
    teng = Engine(tcfg, tp, EngineConfig(**kw), eos_id=-1)
    assert teng.bucket_for(11) == (11 if tcfg.ssm is not None else 16)
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    jeng.run_until_done(100)
    teng.run_until_done(100)
    assert teng.step_count == jeng.step_count
    for jr, tr in zip(jreqs, treqs):
        assert tr.done and len(tr.generated) == 5
        assert tr.generated == jr.generated, (tr.rid, tr.generated, jr.generated)


def test_splice_slot_copies_ssm_state_rows():
    """Admission copies every SSMState field and KV cache into the slot's
    rows and leaves the other slots alone."""
    cfg = get_config("jamba-1.5-large-398b").reduced()
    params = TM.init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    state = TM.init_decode_state(cfg, 3, 16, device="cpu")
    _, pstate = TM.prefill(params, torch.arange(1, 8)[None], cfg, 16)
    TM.splice_slot(state, pstate, 1)
    for layer, player in zip(state, pstate):
        for dst, src in zip(layer, player):
            if dst is None:
                continue
            assert dst.dtype == (torch.float32 if isinstance(layer, TM.m2.SSMState)
                                 else torch.bfloat16)
            torch.testing.assert_close(dst[1:2], src.to(dst.dtype), atol=0, rtol=0)
            assert not dst[0].any() and not dst[2].any()


def test_param_dtypes_follow_reference_at_bf16():
    """`lm_params_from_numpy(dtype=bfloat16)` of a float32 reduced jamba
    tree keeps the leaves the reference keeps in float32 at any model dtype
    (norm scales, the router, Mamba-2's A_log, dt_bias, D and norm) and
    casts the rest: each leaf's dtype is the reference's bf16 tree's."""
    jcfg, tcfg = j_get_config("jamba-1.5-large-398b").reduced(), get_config(
        "jamba-1.5-large-398b").reduced()
    j32 = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    j16 = JM.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.bfloat16)
    tp = interop.lm_params_from_numpy(jax.tree.map(np.asarray, j32), tcfg, device="cpu",
                                      dtype=torch.bfloat16)
    pat = tcfg.pattern()
    n_f32 = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(j16)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        if keys[0] == "blocks":
            node = tp["blocks"][keys[1]]  # one super-block: layer i is position i
            keys = keys[2:]
        else:
            node = tp
        for k in keys:
            node = node[k]
        assert str(node.dtype) == f"torch.{leaf.dtype}", (keys, node.dtype, leaf.dtype)
        n_f32 += leaf.dtype == jnp.float32
    assert len(pat) == tcfg.n_layers and n_f32 > 2 * len(pat)
    assert tp["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    assert tp["blocks"][0]["ffn"]["moe"]["router"]["w"].dtype == torch.float32
    assert tp["blocks"][0]["mamba"]["conv_x_b"].dtype == torch.bfloat16
