"""The port's flash attention (plain version, the CPU path) against the
reference's `attention_ref` and its Pallas kernel in interpret mode.

Same numpy inputs through both packages, on the CPU. Tolerances are the
reference's own (`tests/test_kernels.py`): 2e-5 in float32, 2e-2 in
bfloat16. The CUDA kernel is held to the plain version on the card in
`tests/test_torch_cuda.py`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, Hq, Hkv, Sq, Skv, D, dtype):
    """numpy float32 inputs, and the same rounded to `dtype` in each package."""
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]
    jx = [jnp.asarray(a).astype(J_DTYPES[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(T_DTYPES[dtype]) for a in arrays]
    return jx, tx


def _close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,BQ,BK", [
    (1, 2, 2, 128, 128, 32, 64, 64),  # MHA square
    (2, 4, 2, 128, 128, 16, 128, 32),  # GQA 2:1
    (1, 8, 2, 64, 256, 32, 64, 128),  # decode-ish: Sq < Skv, GQA 4:1
])
def test_flash_attention_plain_vs_reference(dtype, B, Hq, Hkv, Sq, Skv, D, BQ, BK):
    """The grid of the reference's kernel test, through the port's wrapper."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(B + Hq + Sq, B, Hq, Hkv, Sq, Skv, D, dtype)
    want = j_attention_ref(jq, jk, jv, causal=True)
    got = flash_attention(tq, tk, tv, causal=True, block_q=BQ, block_k=BK)
    assert got.dtype == T_DTYPES[dtype] and got.shape == (B, Hq, Sq, D)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_non_causal(dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(11, 1, 4, 2, 64, 96, 16, dtype)
    want = j_attention_ref(jq, jk, jv, causal=False)
    _close(attention_ref(tq, tk, tv, causal=False), want, TOL[dtype])
    _close(flash_attention(tq, tk, tv, causal=False, block_q=32, block_k=32),
           want, TOL[dtype])


def test_flash_attention_vs_pallas_interpret():
    """One shape against the reference's Pallas kernel itself (interpreted)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(5, 1, 4, 2, 64, 128, 16, "float32")
    want = j_flash_attention(jq, jk, jv, causal=True, block_q=32, block_k=64,
                             interpret=True)
    _close(flash_attention(tq, tk, tv, causal=True, block_q=32, block_k=64),
           want, TOL["float32"])


def test_flash_attention_refuses_what_the_reference_asserts():
    q = torch.zeros((1, 4, 200, 16))
    kv = torch.zeros((1, 2, 200, 16))
    with pytest.raises(ValueError, match="multiples of blocks"):
        flash_attention(q, kv, kv)  # 200 is no multiple of 128
    assert flash_attention(q, kv, kv, block_q=100, block_k=40).shape == q.shape
    with pytest.raises(ValueError, match="query heads"):
        flash_attention(torch.zeros((1, 3, 16, 16)), kv[:, :, :16], kv[:, :, :16])


def test_flash_attention_other_devices_raise():
    q = torch.zeros((1, 2, 16, 16), device="meta")
    with pytest.raises(ValueError, match="no path for device"):
        flash_attention(q, q, q)
