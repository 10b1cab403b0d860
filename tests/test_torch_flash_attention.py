"""The port's flash attention (plain version, the CPU path) against the
reference's `attention_ref` and its Pallas kernel in interpret mode.

Same numpy inputs through both packages, on the CPU. Tolerances are the
reference's own (`tests/test_kernels.py`): 2e-5 in float32, 2e-2 in
bfloat16. The CUDA kernels are held to the plain version on the card in
`tests/test_torch_cuda.py`; here the pure-Python parts of their launcher
are tested: the route choice and the stride check.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash_attention
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention.kernel import (
    _readable,
    flash_attention_cuda,
    kernel_strides,
    route,
)
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
    """A device with no path raises; a meta tensor traces the kernel's path
    (the output's shape and dtype, nothing launched)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import cuda

    for dev in ("xpu", "mps"):
        with FakeTensorMode():
            q = torch.zeros((1, 2, 16, 16), device=dev)
            with pytest.raises(ValueError, match="no path for device"):
                flash_attention(q, q, q)
    before = dict(cuda.launch_counts)
    q = torch.zeros((1, 2, 16, 16), device="meta")
    out = flash_attention(q, q, q)
    assert (out.device.type, out.dtype, tuple(out.shape)) == ("meta", q.dtype, (1, 2, 16, 16))
    assert dict(cuda.launch_counts) == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_model_layout_views(dtype, causal):
    """(B, S, H, D) tensors transposed to (B, H, S, D), as the model's
    attention passes them: bitwise the contiguous call, and the reference
    on the same values within its tolerance."""
    rng = np.random.default_rng(7)
    b, hq, hkv, sq, skv, d = 2, 4, 2, 48, 64, 16
    arrays = [rng.normal(size=(b, s, h, d)).astype(np.float32)
              for s, h in ((sq, hq), (skv, hkv), (skv, hkv))]
    views = [torch.from_numpy(a).to(T_DTYPES[dtype]).transpose(1, 2) for a in arrays]
    assert not views[0].is_contiguous()
    got = flash_attention(*views, causal=causal, block_q=sq, block_k=skv)
    dense = flash_attention(*(t.contiguous() for t in views), causal=causal,
                            block_q=sq, block_k=skv)
    assert got.shape == (b, hq, sq, d) and torch.equal(got, dense)
    want = j_attention_ref(*(jnp.asarray(a.transpose(0, 2, 1, 3)).astype(J_DTYPES[dtype])
                             for a in arrays), causal=causal)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 16, "tc"), (torch.bfloat16, 64, "tc"), (torch.bfloat16, 80, "tc"),
    (torch.bfloat16, 128, "tc"), (torch.bfloat16, 256, "tc"),
    (torch.bfloat16, 8, "fma"), (torch.bfloat16, 24, "fma"), (torch.bfloat16, 264, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma"), (torch.float32, 256, "fma"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert route(dtype, d) == want


def test_route_tensor_cores_exactly_for_bf16_multiples_of_16():
    for d in range(8, 257, 8):
        assert route(torch.bfloat16, d) == ("tc" if d % 16 == 0 else "fma"), d
        assert route(torch.float32, d) == "fma", d


def test_kernel_strides_reads_dense_layouts_in_place():
    t = torch.zeros((2, 3, 5, 16), dtype=torch.bfloat16)
    assert kernel_strides(t) == (240, 80, 16)
    bshd = torch.zeros((2, 5, 3, 16), dtype=torch.bfloat16).transpose(1, 2)
    assert kernel_strides(bshd) == (240, 16, 48)
    # a dim of size 1 is never stepped; it gets its inner neighbour's extent
    one = torch.zeros((1, 5, 1, 16), dtype=torch.float32).transpose(1, 2)
    assert kernel_strides(one) == (80, 80, 16)
    heads = torch.zeros((1, 8, 2, 4, 32), dtype=torch.bfloat16)[:, :, 1]  # every other head
    assert kernel_strides(heads) == (2048, 256, 32)


UNREADABLE = [
    ("innermost stride not 1", lambda: torch.zeros((1, 2, 16, 8)).transpose(2, 3)),
    ("row not a multiple of 16 bytes", lambda: torch.zeros((1, 2, 4, 12), dtype=torch.bfloat16)),
    ("base not 16-byte aligned", lambda: torch.zeros((1, 2, 4, 32), dtype=torch.bfloat16)[..., 1:17]),
    ("contiguous, base not 16-byte aligned",
     lambda: torch.zeros(1 + 2 * 4 * 16, dtype=torch.bfloat16)[1:].view(1, 2, 4, 16)),
]


@pytest.mark.parametrize("what,make", UNREADABLE + [("not 4-D", lambda: torch.zeros((2, 4, 16)))])
def test_kernel_strides_refuses_what_the_kernels_cannot_read(what, make):
    assert kernel_strides(make()) is None, what


@pytest.mark.parametrize("what,make", UNREADABLE)
def test_launcher_copies_what_the_kernels_cannot_read(what, make):
    t = make()
    t.copy_(torch.arange(t.numel(), dtype=torch.float32).reshape(t.shape))
    copy, strides = _readable(t)
    assert strides == kernel_strides(copy) and copy.is_contiguous(), what
    assert torch.equal(copy, t), what


def test_flash_attention_cuda_refuses_cpu_tensors():
    q = torch.zeros((1, 2, 16, 16))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash_attention_cuda(q, q, q)
