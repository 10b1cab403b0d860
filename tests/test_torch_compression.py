"""The port's int8 gradient compression (`repro_torch.distributed.
compression`) against the reference's, on the CPU.

`compress_decompress` is bitwise the reference's: the block max, the
division by the clamped scale and the product are the same float32
operations, and both frameworks round half to even. The cases follow
`tests/test_compression.py`: three magnitudes, lengths on and off the
256-value block, zeros, constants, halves that round to even. The
all-reduce itself runs on gloo ranks in `tests/test_torch_lm_distributed.py`.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as J
from repro_torch.distributed import compression as T


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("shape", [(300,), (256,), (8, 8), (3, 5, 70)])
@pytest.mark.parametrize("scale", [1e-4, 1.0, 1e4])
def test_compress_decompress_is_bitwise_the_reference(shape, scale):
    g = (np.random.default_rng(7).normal(size=shape) * scale).astype(np.float32)
    _same(T.compress_decompress(torch.from_numpy(g)), J.compress_decompress(jnp.asarray(g)))
    q, s, sh = T._quantize_blockwise(torch.from_numpy(g))
    jq, js, jsh = J._quantize_blockwise(jnp.asarray(g))
    assert sh == tuple(jsh) and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    _same(s, js)
    assert float(T.compression_error(torch.from_numpy(g))) == pytest.approx(
        float(J.compression_error(jnp.asarray(g))), rel=1e-6)


def test_zero_constant_and_half_way_values():
    for g in (np.zeros(512, np.float32), np.full(512, 3.25, np.float32),
              # k + 0.5 steps of the block's scale: round half to even
              (np.arange(-127, 129, dtype=np.float32) + 0.5) * np.float32(0.01)):
        _same(T.compress_decompress(torch.from_numpy(g)), J.compress_decompress(jnp.asarray(g)))


def test_state_and_error_feedback_match_the_reference():
    rng = np.random.default_rng(0)
    grads = {"w": np.zeros((4, 8), np.float32), "b": np.zeros(300, np.float32)}
    state = T.init_state({k: torch.from_numpy(v) for k, v in grads.items()})
    assert {k: tuple(v.shape) for k, v in state.residual.items()} == \
        {k: v.shape for k, v in grads.items()}
    residual = {k: np.zeros_like(v) for k, v in grads.items()}
    r_t = dict(state.residual)
    for _ in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in grads.items()}
        for k in g:
            gf = g[k] + residual[k]
            sent = np.asarray(J.compress_decompress(jnp.asarray(gf)))
            residual[k] = gf - sent
            gf_t = torch.from_numpy(g[k]) + r_t[k]
            r_t[k] = gf_t - T.compress_decompress(gf_t)
            _same(r_t[k], residual[k])
