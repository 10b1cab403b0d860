"""Shared layers: norms, embeddings, MLPs. Plain functions over param dicts.

Counterpart of `repro.models.layers`. Params are nested dicts of tensors;
dense weights stay `(d_in, d_out)` as in the reference. Compute dtype
follows the inputs (bf16 in production); normalization statistics,
activations and logits run in float32.

The `init_*` functions draw the reference's distributions from an
explicit `torch.Generator`; they do not reproduce the reference's numbers
(carry those across with `repro_torch.interop.lm_params_from_numpy`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.to(torch.float32)).to(x.dtype)


def init_rms_norm(d: int, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def dense(x: Tensor, w: Tensor, b: Tensor | None = None) -> Tensor:
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def normal(generator: torch.Generator, shape: tuple[int, ...], scale: float,
           dtype, device) -> Tensor:
    """float32 N(0, 1) * scale from `generator`, cast to `dtype`."""
    x = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
    return x.mul_(scale).to(dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int, *,
               bias: bool = False, scale: float | None = None,
               dtype=torch.bfloat16, device=None) -> dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": normal(generator, (d_in, d_out), scale, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def mlp(params: dict, x: Tensor, variant: str = "swiglu") -> Tensor:
    """Position-wise feed-forward. swiglu: 3 matrices; gelu: 2 matrices."""
    if variant == "swiglu":
        gate = dense(x, params["w_gate"])
        up = dense(x, params["w_up"])
        act = F.silu(gate.to(torch.float32)).to(x.dtype) * up
        return dense(act, params["w_down"])
    if variant == "gelu":
        up = dense(x, params["w_up"], params.get("b_up"))
        # jax.nn.gelu defaults to the tanh approximation
        act = F.gelu(up.to(torch.float32), approximate="tanh").to(x.dtype)
        return dense(act, params["w_down"], params.get("b_down"))
    raise ValueError(variant)


def init_mlp(generator: torch.Generator, d_model: int, d_ff: int,
             variant: str = "swiglu", dtype=torch.bfloat16, device=None) -> dict:
    def w(d_in, d_out):
        return init_dense(generator, d_in, d_out, dtype=dtype, device=device)["w"]

    if variant == "swiglu":
        return {"w_gate": w(d_model, d_ff), "w_up": w(d_model, d_ff),
                "w_down": w(d_ff, d_model)}
    return {"w_up": w(d_model, d_ff), "w_down": w(d_ff, d_model)}


def embed(tokens: Tensor, table: Tensor) -> Tensor:
    return table[tokens]


def init_embed(generator: torch.Generator, vocab: int, d_model: int,
               dtype=torch.bfloat16, device=None) -> dict:
    return {"table": normal(generator, (vocab, d_model), 0.02, dtype, device)}


def unembed(x: Tensor, table_or_head: Tensor) -> Tensor:
    """Logits in float32 (loss-critical). Eager PyTorch materialises a
    float32 copy of the (vocab, d) table on every call, as the reference's
    einsum specifies; the cost is recorded in PERF.md."""
    return torch.matmul(x.to(torch.float32), table_or_head.to(torch.float32).T)
