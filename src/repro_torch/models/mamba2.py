"""Mamba-2 SSD (state-space duality) layer, chunked dual form.

Counterpart of `repro.models.mamba2`. For one head the recurrence is

    h_t = a_t * h_{t-1} + b_t x_t^T        h in R^{N x P}
    y_t = C_t h_t + D x_t

with a_t = exp(-dt_t * A), b_t = dt_t * B_t. Prefill runs the chunked
dual form: per chunk of Q steps an intra-chunk quadratic term
((C B^T) o L)(dt x) and a chunk state, then a linear scan over the S/Q
chunk states (a Python loop here, `lax.scan` in the reference). Decode
is the single-step recurrence on a carried (H, N, P) state.

Differences from JAX that matter for parity: `jax.nn.softplus` is
`logaddexp(x, 0)` everywhere, where `F.softplus` switches to `x` above a
threshold, so `_softplus` uses `torch.logaddexp`; the causal decay mask
is applied with -inf before the exp.

The decode state's conv windows and SSD state are float32 whatever the
model dtype, as are A_log, dt_bias, D and the norm scale.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import dense, init_dense, normal, rms_norm

Tensor = torch.Tensor


class SSMState(NamedTuple):
    """Decode-time carried state for one Mamba-2 layer."""

    conv_x: Tensor  # (B, K-1, d_inner) rolling conv window of x
    conv_B: Tensor  # (B, K-1, N)
    conv_C: Tensor  # (B, K-1, N)
    ssd: Tensor  # (B, H, N, P) SSD recurrent state, float32


def _dims(cfg: ArchConfig) -> tuple[int, int, int, int]:
    sc = cfg.ssm
    return sc.d_inner(cfg.d_model), sc.num_heads(cfg.d_model), sc.d_state, sc.head_dim


def init_mamba2(generator: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16,
                device=None) -> dict:
    sc = cfg.ssm
    d = cfg.d_model
    d_in, nh, n, _ = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)

    def conv_w(c):
        return normal(generator, (sc.conv_kernel, c), (1.0 / sc.conv_kernel) ** 0.5,
                      dtype, device)

    return {
        "w_z": init_dense(generator, d, d_in, **kw),
        "w_x": init_dense(generator, d, d_in, **kw),
        "w_B": init_dense(generator, d, n, **kw),
        "w_C": init_dense(generator, d, n, **kw),
        "w_dt": init_dense(generator, d, nh, **kw),
        "conv_x_w": conv_w(d_in), "conv_x_b": torch.zeros((d_in,), **kw),
        "conv_B_w": conv_w(n), "conv_B_b": torch.zeros((n,), **kw),
        "conv_C_w": conv_w(n), "conv_C_b": torch.zeros((n,), **kw),
        # per-head A (negative; stored as log), dt bias, D skip
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "norm": torch.ones((d_in,), **f32),
        "out_proj": init_dense(generator, d_in, d,
                               scale=d_in ** -0.5 / (2 * max(cfg.n_layers, 1)) ** 0.5,
                               **kw),
    }


def _softplus(x: Tensor) -> Tensor:
    """`jax.nn.softplus`: logaddexp(x, 0) at every x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _causal_conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """Depthwise causal conv, kernel K: (B, S, C) -> (B, S, C)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):  # K is 4: unrolled adds
        out = out + pad[:, i:i + s, :].to(torch.float32) * w[i].to(torch.float32)
    return F.silu(out + b.to(torch.float32)).to(x.dtype)


def ssd_chunked(x: Tensor, dt: Tensor, A: Tensor, B: Tensor, C: Tensor, D: Tensor,
                chunk: int, h0: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Chunked SSD core.

    x: (Bt, S, H, P)   dt: (Bt, S, H) pre-softplus   A: (H,) decay rates
    B, C: (Bt, S, N)   D: (H,)
    Returns (y (Bt, S, H, P) in x's dtype, h_final (Bt, H, N, P) float32).
    """
    bt, s, h, p = x.shape
    n = B.shape[-1]
    s_orig = s
    f32 = torch.float32
    if s % chunk:  # pad to a chunk multiple; padded steps are inert:
        pad = chunk - s % chunk  # dt=-1e4 -> softplus 0 -> decay 1, no input
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e4)
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
        s = s + pad
    nc = s // chunk

    dt = _softplus(dt.to(f32))  # (Bt, S, H) positive
    la = -dt * A[None, None, :]  # log a_t, negative

    xc = x.reshape(bt, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(bt, nc, chunk, h)
    Bc = B.reshape(bt, nc, chunk, n).to(f32)
    Cc = C.reshape(bt, nc, chunk, n).to(f32)

    # cumulative log decay within each chunk (inclusive)
    cum = torch.cumsum(la.reshape(bt, nc, chunk, h), dim=2)  # (Bt, nc, Q, H)
    total = cum[:, :, -1:, :]  # (Bt, nc, 1, H) full-chunk decay

    # --- intra-chunk: ((C B^T) o L) (dt * x) ----------------------------
    # L[t, u] = exp(cum[t] - cum[u]) for t >= u; -inf above the diagonal
    # before the exp (the upper triangle is positive and can overflow)
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (Bt, nc, Q, Q, H)
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    L = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (Bt, nc, Q, Q)
    xdt = xc * dtc[..., None]  # (Bt, nc, Q, H, P)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", scores[..., None] * L, xdt)

    # --- chunk states and the inter-chunk scan ---------------------------
    # state contribution of step u: decay over u+1..end * b_u x_u^T
    decay_to_end = torch.exp(total - cum)  # (Bt, nc, Q, H)
    S_c = torch.einsum("bckn,bckh,bckhp->bchnp", Bc, decay_to_end * dtc, xc)
    a_chunk = torch.exp(total[:, :, 0, :])  # (Bt, nc, H)

    hcur = (torch.zeros((bt, h, n, p), dtype=f32, device=x.device) if h0 is None
            else h0.to(f32))
    h_enter = []  # the state entering each chunk
    for c in range(nc):
        h_enter.append(hcur)
        hcur = hcur * a_chunk[:, c, :, None, None] + S_c[:, c]
    h_enter = torch.stack(h_enter, dim=1)  # (Bt, nc, H, N, P)

    # --- inter-chunk output: C_t decay(start..t) h_enter -----------------
    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cc, torch.exp(cum), h_enter)

    y = (y_intra + y_inter).reshape(bt, s, h, p)
    y = y + x.to(f32) * D[None, None, :, None]
    return y[:, :s_orig].to(x.dtype), hcur


def _project(params: dict, x: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    return tuple(dense(x, params[k]["w"]) for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _finish(params: dict, y: Tensor, z: Tensor, cfg: ArchConfig) -> Tensor:
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(y.dtype), params["norm"],
                 cfg.norm_eps)
    return dense(y, params["out_proj"]["w"])


def mamba2_forward(params: dict, x: Tensor, cfg: ArchConfig) -> Tensor:
    """Full Mamba-2 layer. x: (B, S, D) -> (B, S, D)."""
    out, _ = mamba2_prefill(params, x, cfg, want_state=False)
    return out


def mamba2_prefill(params: dict, x: Tensor, cfg: ArchConfig, *,
                   want_state: bool = True) -> tuple[Tensor, SSMState | None]:
    """Forward returning the decode-ready state: the last K-1 pre-conv
    inputs in the activation dtype and the SSD state in float32."""
    sc = cfg.ssm
    d_in, nh, n, p = _dims(cfg)
    bt, s = x.shape[:2]
    z, xs, B, C, dt = _project(params, x)
    km1 = sc.conv_kernel - 1
    if want_state:
        def tail(a: Tensor) -> Tensor:  # pad a short sequence on the left
            return (a if s >= km1 else F.pad(a, (0, 0, km1 - s, 0)))[:, -km1:, :]

        tails = (tail(xs), tail(B), tail(C))
    xs = _causal_conv(xs, params["conv_x_w"], params["conv_x_b"])
    B = _causal_conv(B, params["conv_B_w"], params["conv_B_b"])
    C = _causal_conv(C, params["conv_C_w"], params["conv_C_b"])
    y, h_fin = ssd_chunked(xs.reshape(bt, s, nh, p),
                           dt + params["dt_bias"][None, None, :],
                           torch.exp(params["A_log"]), B, C, params["D"],
                           chunk=min(sc.chunk_size, s))
    out = _finish(params, y.reshape(bt, s, d_in), z, cfg)
    if not want_state:
        return out, None
    return out, SSMState(*tails, ssd=h_fin.to(torch.float32))


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype=torch.float32,
                      device=None) -> SSMState:
    sc = cfg.ssm
    d_in, nh, n, p = _dims(cfg)
    km1 = sc.conv_kernel - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SSMState(conv_x=zeros(batch, km1, d_in), conv_B=zeros(batch, km1, n),
                    conv_C=zeros(batch, km1, n),
                    ssd=zeros(batch, nh, n, p, dt=torch.float32))


def _conv_step(window: Tensor, x_t: Tensor, w: Tensor, b: Tensor
               ) -> tuple[Tensor, Tensor]:
    """One causal-conv step. window (B, K-1, C) + x_t (B, C) -> (out, new window)."""
    dt = torch.promote_types(window.dtype, x_t.dtype)  # as jnp.concatenate promotes
    full = torch.cat([window.to(dt), x_t[:, None, :].to(dt)], dim=1)  # (B, K, C)
    out = torch.einsum("bkc,kc->bc", full.to(torch.float32), w.to(torch.float32))
    out = F.silu(out + b.to(torch.float32))
    return out, full[:, 1:, :].to(window.dtype)


def mamba2_decode_step(params: dict, x: Tensor, state: SSMState, cfg: ArchConfig
                       ) -> tuple[Tensor, SSMState]:
    """One-token decode. x: (B, 1, D); returns (out, a new SSMState)."""
    d_in, nh, n, p = _dims(cfg)
    z, xs, B, C, dt = _project(params, x)
    xs_t, new_cx = _conv_step(state.conv_x, xs[:, 0], params["conv_x_w"],
                              params["conv_x_b"])
    B_t, new_cb = _conv_step(state.conv_B, B[:, 0], params["conv_B_w"],
                             params["conv_B_b"])
    C_t, new_cc = _conv_step(state.conv_C, C[:, 0], params["conv_C_w"],
                             params["conv_C_b"])
    xs_t = xs_t.reshape(-1, nh, p)  # (B, H, P)
    dt_t = _softplus(dt[:, 0].to(torch.float32) + params["dt_bias"][None, :])  # (B, H)
    a_t = torch.exp(-dt_t * torch.exp(params["A_log"])[None, :])  # (B, H)

    h = state.ssd.to(torch.float32)
    h = h * a_t[..., None, None] + torch.einsum("bn,bh,bhp->bhnp", B_t, dt_t, xs_t)
    y = torch.einsum("bn,bhnp->bhp", C_t, h) + xs_t * params["D"][None, :, None]
    out = _finish(params, y.reshape(-1, 1, d_in).to(x.dtype), z, cfg)
    return out, SSMState(conv_x=new_cx, conv_B=new_cb, conv_C=new_cc,
                         ssd=h.to(state.ssd.dtype))
