"""Mixture-of-Experts: top-k router, capacity-bounded dispatch, shared experts.

Counterpart of `repro.models.moe`, single-device path. Every expert's
tokens are gathered into a capacity-bounded (E, C) table, the experts'
FFN runs as batched matmuls over the expert axis, and the weighted
outputs are combined back to the tokens.

Capacity: C = max(int(T * top_k * capacity_factor / E) + 1, 4), from
shapes on the host. T counts every token handed in (a prefill bucket's
padding, idle decode slots), as in the reference. Overflow drops
(GShard-style); the dropped fraction is reported in the metrics.

The combine is a gather, not the reference's scatter-add: each (token, k)
pair finds its kept slot through an inverse map, and the k contributions
are summed per token. `index_add_` on CUDA adds floats with atomics, in an
order that changes from run to run; the gather gives the same float32
products as the reference and sums them in a fixed order.

Expert parallelism (`distributed/expert_parallel.py`): with `axis_name`
(the expert axis's process group), each rank of the axis routes the same
tokens, holds experts [ep_index * E/ep_size, (ep_index + 1) * E/ep_size)
as the `experts` leaves it is given, runs those experts' slots of the
global table, gathers its pairs' outputs (a pair whose expert lives on
another rank adds zero) and one all-reduce over the axis completes the
combine, in `combine_dtype`. The tokens and gates enter the per-rank part
through `collectives.enter`, so their gradients sum over the axis, and the
all-reduce's gradient is the identity (the reference's `shard_map`
transposes). With one rank on the axis the result is the single-device
path's, bitwise.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs import ArchConfig, MoEConfig
from repro_torch.distributed import collectives as col
from repro_torch.models.layers import init_dense, init_mlp, mlp, normal

Tensor = torch.Tensor


def init_moe(generator: torch.Generator, cfg: ArchConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    """Router (float32 at any model dtype), stacked experts (E, D, F) and
    (E, F, D), and the shared experts as one MLP of width F * n_shared."""
    mc = cfg.moe
    d, e, f = cfg.d_model, mc.num_experts, mc.d_ff_expert
    scale = d ** -0.5
    p = {
        "router": init_dense(generator, d, e, dtype=torch.float32, device=device),
        "experts": {
            "w_gate": normal(generator, (e, d, f), scale, dtype, device),
            "w_up": normal(generator, (e, d, f), scale, dtype, device),
            "w_down": normal(generator, (e, f, d), scale / (2 * cfg.n_layers) ** 0.5,
                             dtype, device),
        },
    }
    if mc.num_shared_experts:
        p["shared"] = init_mlp(generator, d, f * mc.num_shared_experts,
                               cfg.mlp_variant, dtype=dtype, device=device)
    return p


def router_probs(params: dict, x: Tensor, mc: MoEConfig) -> tuple[Tensor, Tensor, Tensor]:
    """Return (top-k gates (T, k) float32, top-k expert ids (T, k), aux loss)."""
    logits = x.to(torch.float32) @ params["router"]["w"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, mc.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)  # renorm
    # Switch-style load-balance loss: E * sum_e f_e * p_e. The counts are
    # integers, exact in float32 whatever order the adds take.
    e = mc.num_experts
    flat = idx.reshape(-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=x.device))
    f = counts / torch.clamp_min(counts.sum(), 1.0)
    aux = e * torch.sum(f * probs.mean(0))
    return gates, idx, aux


def _capacity(tokens: int, mc: MoEConfig) -> int:
    c = int(tokens * mc.top_k * mc.capacity_factor / mc.num_experts) + 1
    return max(c, 4)


def moe_apply(params: dict, x: Tensor, cfg: ArchConfig, *,
              axis_name=None, ep_size: int = 1, ep_index: int = 0,
              combine_dtype=torch.float32) -> tuple[Tensor, dict]:
    """MoE forward over local tokens x (T, D). Returns (y (T, D), metrics)
    with metrics {"moe_aux", "moe_drop_frac"}, both tensors.

    `axis_name`: the expert axis's process group (None: one device);
    `ep_size` ranks on it, this one `ep_index`, holding E / ep_size
    experts; `combine_dtype`: the combine all-reduce's type."""
    mc = cfg.moe
    t, d = x.shape
    e, k = mc.num_experts, mc.top_k
    if e % ep_size:
        raise ValueError(f"{e} experts do not split over {ep_size} ranks")
    e_loc = e // ep_size
    cap = _capacity(t, mc)
    dev = x.device

    gates, idx, aux = router_probs(params, x, mc)  # (T, k), (T, k)

    # --- dispatch table: for each expert, up to `cap` token slots ---------
    flat_e = idx.reshape(-1)  # (T*k,), flat index j is (token j // k, choice j % k)
    # a stable sort by expert id groups the pairs per expert in token order
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    st = order // k
    grp_start = torch.searchsorted(se, torch.arange(e, device=dev, dtype=se.dtype),
                                   right=False)  # (E,)
    pos = torch.arange(t * k, device=dev) - grp_start[se]
    keep = pos < cap
    drop_frac = 1.0 - keep.to(torch.float32).mean()
    # column `cap` takes the drops and is sliced off; the sentinel row is t
    table_t = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    table_t[se, torch.clamp_max(pos, cap)] = torch.where(keep, st, t)
    table_t = table_t[ep_index * e_loc:(ep_index + 1) * e_loc, :cap]  # this rank's experts
    # inverse map: each pair's kept slot in this rank's flattened (E_loc*C)
    # table, or the zero row E_loc*C past its end when the pair was dropped
    # or its expert lives on another rank
    local = se - ep_index * e_loc
    mine = keep & (local >= 0) & (local < e_loc)
    slot_sorted = torch.where(mine, local * cap + pos, e_loc * cap)
    slot = torch.empty_like(slot_sorted).scatter_(0, order, slot_sorted).view(t, k)

    # --- expert FFN, batched over the expert axis -------------------------
    xv = col.enter(x, axis_name)
    x_pad = torch.cat([xv, xv.new_zeros((1, d))], dim=0)  # sentinel row
    xe = x_pad[table_t]  # (E_loc, C, D)
    w = params["experts"]
    gate_act = torch.bmm(xe, w["w_gate"].to(xe.dtype))
    if cfg.mlp_variant == "swiglu":
        up = torch.bmm(xe, w["w_up"].to(xe.dtype))
        h = F.silu(gate_act.to(torch.float32)).to(xe.dtype) * up
    else:  # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(gate_act.to(torch.float32), approximate="tanh").to(xe.dtype)
    ye = torch.bmm(h, w["w_down"].to(xe.dtype))  # (E_loc, C, D)

    # --- combine: gather each pair's weighted output, sum over k ----------
    ye_pad = torch.cat([ye.reshape(e_loc * cap, d).to(torch.float32),
                        torch.zeros((1, d), dtype=torch.float32, device=dev)], dim=0)
    y = (ye_pad[slot] * col.enter(gates, axis_name)[..., None]).sum(1)  # (T, D) float32
    if axis_name is not None:
        y = col.psum(y.to(combine_dtype), axis_name).to(torch.float32)
    if mc.num_shared_experts:
        y = y + mlp(params["shared"], x, cfg.mlp_variant).to(torch.float32)
    return y.to(x.dtype), {"moe_aux": aux, "moe_drop_frac": drop_frac}


def init_moe_or_dense(generator: torch.Generator, cfg: ArchConfig,
                      layer_idx_in_pattern: int, dtype=torch.bfloat16,
                      device=None) -> dict:
    """MoE or dense MLP params depending on the MoE layout."""
    if cfg.moe is not None and not (
            cfg.moe.layout == "alternate" and layer_idx_in_pattern % 2 == 1):
        return {"kind_moe": init_moe(generator, cfg, dtype, device)}
    return {"kind_dense": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                                   dtype, device)}
