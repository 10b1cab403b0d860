"""Expert parallelism over a `DeviceMesh` (the production MoE path).

Counterpart of `repro.distributed.expert_parallel`. The reference's
`shard_map` bodies become functions of local tensors with explicit
collectives (`distributed/collectives.py`, which carry `shard_map`'s
gradients); `EPShard.moe` redistributes its DTensor inputs to the body's
placements, takes their local shards, and wraps the body's outputs back
into DTensors.

Strategy (see models/moe.py): activations replicated over the `model`
axis, experts sharded over it. Every model-rank routes the same local
token set, gathers tokens for ITS expert slice into a capacity table,
runs its experts, combines, and one all-reduce over `model` completes the
combine — the same all-reduce a Megatron TP block already pays.

The all_to_all dispatch alternative (tokens physically exchanged between
expert shards) is `dispatch="a2a"`: tokens are split over the token axes
AND `model`; two `all_to_all_single` exchanges carry each rank's capacity
table to the experts' owners and the outputs back, and a scatter-add
combines them, as the reference does (its float sum order on the card
follows the atomics).

`zero3`: the expert weights arrive FSDP-sharded over `data` as well and
are all-gathered inside the body in their storage dtype; the gather's
gradient is a reduce-scatter.

The MoE metrics are averaged over `model` and over the token axes (the
reference averages over `model` and returns the token shards' values as
replicated).

Inputs may be DTensors on `mesh` (the sharded model) or plain tensors,
the same on every rank (the full arrays, as the reference's tests pass
them); plain inputs give plain, full outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.configs import ArchConfig
from repro_torch.distributed import collectives as col
from repro_torch.distributed.sharding import (P, axis_sizes, fsdp_dim, map_with_path,
                                               to_placements)
from repro_torch.models.layers import mlp
from repro_torch.models.moe import _capacity, moe_apply, router_probs

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EPShard:
    """Expert-parallel MoE executor bound to a mesh."""

    mesh: Any  # DeviceMesh
    model_axis: str = "model"
    token_axes: tuple[str, ...] = ("data",)
    dispatch: str = "psum"  # psum | a2a
    combine_dtype: Any = torch.float32  # bf16 halves the combine all-reduce bytes
    # ZeRO-3 expert weights: FSDP-sharded over `data`, all-gathered in the
    # body in their storage dtype; the gradients leave as reduce-scatters
    zero3: bool = False

    def _fsdp_dim(self, shape: tuple[int, ...]) -> int | None:
        fs = axis_sizes(self.mesh).get("data", 1)
        if fs <= 1 or not self.zero3:
            return None
        # dim 0 (experts) carries `model`; FSDP picks among the rest
        return fsdp_dim(shape, fs, taken=(0,))

    def _specs(self, params: dict) -> dict:
        m = self.model_axis

        def leaf(path, x):
            if "experts" in path:
                spec: list = [m] + [None] * (x.dim() - 1)
                d = self._fsdp_dim(tuple(x.shape))
                if d is not None:
                    spec[d] = "data"
                return P(*spec)
            return P(*([None] * x.dim()))

        return map_with_path(params, leaf)

    def _gather_dims(self, params: dict) -> dict:
        """Per expert-weight gather dim, from GLOBAL shapes."""
        if not self.zero3:
            return {}
        return {name: self._fsdp_dim(tuple(w.shape))
                for name, w in params["experts"].items()}

    # -- DTensor boundary ---------------------------------------------------

    def _split_axes(self, x_spec: P) -> set[str]:
        """Mesh axes over which the body's tokens differ."""
        entry = x_spec[0]
        return set((entry,) if isinstance(entry, str) else tuple(entry or ()))

    def _local_params(self, params: dict, split: set[str]) -> dict:
        """Each leaf's local shard in the body's layout. A leaf the body
        holds whole on a token-splitting axis has a partial gradient there
        (each rank saw its own tokens): `Partial`, summed by DTensor."""
        names = tuple(self.mesh.mesh_dim_names)
        specs = self._specs(params)

        def leaf(path, x):
            spec = specs
            for k in path:
                spec = spec[k]
            placements = to_placements(spec, self.mesh)
            grads = tuple(Partial() if pl == Replicate() and names[i] in split else pl
                          for i, pl in enumerate(placements))
            return _as_dtensor(x, self.mesh).redistribute(
                self.mesh, placements).to_local(grad_placements=grads)

        return map_with_path(params, leaf)

    def _run(self, body, params: dict, x: Tensor, x_spec: P) -> tuple[Tensor, dict]:
        plain = not isinstance(x, DTensor)
        xp = to_placements(x_spec, self.mesh)
        xd = _as_dtensor(x, self.mesh).redistribute(self.mesh, xp)
        y, metrics = body(self._local_params(params, self._split_axes(x_spec)),
                          xd.to_local())
        # the metrics are averaged over the token axes: the same on every rank
        for a in self._split_axes(x_spec) - {self.model_axis}:
            metrics = {k: col.pmean(v, self.mesh.get_group(a)) for k, v in metrics.items()}
        rep = [Replicate()] * self.mesh.ndim
        yd = DTensor.from_local(y, self.mesh, xp, run_check=False,
                                shape=xd.shape, stride=xd.stride())
        md = {k: DTensor.from_local(v, self.mesh, rep, run_check=False)
              for k, v in metrics.items()}
        if plain:
            return yd.full_tensor(), {k: v.to_local() for k, v in md.items()}
        return yd, md

    # -- the bodies ---------------------------------------------------------

    def moe(self, params: dict, x: Tensor, cfg: ArchConfig) -> tuple[Tensor, dict]:
        """x: (T, D) logical-global tokens. Returns (y, metrics)."""
        m = self.model_axis
        group = self.mesh.get_group(m)
        ep_size = axis_sizes(self.mesh)[m]
        gather_dims = self._gather_dims(params)
        data_group = self.mesh.get_group("data") if gather_dims else None

        def zero3_gather(p: dict) -> dict:
            if not gather_dims:
                return p
            experts = {name: (col.all_gather(w, data_group, gather_dims[name])
                              if gather_dims[name] is not None else w)
                       for name, w in p["experts"].items()}
            return {**p, "experts": experts}

        if self.dispatch == "psum":
            def body(p, xt):
                y, metrics = moe_apply(zero3_gather(p), xt, cfg, axis_name=group,
                                       ep_size=ep_size, ep_index=col.axis_index(group),
                                       combine_dtype=self.combine_dtype)
                return y, {k: col.pmean_invariant(v, group) for k, v in metrics.items()}

            return self._run(body, params, x, P(self.token_axes, None))
        if self.dispatch != "a2a":
            raise ValueError(f"dispatch {self.dispatch!r}: psum or a2a")

        def body_a2a(p, xt):
            return _moe_all_to_all(zero3_gather(p), xt, cfg, group, ep_size)

        return self._run(body_a2a, params, x, P(tuple(self.token_axes) + (m,), None))


def _as_dtensor(t: Tensor, mesh) -> DTensor:
    """A DTensor as it is, a plain tensor (the same on every rank) as a
    replicated one, differentiably."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _moe_all_to_all(params: dict, x: Tensor, cfg: ArchConfig, axis,
                    ep_size: int) -> tuple[Tensor, dict]:
    """GShard-style dispatch: tokens travel to their experts via all_to_all.

    Local tokens are packed into (E, C_loc) capacity tables, all_to_all
    swaps the expert axis for the rank axis, experts run on gathered
    tokens, and a second all_to_all returns outputs to their owners.
    """
    mc = cfg.moe
    t, d = x.shape
    e = mc.num_experts
    e_loc = e // ep_size
    k = mc.top_k
    cap = _capacity(t, mc) // ep_size + 1  # per-source-rank slots per expert
    dev = x.device

    gates, idx, aux = router_probs(params, x, mc)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], order // k, gates.reshape(-1)[order]
    grp = torch.searchsorted(se, torch.arange(e, device=dev, dtype=se.dtype), right=False)
    pos = torch.arange(t * k, device=dev) - grp[se]
    keep = pos < cap
    drop_frac = 1.0 - keep.to(torch.float32).mean()
    pos_c = torch.clamp_max(pos, cap)

    table_t = torch.full((e, cap + 1), t, dtype=torch.long, device=dev)
    table_t[se, pos_c] = torch.where(keep, st, t)
    table_t = table_t[:, :cap]
    table_g = torch.zeros((e, cap + 1), dtype=torch.float32, device=dev).index_put(
        (se, pos_c), torch.where(keep, sg, torch.zeros_like(sg)))[:, :cap]

    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    xe = x_pad[table_t]  # (E, C, D) tokens this rank sends per expert

    # (E, C, D) = (ep, E_loc, C, D): block r goes to rank r
    xr = col.all_to_all(xe.reshape(ep_size * e_loc * cap, d), axis)
    # xr: (ep, E_loc, C, D) — block [r] = tokens from rank r for MY experts
    xr = xr.reshape(ep_size, e_loc, cap, d).transpose(0, 1).reshape(e_loc, ep_size * cap, d)

    w = params["experts"]  # (E_loc, D, F)
    h = torch.bmm(xr, w["w_gate"].to(xr.dtype))
    if cfg.mlp_variant == "swiglu":
        up = torch.bmm(xr, w["w_up"].to(xr.dtype))
        h = F.silu(h.to(torch.float32)).to(xr.dtype) * up
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(xr.dtype)
    ye = torch.bmm(h, w["w_down"].to(xr.dtype))

    # return trip
    ye = ye.reshape(e_loc, ep_size, cap, d).transpose(0, 1).reshape(ep_size * e_loc * cap, d)
    yb = col.all_to_all(ye.contiguous(), axis).reshape(e, cap, d)  # aligned with table_t

    y = torch.zeros((t + 1, d), dtype=torch.float32, device=dev).index_add(
        0, table_t.reshape(-1), (yb.to(torch.float32) * table_g[..., None]).reshape(-1, d))
    y = y[:t]
    if mc.num_shared_experts:
        y = y + mlp(params["shared"], x, cfg.mlp_variant).to(torch.float32)
    metrics = {"moe_aux": col.pmean(aux, axis), "moe_drop_frac": col.pmean(drop_frac, axis)}
    return y.to(x.dtype), metrics

