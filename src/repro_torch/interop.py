"""Carry the reference's state into the port's types.

The EMVS datapath has no learned weights: its "parameters" are its configs
and the arrays it stages. The LM substrate has random weights, carried
across by `lm_params_from_numpy`. These functions take plain dicts (for
example `dataclasses.asdict` of a reference config) and numpy arrays,
never objects of the reference package, and return this package's types,
so the same inputs can be fed to both implementations.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.camera import CameraModel
from repro_torch.core.dsi import DSIConfig
from repro_torch.core.geometry import SE3
from repro_torch.core.pipeline import EMVSOptions, SegmentBatch
from repro_torch.device import resolve_device
from repro_torch.events.aggregation import EventFrames
from repro_torch.quant.fixed_point import FixedPointFormat
from repro_torch.quant.policies import EMVSQuantPolicy


def camera_from_dict(d: Mapping[str, Any]) -> CameraModel:
    return CameraModel(**dict(d))


def dsi_config_from_dict(d: Mapping[str, Any]) -> DSIConfig:
    return DSIConfig(**dict(d))


def policy_from_dict(d: Mapping[str, Any]) -> EMVSQuantPolicy:
    """Each entry is a (total_bits, frac_bits, signed) triple or mapping."""
    def fmt(v) -> FixedPointFormat:
        if isinstance(v, Mapping):
            return FixedPointFormat(**dict(v))
        return FixedPointFormat(*tuple(v))

    return EMVSQuantPolicy(**{k: fmt(v) for k, v in d.items()})


def options_from_dict(d: Mapping[str, Any]) -> EMVSOptions:
    """EMVSOptions from the reference's fields. The reference's
    `kernel_interpret` knob has no counterpart (the device decides) and
    must be None."""
    d = dict(d)
    interpret = d.pop("kernel_interpret", None)
    if interpret is not None:
        raise ValueError(
            f"kernel_interpret={interpret!r} has no counterpart in the port: "
            "the tensor's device picks the kernel or its plain version")
    if "policy" in d:
        d["policy"] = policy_from_dict(d["policy"])
    return EMVSOptions(**d)


def _tensor(a, dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def event_frames_from_numpy(xy, valid, t_mid, R, t, *, device=None) -> EventFrames:
    """EventFrames from numpy fields: xy (F, E, 2), valid (F, E), t_mid (F,),
    poses R (F, 3, 3) and t (F, 3)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return EventFrames(
        xy=_tensor(xy, f32, dev),
        valid=_tensor(valid, torch.bool, dev),
        t_mid=_tensor(t_mid, f32, dev),
        poses=SE3(_tensor(R, f32, dev), _tensor(t, f32, dev)),
    )


def _mask_or_weights(a, device: torch.device) -> torch.Tensor:
    """A bool mask when every value is exactly 0 or 1 (checked on the host,
    before the device sees it), else float32 weights as given."""
    a = np.asarray(a)
    exact = a.dtype == bool or bool(np.isin(a, (0, 1)).all())
    return _tensor(a, torch.bool if exact else torch.float32, device)


def segment_batch_from_numpy(xy, valid, frame_valid, poses_R, poses_t, ref_R,
                             ref_t, *, device=None) -> SegmentBatch:
    """SegmentBatch from numpy fields, in the reference's field order.

    The reference's float32 `valid` and `frame_valid` arrive as bool masks
    when they hold only 1 and 0, and as float32 weights otherwise (the
    scatter and matmul formulations vote those as given; the kernel
    formulation refuses them)."""
    dev = resolve_device(device)
    f32 = torch.float32
    return SegmentBatch(
        _tensor(xy, f32, dev), _mask_or_weights(valid, dev),
        _mask_or_weights(frame_valid, dev),
        *(_tensor(a, f32, dev) for a in (poses_R, poses_t, ref_R, ref_t)))


# Leaves the reference keeps in float32 whatever the model dtype, by the
# end of their path: norm scales, the MoE router, Mamba-2's per-head
# parameters and its gated norm.
_FLOAT32_PATHS = (("scale",), ("q_norm",), ("k_norm",), ("router", "w"),
                  ("mamba", "A_log"), ("mamba", "dt_bias"), ("mamba", "D"),
                  ("mamba", "norm"))


def _keeps_float32(path: tuple[str, ...]) -> bool:
    return any(path[-len(end):] == end for end in _FLOAT32_PATHS)


def _leaf_tensor(a, path: tuple[str, ...], dtype, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().clone()
    elif np.asarray(a).dtype.name == "bfloat16":  # ml_dtypes: torch cannot take it
        t = torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)  # exact
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point() and not _keeps_float32(path):
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, dtype, device, index=None, path=()):
    if isinstance(tree, Mapping):
        return {k: _convert(v, dtype, device, index, path + (k,)) for k, v in tree.items()}
    a = tree if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return _leaf_tensor(a if index is None else a[index], path, dtype, device)


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig, *, device=None,
                         dtype=None) -> dict:
    """The port's LM parameters from the reference's parameter tree, as
    nested dicts of numpy arrays (`jax.tree.map(np.asarray, params)`) or
    of tensors in the same stacked layout (`lm_params_stacked`).

    The reference stacks each pattern position's layers on a leading
    super-block axis inside a `blocks` tuple; the port keeps one dict per
    layer, in order. bfloat16 leaves go through float32, which holds them
    exactly. `dtype`, when given, casts every floating leaf except those
    the reference keeps in float32 at any model dtype (`_FLOAT32_PATHS`:
    norm scales, the MoE router, Mamba-2's A_log, dt_bias, D and norm).
    """
    dev = resolve_device(device)
    blocks = tree["blocks"]
    pattern = cfg.pattern()
    if len(blocks) != len(pattern):
        raise ValueError(f"{len(blocks)} block groups for pattern {pattern}")
    return {k: [_convert(blocks[i], dtype, dev, index=sb)
                for sb in range(cfg.n_superblocks()) for i in range(len(pattern))]
            if k == "blocks" else _convert(v, dtype, dev, path=(k,))
            for k, v in tree.items()}


def lm_params_stacked(params: Mapping[str, Any], cfg: ArchConfig) -> dict:
    """The inverse of `lm_params_from_numpy`, in tensors: the port's
    per-layer `blocks` list regrouped as the reference's tuple over pattern
    positions, each leaf stacked over super-blocks on a new leading axis
    (on the leaves' device, in their dtypes); the leaves a mesh layout
    holds stacked (`params["stacks"]`, `distributed/sharding.py`) go in as
    they are. Other entries are kept. Any tree shaped like the parameters
    converts (AdamW's m and v too)."""
    pattern = cfg.pattern()
    n, n_sb = len(pattern), cfg.n_superblocks()
    blocks = params["blocks"]
    if len(blocks) != n * n_sb:
        raise ValueError(f"{len(blocks)} layers for {n_sb} super-blocks of {pattern}")
    held = params.get("stacks") or [{}] * n

    def detached(tree):
        if isinstance(tree, Mapping):
            return {k: detached(v) for k, v in tree.items()}
        return tree.detach()

    def stack(layers, held):
        if not isinstance(layers[0], Mapping):
            return torch.stack([t.detach() for t in layers])
        out = {k: stack([layer[k] for layer in layers], held.get(k, {})) for k in layers[0]}
        out.update({k: detached(v) for k, v in held.items() if k not in out})
        return out

    stacked = tuple(stack([blocks[sb * n + i] for sb in range(n_sb)], held[i])
                    for i in range(n))
    return {k: stacked if k == "blocks" else v for k, v in params.items() if k != "stacks"}


def lm_params_to_numpy(params: Mapping[str, Any], cfg: ArchConfig) -> dict:
    """The reference's parameter tree from the port's: `lm_params_stacked`,
    then each leaf on the host as numpy, bfloat16 as float32 (exact; numpy
    has no bfloat16 of its own). `lm_params_from_numpy` of the result, at
    the source's dtype, gives the source back bitwise."""
    def host(tree):
        if isinstance(tree, Mapping):
            return {k: host(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(host(v) for v in tree)
        t = tree.detach().cpu()
        return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()

    return host(lm_params_stacked(params, cfg))
