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


# Leaves the reference keeps in float32 whatever the model dtype (norm scales).
_FLOAT32_LEAVES = ("scale", "q_norm", "k_norm")


def _leaf_tensor(a, name: str, dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch cannot take it directly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # exact
    else:
        t = torch.from_numpy(np.array(a))  # a writable copy
    if dtype is not None and t.is_floating_point() and name not in _FLOAT32_LEAVES:
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, dtype, device, index=None, name=""):
    if isinstance(tree, Mapping):
        return {k: _convert(v, dtype, device, index, k) for k, v in tree.items()}
    a = np.asarray(tree)
    return _leaf_tensor(a if index is None else a[index], name, dtype, device)


def lm_params_from_numpy(tree: Mapping[str, Any], cfg: ArchConfig, *, device=None,
                         dtype=None) -> dict:
    """The port's LM parameters from the reference's parameter tree, as
    nested dicts of numpy arrays (`jax.tree.map(np.asarray, params)`).

    The reference stacks each pattern position's layers on a leading
    super-block axis inside a `blocks` tuple; the port keeps one dict per
    layer, in order. bfloat16 leaves go through float32, which holds them
    exactly. `dtype`, when given, casts every floating leaf except the
    norm scales, which the reference keeps in float32 at any model dtype.
    """
    dev = resolve_device(device)
    out = {k: _convert(v, dtype, dev, name=k) for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    pattern = cfg.pattern()
    if len(blocks) != len(pattern):
        raise ValueError(f"{len(blocks)} block groups for pattern {pattern}")
    out["blocks"] = [_convert(blocks[i], dtype, dev, index=sb)
                     for sb in range(cfg.n_superblocks()) for i in range(len(pattern))]
    return out
