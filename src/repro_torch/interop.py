"""Carry the reference's state into the port's types.

The reference has no learned weights: its "parameters" are its configs and
the arrays it stages. These functions take plain dicts (for example
`dataclasses.asdict` of a reference config) and numpy arrays, never objects
of the reference package, and return this package's types, so the same
inputs can be fed to both implementations.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

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


def segment_batch_from_numpy(xy, valid, frame_valid, poses_R, poses_t, ref_R,
                             ref_t, *, device=None) -> SegmentBatch:
    """SegmentBatch from numpy fields, in the reference's field order."""
    dev = resolve_device(device)
    f32 = torch.float32
    return SegmentBatch(*(_tensor(a, f32, dev) for a in
                          (xy, valid, frame_valid, poses_R, poses_t, ref_R, ref_t)))
