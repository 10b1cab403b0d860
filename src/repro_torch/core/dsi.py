"""Disparity Space Image (DSI): the ray-density volume, in PyTorch.

Counterpart of `repro.core.dsi`. Layout (Nz, h, w), z-major. Scores
accumulate in int32 and are stored as int16 (paper Table 1) with an
RTL-style saturating clip.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.geometry import depth_planes

Tensor = torch.Tensor

DSI_STORE_DTYPE = torch.int16  # paper Table 1: DSI scores, 16-bit integer
DSI_ACCUM_DTYPE = torch.int32  # accumulation dtype (saturation-checked on store)


def store_clip_bounds() -> tuple[float, float]:
    """The (min, max) saturating-store clamp as float literals."""
    info = torch.iinfo(DSI_STORE_DTYPE)
    return float(info.min), float(info.max)


@dataclasses.dataclass(frozen=True)
class DSIConfig:
    width: int = 240
    height: int = 180
    num_planes: int = 128
    z_min: float = 0.5
    z_max: float = 5.0
    inverse_depth: bool = True

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.num_planes, self.height, self.width)

    def planes(self, device=None) -> Tensor:
        return depth_planes(self.z_min, self.z_max, self.num_planes,
                            self.inverse_depth, device=device)

    @staticmethod
    def for_camera(cam: CameraModel, num_planes: int = 128, z_min: float = 0.5,
                   z_max: float = 5.0, inverse_depth: bool = True) -> "DSIConfig":
        return DSIConfig(cam.width, cam.height, num_planes, z_min, z_max, inverse_depth)


def zeros(cfg: DSIConfig, dtype=DSI_ACCUM_DTYPE, device=None) -> Tensor:
    return torch.zeros(cfg.shape, dtype=dtype, device=device)


def to_storage(dsi: Tensor) -> Tensor:
    """Accumulator -> int16 storage: clip to the int16 range, then convert
    (float values truncate toward zero, as XLA's conversion does)."""
    lo, hi = store_clip_bounds()
    if dsi.is_floating_point():
        return torch.clamp(dsi, lo, hi).to(DSI_STORE_DTYPE)
    return torch.clamp(dsi, int(lo), int(hi)).to(DSI_STORE_DTYPE)


def from_storage(dsi: Tensor) -> Tensor:
    return dsi.to(DSI_ACCUM_DTYPE)


def storage_roundtrip(dsi: Tensor) -> Tensor:
    """int16 store semantics on an accumulator DSI, back in int32 (as the
    reference returns it for every accumulator dtype)."""
    return from_storage(to_storage(dsi))



def _fraction(hit: Tensor) -> Tensor:
    """The float32 mean of a bool tensor as the reference takes it: the
    count (exact in float32 below 2^24 elements) over the float32 size."""
    return hit.sum().to(torch.float32) / torch.tensor(hit.numel(), dtype=torch.float32,
                                                      device=hit.device)


def saturation_fraction(dsi: Tensor) -> Tensor:
    """Fraction of voxels that would clip at int16: the paper's claim that
    16 bits suffice, asked before the store."""
    info = torch.iinfo(DSI_STORE_DTYPE)
    return _fraction((dsi > info.max) | (dsi < info.min))


def store_saturation_fraction(dsi: Tensor) -> Tensor:
    """Fraction of voxels AT the int16 store limits (inclusive): the same
    question asked of a volume that was already stored, where
    `saturation_fraction` is zero by construction."""
    info = torch.iinfo(DSI_STORE_DTYPE)
    return _fraction((dsi >= info.max) | (dsi <= info.min))


def store_saturation_fractions(dsis: Tensor) -> Tensor:
    """`store_saturation_fraction` of each volume of a stack (S, Nz, h, w),
    as one float32 (S,) tensor on the stack's device (no host sync)."""
    info = torch.iinfo(DSI_STORE_DTYPE)
    hit = ((dsis >= info.max) | (dsis <= info.min)).flatten(1)
    return hit.sum(1).to(torch.float32) / torch.full(
        (), hit.shape[1], dtype=torch.float32, device=dsis.device)
