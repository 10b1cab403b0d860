"""Bit-exact Qm.n fixed-point emulation (paper Table 1), in PyTorch.

Counterpart of `repro.quant.fixed_point`. Operands are quantized with
stored-integer semantics (round half away from zero, saturating) and the
arithmetic runs in float32.

The float -> int32 conversion saturates explicitly: the clamp runs in
float64, where the Q11.21 bound 2^31 - 1 is exact, and NaN becomes 0. That
is what XLA's conversion gives, and it makes the CPU and CUDA results
agree (a plain `.to(torch.int32)` wraps 2^31 to -2^31 on the CPU and
saturates on CUDA).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class FixedPointFormat(NamedTuple):
    total_bits: int
    frac_bits: int
    signed: bool = True

    @property
    def scale(self) -> float:
        return float(2 ** self.frac_bits)

    @property
    def q_min(self) -> int:
        return -(2 ** (self.total_bits - 1)) if self.signed else 0

    @property
    def q_max(self) -> int:
        return 2 ** (self.total_bits - 1) - 1 if self.signed else 2 ** self.total_bits - 1

    @property
    def lsb(self) -> float:
        return 1.0 / self.scale


Q9_7 = FixedPointFormat(16, 7)  # event coords & canonical coords
Q11_21 = FixedPointFormat(32, 21)  # H_Z0 and phi
INT8 = FixedPointFormat(8, 0, signed=False)  # plane coords (pixel index 0..255)
INT16 = FixedPointFormat(16, 0)  # DSI scores


def round_half_away(x: Tensor) -> Tensor:
    """RTL-style rounding, half away from zero: sign(x) * floor(|x| + 0.5).

    `torch.round` rounds half to even, so it is written out.
    """
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def saturate_to_int32(q: Tensor, lo: float, hi: float) -> Tensor:
    """float -> int32 with XLA's conversion semantics: clamp to
    `[lo, hi]`, NaN -> 0. `q` holds float32 values."""
    q = torch.clamp(q.to(torch.float64), lo, hi)
    return torch.nan_to_num(q, nan=0.0).to(torch.int32)


def quantize(x: Tensor, fmt: FixedPointFormat) -> Tensor:
    """float -> stored integer (int32 carrier), saturating.

    The reference clamps the float32 value to `[q_min, q_max]` as float32
    bounds (2^31 - 1 rounds to 2^31) and then converts with saturation;
    clamping in float64 to the exact integer bounds gives the same int32.
    """
    q = round_half_away(x.to(torch.float32) * fmt.scale)
    return saturate_to_int32(q, float(fmt.q_min), float(fmt.q_max))


def dequantize(q: Tensor, fmt: FixedPointFormat) -> Tensor:
    return q.to(torch.float32) / fmt.scale


def quantize_roundtrip(x: Tensor, fmt: FixedPointFormat) -> Tensor:
    """float -> quantized float (the value the hardware would see)."""
    return dequantize(quantize(x, fmt), fmt)



def storage_bytes(n_elems: int, fmt: FixedPointFormat) -> int:
    return n_elems * fmt.total_bits // 8
