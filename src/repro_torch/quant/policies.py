"""The paper's Table 1 quantization policy for EMVS, in PyTorch.

Counterpart of `repro.quant.policies` (the EMVS part and its memory
report; the LM reuse policies are not ported).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.camera import CameraModel
from repro_torch.core.geometry import PlaneSweepCoeffs
from repro_torch.quant.fixed_point import (
    INT8,
    INT16,
    Q9_7,
    Q11_21,
    FixedPointFormat,
    quantize_roundtrip,
)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EMVSQuantPolicy:
    """Hybrid quantization strategy of paper Table 1."""

    coords: FixedPointFormat = Q9_7  # (x_k, y_k)
    canonical: FixedPointFormat = Q9_7  # {x_k(Z0), y_k(Z0)}
    plane_coords: FixedPointFormat = INT8  # {x_k(Zi), y_k(Zi)}
    homography: FixedPointFormat = Q11_21  # H_Z0
    phi: FixedPointFormat = Q11_21
    dsi: FixedPointFormat = INT16

    def quantize_events(self, xy: Tensor) -> Tensor:
        return quantize_roundtrip(xy, self.coords)

    def quantize_canonical(self, xy0: Tensor) -> Tensor:
        return quantize_roundtrip(xy0, self.canonical)

    def quantize_homography(self, H: Tensor) -> Tensor:
        return quantize_roundtrip(H, self.homography)

    def quantize_phi(self, phi: PlaneSweepCoeffs) -> PlaneSweepCoeffs:
        return PlaneSweepCoeffs(
            alpha=quantize_roundtrip(phi.alpha, self.phi),
            beta_x=quantize_roundtrip(phi.beta_x, self.phi),
            beta_y=quantize_roundtrip(phi.beta_y, self.phi),
        )

    def quantize_plane_coord_values(self, c: Tensor) -> Tensor:
        """Elementwise int8 plane-coord quantization (one coordinate axis).

        Out-of-range coords park at the format max, so the voting bounds
        check drops them for any sensor narrower than 256 px; NaN fails
        the range test and quantizes to 0, as in the reference. The CUDA
        sweep kernel repeats this rule in `csrc/backproject_vote.cu`.
        """
        fmt = self.plane_coords
        out_of_range = (c < -0.5) | (c > fmt.q_max + 0.5)
        return torch.where(out_of_range, torch.full_like(c, float(fmt.q_max)),
                           quantize_roundtrip(c, fmt))

    def quantize_plane_coords(self, x_i: Tensor, y_i: Tensor) -> tuple[Tensor, Tensor]:
        """Nearest-voxel rounding to 8-bit pixel index (park-at-max misses)."""
        q = self.quantize_plane_coord_values
        return q(x_i), q(y_i)

    # -- contract declarations for repro_torch.analysis ------------------

    def declared_formats(self) -> dict[str, FixedPointFormat]:
        """Per-tensor fixed-point formats by datapath name: the
        machine-readable Table 1 the quantization-contract linter checks
        against. The 'dsi' entry is also the int16 saturating store of
        `core/dsi.py:to_storage`."""
        return {
            "coords": self.coords,
            "canonical": self.canonical,
            "plane_coords": self.plane_coords,
            "homography": self.homography,
            "phi": self.phi,
            "dsi": self.dsi,
        }

    def sanctioned_clip_bounds(self) -> frozenset[tuple[float, float]]:
        """Clamp ranges that sanction a narrowing cast: a float->int (or
        int->narrower int) conversion is a deliberate saturating store, not
        a truncation or a wrap, exactly when its operand was just clamped to
        one of these (q_min, q_max) ranges, a format this policy declares."""
        return frozenset(
            (float(fmt.q_min), float(fmt.q_max))
            for fmt in self.declared_formats().values()
        )


TABLE1 = EMVSQuantPolicy()



def memory_report(cam: CameraModel, num_planes: int, events_per_frame: int = 1024
                  ) -> dict[str, dict[str, int]]:
    """Paper section 2.3, "saves up to 50% of memory and bandwidth": bytes
    per frame of each datapath value, float32 against Table 1."""
    n_dsi = cam.width * cam.height * num_planes
    fp32 = {
        "events": events_per_frame * 2 * 4,
        "canonical": events_per_frame * 2 * 4,
        "plane_coords": events_per_frame * 2 * 4,  # per plane, streamed
        "H": 9 * 4,
        "phi": 3 * 128 * 4,
        "dsi": n_dsi * 4,
    }
    q = {
        "events": events_per_frame * 2 * 2,  # Q9.7 pairs packed to 32 bits
        "canonical": events_per_frame * 2 * 2,
        "plane_coords": events_per_frame * 2 * 1,  # int8
        "H": 9 * 4,  # Q11.21 stays 32 bits
        "phi": 3 * 128 * 4,
        "dsi": n_dsi * 2,  # int16
    }
    return {"float32": fp32, "table1": q}
