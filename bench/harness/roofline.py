"""Least device time of the EMVS kernels' work, on one NVIDIA H100.

A frozen copy of the port's roofline arithmetic (`launch/roofline.py`),
counted from the algorithm's real work rather than from the padded bucket
an implementation sweeps, so it reads the same whatever implements the
sweep:

  * B1, back-projection and vote: per real frame its events' canonical
    coordinates (two float32) and validity (one byte) read once, its
    coefficients (three float32 per plane) read once; per segment the
    stored DSI (int16 under Table 1, else float32) written once;
    9 float32 operations per valid (event, plane): per coordinate a
    subtract, a fused multiply-add (2) and an add, then the vote's add;
  * B2, depth max and argmax: the stored DSI read once, confidence and
    refined argmax (float32 each) written once per pixel; 2 operations per
    voxel (a compare and a select).

The least time is the larger of bytes over the HBM bandwidth and
operations over the float32 peak (NVIDIA's H100 SXM data sheet, 700 W).
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
B1_OPS_PER_PROJECTION = 9
B2_OPS_PER_VOXEL = 2


def least_seconds(nbytes: float, nops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, nops / PEAK_F32_OPS_PER_S)


def b1_work(frames: int, events_per_frame: int, valid_events: int, nz: int,
            h: int, w: int, quantized: bool) -> tuple[int, int]:
    """(bytes, operations) of B1 for one segment of `frames` real frames."""
    store = 2 if quantized else 4
    nbytes = 9 * frames * events_per_frame + 12 * frames * nz + store * nz * h * w
    return nbytes, B1_OPS_PER_PROJECTION * valid_events * nz


def b2_work(nz: int, h: int, w: int, quantized: bool) -> tuple[int, int]:
    """(bytes, operations) of B2 for one segment."""
    item = 2 if quantized else 4
    return item * nz * h * w + 8 * h * w, B2_OPS_PER_VOXEL * nz * h * w
