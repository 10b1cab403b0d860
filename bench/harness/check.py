"""The comparison that decides `correct`: the program's outputs against the
plain reference (`bench/reference/emvs.py`), number by number, each
against its limit from `bench/limits/<workload>.json`.

Numbers (the worst over everything compared in a run):
  frames  events, validity and frame times that differ between the
          program's frames and the reference's, plus any difference in
          the frame count (offline cells; exact);
  plan    key-frame segments in one plan and not the other (exact);
  missing segments due in the window that never came (live cells; exact);
  pose    largest absolute difference of a frame's or a segment's
          reference pose (rotation entries and translation, metres);
  votes   share of the reference's votes that the program's stored DSI
          misses or adds, sum |dsi - dsi_ref| / sum dsi_ref, worst segment;
  depth   share of the reference's kept pixels on which the depth maps
          disagree: kept on one side only, or kept on both with depths
          more than 1e-3 apart relatively or confidences unequal;
  cloud   the same share over the point clouds: valid on one side only,
          or points more than 1e-3 (relative to the point's largest
          coordinate, plus 1 mm) apart, or weights unequal.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

LIMITS_DIR = Path(__file__).resolve().parents[1] / "limits"
DEPTH_RTOL = 1e-3
CLOUD_RTOL = 1e-3
CLOUD_ATOL = 1e-3


def load_limits(workload: str) -> dict[str, float]:
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())["limits"]


class Tally:
    """Running worst of each compared number."""

    def __init__(self):
        self.values: dict[str, float] = {}

    @classmethod
    def from_values(cls, values: dict[str, float]) -> "Tally":
        t = cls()
        t.values = dict(values)
        return t

    def worst(self, name: str, value: float) -> None:
        self.values[name] = max(self.values.get(name, 0.0), float(value))

    def report(self, limits: dict[str, float]) -> tuple[bool, dict]:
        """(every number within its limit, {name: {value, limit}}) over the
        limits' names; a number never measured counts as failed."""
        out, ok = {}, True
        for name, limit in limits.items():
            value = self.values.get(name)
            out[name] = {"value": value, "limit": limit}
            ok = ok and value is not None and value <= limit
        return ok, out


def frames_mismatch(prog, ref) -> int:
    """Elements of (xy, valid, t_mid) that differ; a differing frame count
    counts every element of the longer side."""
    xy, valid, t_mid = (x.to(ref.xy.device) for x in prog)
    if xy.shape != ref.xy.shape:
        return int(max(xy.numel(), ref.xy.numel()))
    return int((xy != ref.xy).sum() + (valid != ref.valid).sum()
               + (t_mid != ref.t_mid).sum())


def pose_err(R, p, R_ref, p_ref) -> float:
    R, p = R.to(R_ref.device, torch.float64), p.to(R_ref.device, torch.float64)
    return float(max((R - R_ref.double()).abs().max(), (p - p_ref.double()).abs().max()))


def segment_gaps(prog: dict, ref) -> dict[str, float]:
    """votes, depth, cloud and pose for one segment; `prog` holds the
    program's tensors under the reference's field names."""
    dev = ref.dsi.device
    g = {k: v.to(dev) for k, v in prog.items()}
    dsi_p, dsi_r = g["dsi"].to(torch.int64), ref.dsi.to(torch.int64)
    votes = float((dsi_p - dsi_r).abs().sum()) / max(1.0, float(dsi_r.sum()))

    d_p, d_r = g["depth"].double(), ref.depth.double()
    kept = ref.mask
    same = (g["mask"] == kept) & (~kept | (((d_p - d_r).abs() <= DEPTH_RTOL * d_r.abs())
                                           & (g["confidence"].double()
                                              == ref.confidence.double())))
    depth = float((~same).sum()) / max(1.0, float(kept.sum()))

    pt_p, pt_r = g["points"].double(), ref.points.double()
    v_r = ref.point_valid
    tol = CLOUD_RTOL * pt_r.abs().amax(-1) + CLOUD_ATOL
    close = ((pt_p - pt_r).abs().amax(-1) <= tol) & (
        g["weights"].double() == ref.weights.double())
    same_c = (g["point_valid"] == v_r) & (~v_r | close)
    cloud = float((~same_c).sum()) / max(1.0, float(v_r.sum()))
    pose = pose_err(g["R_ref"], g["p_ref"], ref.R_ref, ref.p_ref)
    return {"votes": votes, "depth": depth, "cloud": cloud, "pose": pose}
