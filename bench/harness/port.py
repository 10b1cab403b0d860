"""The program under test, built from a configuration file: the port's
camera, DSI configuration and EMVS options, and its outputs put under the
reference's field names."""
from __future__ import annotations

import gc

import numpy as np
import torch


def build(cfg: dict):
    """(CameraModel, DSIConfig, EMVSOptions) of the port for `cfg`."""
    from repro_torch.core.camera import CameraModel
    from repro_torch.core.dsi import DSIConfig
    from repro_torch.core.pipeline import EMVSOptions

    c, e = cfg["camera"], cfg["emvs"]
    cam = CameraModel(width=int(c["width"]), height=int(c["height"]), fx=float(c["fx"]),
                      fy=float(c["fy"]), cx=float(c["cx"]), cy=float(c["cy"]))
    dsi_cfg = DSIConfig.for_camera(cam, num_planes=int(e["num_planes"]),
                                   z_min=float(e["z_min"]), z_max=float(e["z_max"]))
    opts = EMVSOptions(voting=e["voting"], formulation=e["formulation"],
                       quantized=bool(e["quantized"]),
                       keyframe_dist_frac=float(e["keyframe_dist_frac"]),
                       detection_threshold_c=float(e["detection_threshold_c"]),
                       detection_min_votes=float(e["detection_min_votes"]),
                       median_filter=bool(e["median_filter"]))
    return cam, dsi_cfg, opts


def event_stream(xy: np.ndarray, t: np.ndarray, polarity: np.ndarray, valid: np.ndarray):
    """Host arrays as the port's EventStream (CPU tensors sharing memory)."""
    from repro_torch.events.simulator import EventStream

    return EventStream(torch.from_numpy(xy), torch.from_numpy(t),
                       torch.from_numpy(polarity), torch.from_numpy(valid))


def trajectory(times: np.ndarray, R: np.ndarray, p: np.ndarray):
    from repro_torch.core.geometry import SE3
    from repro_torch.events.simulator import Trajectory

    return Trajectory(torch.from_numpy(times), SE3(torch.from_numpy(R), torch.from_numpy(p)))


def segment_outputs(seg, cloud) -> dict:
    """A SegmentResult and its PointCloud under the reference's names."""
    dm = seg.depth_map
    return {"dsi": seg.dsi, "depth": dm.depth, "mask": dm.mask,
            "confidence": dm.confidence, "R_ref": seg.T_w_ref.R, "p_ref": seg.T_w_ref.t,
            "points": cloud.points, "weights": cloud.weights,
            "point_valid": cloud.valid}


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def settle() -> None:
    """End of set-up: collect once and move every object made so far (the
    imports, the generated inputs, the warmed program) out of the cyclic
    collector's reach, as a long-running service does after start-up, so
    that a collection in the window scans only what the window makes."""
    gc.collect()
    gc.freeze()
