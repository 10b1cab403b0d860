"""Key-frame selection (K), in PyTorch.

Counterpart of `repro.core.keyframe`. A new key reference view is declared
when the camera has translated more than `dist_threshold` (a fraction of
the mean scene depth, as in EMVS) from the previous key frame. On a key
frame: extract depth (D), merge (M), reset the DSI, re-anchor the
reference pose.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.geometry import SE3, pose_distance

Tensor = torch.Tensor


class KeyframeState(NamedTuple):
    T_w_ref: SE3  # current reference (virtual camera) pose
    keyframe_id: Tensor  # int32 counter
    dist_threshold: Tensor  # float32


def init_keyframe_state(T_w_ref: SE3, mean_depth: float, frac: float = 0.15) -> KeyframeState:
    dev = T_w_ref.t.device
    return KeyframeState(
        T_w_ref=T_w_ref,
        keyframe_id=torch.tensor(0, dtype=torch.int32, device=dev),
        dist_threshold=torch.tensor(mean_depth * frac, dtype=torch.float32, device=dev),
    )


def is_new_keyframe(state: KeyframeState, T_w_cam: SE3) -> Tensor:
    """True when the camera moved beyond the threshold from the reference."""
    return pose_distance(T_w_cam, state.T_w_ref) > state.dist_threshold


def advance_keyframe(state: KeyframeState, T_w_cam: SE3, new_kf: Tensor) -> KeyframeState:
    """Branchless key-frame update: the camera's pose becomes the reference
    where `new_kf` holds."""
    return KeyframeState(
        T_w_ref=SE3(R=torch.where(new_kf, T_w_cam.R, state.T_w_ref.R),
                    t=torch.where(new_kf, T_w_cam.t, state.T_w_ref.t)),
        keyframe_id=state.keyframe_id + new_kf.to(torch.int32),
        dist_threshold=state.dist_threshold,
    )
