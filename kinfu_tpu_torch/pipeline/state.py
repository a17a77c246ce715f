"""The per-session state and step outputs (port of
kinfu_tpu/pipeline/state.py), and their conversion to and from numpy.

This system has no weights: the state a session carries, and the one that
moves between the two packages, is the TSDF volume, the pose, the model
pyramids and the frame count. `state_from_numpy` takes them as numpy
arrays, for example a JAX `KinFuState` converted with `np.asarray` field
by field; `state_to_numpy` gives them back in the same layout. A
streaming session's state adds the grid's whole-voxel offset, `origin_vox`
(`streaming_state_from_numpy` / `streaming_state_to_numpy`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.device import resolve_device
from kinfu_tpu_torch.geometry.se3 import Pose, pose_from_matrix, pose_matrix
from kinfu_tpu_torch.volume.tsdf import TSDFVolume


class KinFuState(NamedTuple):
    vol: TSDFVolume
    #: world-from-camera pose
    pose: Pose
    #: raycast-predicted model pyramids in the camera frame of `pose`
    model_vmaps: Tuple[torch.Tensor, ...]
    model_nmaps: Tuple[torch.Tensor, ...]
    #: 1 before the first frame is fused (bootstrap)
    frame_count: torch.Tensor  # int32 scalar


class StepOutput(NamedTuple):
    #: world-from-camera pose after this frame, 4x4
    pose_matrix: torch.Tensor
    #: False when ICP failed this frame
    tracking_ok: torch.Tensor
    #: ICP inlier count at the finest level (0 on the bootstrap frame)
    icp_inliers: torch.Tensor


def state_from_numpy(d: Mapping[str, Any], device="cuda") -> KinFuState:
    """State on `device` from numpy arrays: "tsdf", "weight", "color"
    ([Z,Y,X] int16, int16, int32), "pose" (4x4 f32), "model_vmaps" /
    "model_nmaps" (sequences of [h,w,3] f32, finest first) and
    "frame_count". "cuda" without a usable CUDA device raises."""
    device = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    vol = TSDFVolume(
        tsdf=t(d["tsdf"], torch.int16),
        weight=t(d["weight"], torch.int16),
        color=t(d["color"], torch.int32),
    )
    return KinFuState(
        vol=vol,
        pose=pose_from_matrix(t(d["pose"], torch.float32)),
        model_vmaps=tuple(t(m, torch.float32) for m in d["model_vmaps"]),
        model_nmaps=tuple(t(m, torch.float32) for m in d["model_nmaps"]),
        frame_count=t(d["frame_count"], torch.int32),
    )


def state_to_numpy(state: KinFuState) -> Dict[str, Any]:
    """The inverse of `state_from_numpy`: copies, so later in-place steps
    on the state leave them as they are."""

    def n(a):
        return a.detach().cpu().numpy().copy()

    return {
        "tsdf": n(state.vol.tsdf),
        "weight": n(state.vol.weight),
        "color": n(state.vol.color),
        "pose": n(pose_matrix(state.pose)),
        "model_vmaps": [n(m) for m in state.model_vmaps],
        "model_nmaps": [n(m) for m in state.model_nmaps],
        "frame_count": n(state.frame_count),
    }


def streaming_state_from_numpy(d: Mapping[str, Any], device="cuda"):
    """A `pipeline/streaming.py::StreamingState` on `device` from the
    numpy fields of `state_from_numpy` and "origin_vox" (int32 [3], x y
    z), for example a JAX `StreamingState`'s `kinfu` fields and its
    `origin_vox`."""
    from kinfu_tpu_torch.pipeline.streaming import StreamingState

    kinfu = state_from_numpy(d, device=device)
    origin = torch.as_tensor(np.array(d["origin_vox"]), dtype=torch.int32,
                             device=kinfu.frame_count.device)
    return StreamingState(kinfu=kinfu, origin_vox=origin)


def streaming_state_to_numpy(state) -> Dict[str, Any]:
    """The inverse of `streaming_state_from_numpy` (copies)."""
    return dict(state_to_numpy(state.kinfu),
                origin_vox=state.origin_vox.detach().cpu().numpy().copy())
