"""Keyframe selection and storage (a copy of kinfu_tpu/mapping/keyframes.py,
which is numpy only).

No reference equivalent (the reference tracks frame-to-model only and keeps
a bare pose vector, kinectfusion.h:59). Keyframes anchor the pose graph
(mapping/pose_graph.py) and provide relocalization candidates after
tracking loss — replacing the reference's wipe-everything recovery
(kinectfusion.cpp:97-102) with something that can survive a failure.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class Keyframe:
    index: int          # frame index in the session
    pose: np.ndarray    # world-from-camera [4,4] at selection time
    #: small depth thumbnail (float32 metres) for relocalization scoring
    depth_thumb: Optional[np.ndarray] = None
    #: model vertex/normal pyramids at selection time (for loop-closure
    #: ICP, mapping/loop_closure.py); tuples of [H,W,3] float32 arrays
    vmaps: Optional[tuple] = None
    nmaps: Optional[tuple] = None
    #: raw sensor frame at selection time (depth [H,W] f32 sensor units,
    #: color [H,W,3] u8) — lets the map be re-integrated at corrected poses
    #: after a loop closure (KinFuSession._rebuild_map)
    depth: Optional[np.ndarray] = None
    color: Optional[np.ndarray] = None


@dataclass
class KeyframeStore:
    """Distance/angle-gated keyframe selection (standard SLAM policy)."""

    min_translation: float = 0.10   # metres
    min_rotation_deg: float = 10.0  # degrees
    keyframes: List[Keyframe] = field(default_factory=list)

    def should_add(self, pose: np.ndarray) -> bool:
        if not self.keyframes:
            return True
        last = self.keyframes[-1].pose
        rel = np.linalg.inv(last.astype(np.float64)) @ pose.astype(np.float64)
        t = np.linalg.norm(rel[:3, 3])
        angle = np.degrees(
            np.arccos(np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1))
        )
        return t >= self.min_translation or angle >= self.min_rotation_deg

    def maybe_add(
        self,
        index: int,
        pose: np.ndarray,
        depth_thumb: Optional[np.ndarray] = None,
        vmaps: Optional[tuple] = None,
        nmaps: Optional[tuple] = None,
        depth: Optional[np.ndarray] = None,
        color: Optional[np.ndarray] = None,
    ) -> bool:
        if self.should_add(pose):
            self.keyframes.append(
                Keyframe(index=index, pose=np.asarray(pose, np.float32),
                         depth_thumb=depth_thumb, vmaps=vmaps, nmaps=nmaps,
                         depth=depth, color=color)
            )
            return True
        return False

    def nearest(self, pose: np.ndarray) -> Optional[Keyframe]:
        """Closest keyframe by translation (relocalization seed)."""
        if not self.keyframes:
            return None
        t = np.asarray(pose, np.float64)[:3, 3]
        dists = [np.linalg.norm(k.pose[:3, 3] - t) for k in self.keyframes]
        return self.keyframes[int(np.argmin(dists))]

    def __len__(self) -> int:
        return len(self.keyframes)
