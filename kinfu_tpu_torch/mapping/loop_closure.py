"""Loop-closure detection + trajectory correction over the keyframe graph
(port of kinfu_tpu/mapping/loop_closure.py: numpy, with the graph
optimized in torch on the session's device, mapping/pose_graph.py).

No reference equivalent: the reference tracks frame-to-model against a
fixed volume and keeps an unbounded drifting pose vector with no correction
(kinectfusion.h:59; SURVEY.md section 5 "long-context" call-out names the
keyframe pose-graph layer as this framework's counterpart).

Pipeline (driven by KinFuSession when pose_graph=True):
  1. Keyframes store their model pyramids (the raycast prediction at
     selection time) next to their poses.
  2. When the tracked pose re-enters the neighbourhood of a NON-ADJACENT
     keyframe (translation/angle gates + index gap), ICP registers the
     current measurement pyramid against that keyframe's stored pyramid —
     the same point-to-plane machinery as tracking (tracking/icp.py), so
     the measurement Z = T_kf^-1 T_cur follows the codebase's increment
     convention.
  3. On ICP success, a pose graph over the keyframes (odometry edges from
     the tracked trajectory + the closure edge) is optimized
     (mapping/pose_graph.py) and the full trajectory is corrected
     segment-rigidly: frames between keyframes k and k+1 move by the
     correction of keyframe k.
  4. The MAP adopts the correction too (reintegrate_on_closure): the
     stored keyframe frames are re-fused into a reset volume at their
     optimized poses and the model prediction maps are re-raycast from
     the corrected current pose (KinFuSession._rebuild_map) — so
     extraction, PLY export and subsequent frame-to-model tracking are
     consistent with the corrected trajectory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from kinfu_tpu_torch.mapping.keyframes import Keyframe, KeyframeStore
from kinfu_tpu_torch.mapping.pose_graph import (
    PoseGraphEdge,
    optimize_pose_graph,
)


@dataclass
class LoopClosureConfig:
    #: candidate gate: metres between current pose and keyframe pose
    max_translation: float = 0.35
    #: candidate gate: degrees between viewing directions
    max_angle_deg: float = 35.0
    #: closure candidates must be at least this many keyframes old
    min_keyframe_gap: int = 4
    #: minimum ICP inlier fraction of image pixels to accept the closure
    min_inlier_frac: float = 0.05
    #: information weight of a closure edge relative to odometry
    closure_weight: float = 4.0
    #: frames to wait after a closure before detecting another
    cooldown_frames: int = 10
    #: keyframe selection gates (KeyframeStore)
    kf_min_translation: float = 0.10
    kf_min_rotation_deg: float = 10.0
    #: after a closure, re-integrate the stored keyframe frames into a
    #: reset volume at their corrected poses so the MAP (not just the
    #: reported trajectory) adopts the correction — without this the TSDF
    #: keeps the drifted geometry and post-closure raycast tracking,
    #: extraction and PLY export disagree with the corrected trajectory
    reintegrate_on_closure: bool = True


def _rel(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.inv(np.asarray(a, np.float64)) @ np.asarray(b, np.float64)


def _angle_deg(R: np.ndarray) -> float:
    return float(
        np.degrees(np.arccos(np.clip((np.trace(R[:3, :3]) - 1) / 2, -1.0, 1.0)))
    )


def find_candidate(
    store: KeyframeStore,
    cur_pose: np.ndarray,
    config: LoopClosureConfig,
) -> Optional[int]:
    """Index (into store.keyframes) of the best non-adjacent keyframe the
    current pose has returned to, or None."""
    n = len(store.keyframes)
    best, best_d = None, np.inf
    for i in range(n - config.min_keyframe_gap):
        kf = store.keyframes[i]
        rel = _rel(kf.pose, cur_pose)
        d = float(np.linalg.norm(rel[:3, 3]))
        if d > config.max_translation:
            continue
        if _angle_deg(rel) > config.max_angle_deg:
            continue
        if d < best_d:
            best, best_d = i, d
    return best


def correct_trajectory(
    pose_record: Sequence[np.ndarray],
    keyframes: List[Keyframe],
    optimized: List[np.ndarray],
) -> List[np.ndarray]:
    """Segment-rigid trajectory correction: every frame between keyframe k
    and k+1 moves by keyframe k's correction T_k_new @ T_k_old^-1. Frames
    before the first keyframe keep their pose (gauge: node 0 fixed)."""
    out = [np.asarray(p, np.float32).copy() for p in pose_record]
    n = len(out)
    for k, kf in enumerate(keyframes):
        corr = (
            np.asarray(optimized[k], np.float64)
            @ np.linalg.inv(np.asarray(kf.pose, np.float64))
        )
        end = keyframes[k + 1].index if k + 1 < len(keyframes) else n
        for f in range(min(kf.index, n), min(end, n)):
            out[f] = (corr @ out[f].astype(np.float64)).astype(np.float32)
    return out


def close_loop(
    store: KeyframeStore,
    pose_record: Sequence[np.ndarray],
    cand_idx: int,
    cur_pose: np.ndarray,
    z_closure: np.ndarray,
    config: LoopClosureConfig,
    device="cuda",
) -> Tuple[List[np.ndarray], np.ndarray, float]:
    """Optimize the keyframe graph with one closure edge and correct the
    trajectory.

    Nodes: keyframe poses ++ [current pose]. Edges: consecutive odometry
    (measured from the tracked trajectory) + the closure edge
    (cand_idx -> current) with `z_closure` = T_kf^-1 T_cur from ICP.
    Returns (corrected pose_record, corrected current pose, rms). The
    graph is optimized on `device` (mapping/pose_graph.py)."""
    kfs = store.keyframes
    nodes = [np.asarray(k.pose, np.float32) for k in kfs] + [
        np.asarray(cur_pose, np.float32)
    ]
    cur_node = len(nodes) - 1
    edges = []
    for k in range(len(kfs) - 1):
        z = _rel(kfs[k].pose, kfs[k + 1].pose).astype(np.float32)
        edges.append(PoseGraphEdge(k, k + 1, z, 1.0))
    z_last = _rel(kfs[-1].pose, cur_pose).astype(np.float32)
    edges.append(PoseGraphEdge(len(kfs) - 1, cur_node, z_last, 1.0))
    edges.append(
        PoseGraphEdge(
            cand_idx,
            cur_node,
            np.asarray(z_closure, np.float32),
            config.closure_weight,
        )
    )
    optimized, rms = optimize_pose_graph(nodes, edges, device=device)

    orig = [np.asarray(p, np.float64) for p in pose_record]
    corrected = correct_trajectory(pose_record, kfs, optimized[:-1])
    # frames after the last keyframe follow the CURRENT node's correction
    # (correct_trajectory assigned them the last keyframe's — override from
    # the original poses to avoid double-correcting)
    corr_cur = (
        np.asarray(optimized[-1], np.float64)
        @ np.linalg.inv(np.asarray(cur_pose, np.float64))
    )
    last_start = kfs[-1].index
    for f in range(min(last_start, len(corrected)), len(corrected)):
        corrected[f] = (corr_cur @ orig[f]).astype(np.float32)
    new_cur = (corr_cur @ np.asarray(cur_pose, np.float64)).astype(np.float32)

    # keyframe poses adopt their optimized values
    for k, kf in enumerate(kfs):
        kf.pose = np.asarray(optimized[k], np.float32)
    return corrected, new_cur, rms
