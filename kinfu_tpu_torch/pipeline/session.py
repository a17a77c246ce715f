"""Host-side session: the API a user of the reference expects (port of
kinfu_tpu/pipeline/session.py, its base mode).

Maps one for one onto `kf::kinectfusion` (kinectfusion.h:31-73):

  reference                      here
  -------------------------------------------------------
  pipeline(color, depth)         KinFuSession.pipeline(color, depth)
  reset()                        KinFuSession.reset()
  getRenderMap(PHONG|NORMAL)     KinFuSession.get_render_map(...)
  extracePointcloud()            KinFuSession.extract_pointcloud()
  savePointcloud(path)           KinFuSession.save_pointcloud(path)
  getCurCameraPose()             KinFuSession.get_cur_camera_pose()
  frame_count / pose_record      KinFuSession.frame_count / .pose_record

Every frame runs `kinfu_step` on `device` (the card unless the caller asks
for the CPU): on CUDA the fused step with the ICP kernel K1 and the fusion
and raycast kernels K2-K5. The session keeps the pose history and the
frame counter on the host, reading the step's pose, flag and inlier count
back once per frame. Relocalization, the streaming volume and the pose
graph are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import resolve_device
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.pipeline.kinfu import _volume_pose, init_state, make_step_fn
from kinfu_tpu_torch.pipeline.render import render_normals, render_phong
from kinfu_tpu_torch.volume.extract import extract_points, extract_points_colored


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP.md queue 1, {item}")


class KinFuSession:
    PHONG = "phong"
    NORMAL = "normal"

    def __init__(
        self,
        intr: Intrinsics,
        params: Optional[KinFuParams] = None,
        device="cuda",
        relocalize: bool = False,
        streaming: bool = False,
        pose_graph: bool = False,
    ):
        if relocalize:
            raise _not_ported("relocalize=True (keyframes and the relocalizer)", "item 10")
        if pose_graph:
            raise _not_ported("pose_graph=True (loop closure and the pose graph)", "item 10")
        if streaming:
            raise _not_ported("streaming=True (the streaming volume)", "item 11")
        self.intr = intr
        self.params = params or KinFuParams()
        self.device = resolve_device(device)
        self.state = init_state(self.params, intr, device=self.device)
        self._step = make_step_fn(self.params, intr)
        self.pose_record: List[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self.frame_count = 1
        self.frame_times_ms: List[float] = []
        self.last_icp_inliers = 0
        self._points_cache: Optional[np.ndarray] = None

    def pipeline(self, color_rgb: np.ndarray, depth_mm: np.ndarray) -> bool:
        """Process one frame (numpy colour [H,W,3] uint8, depth [H,W] in
        mm); returns tracking success. Parity: kinectfusion::pipeline
        (kinectfusion.cpp:78-131), with the per-frame wall-clock time."""
        t0 = time.perf_counter()
        depth = torch.as_tensor(np.asarray(depth_mm, dtype=np.float32), device=self.device)
        color = torch.as_tensor(np.asarray(color_rgb, dtype=np.uint8), device=self.device)
        self.state, out = self._step(self.state, depth, color)
        pose_m = out.pose_matrix.cpu().numpy()
        ok = bool(out.tracking_ok)
        self.last_icp_inliers = int(out.icp_inliers)
        # a new frame changes the volume: save_pointcloud extracts again
        # (the JAX session would write a cloud extracted before this frame)
        self._points_cache = None
        if ok:
            if self.frame_count >= 2:
                self.pose_record.append(pose_m)
            self.frame_count += 1
        else:
            # reference parity: the step has already reset the device state
            self.pose_record = [np.eye(4, dtype=np.float32)]
            self.frame_count = 1
        self.frame_times_ms.append((time.perf_counter() - t0) * 1e3)
        return ok

    def reset(self) -> None:
        self.state = init_state(self.params, self.intr, device=self.device)
        self.pose_record = [np.eye(4, dtype=np.float32)]
        self.frame_count = 1
        self._points_cache = None

    def get_render_map(self, mode: str = PHONG) -> np.ndarray:
        """[H, W, 3] uint8 view of the model maps: Phong-shaded or normals."""
        st = self.state
        if mode == self.NORMAL:
            img = render_normals(st.model_nmaps[0])
        else:
            img = render_phong(st.pose.t, st.model_vmaps[0], st.model_nmaps[0])
        return img.cpu().numpy()

    def get_cur_camera_pose(self) -> np.ndarray:
        return self.pose_record[-1]

    def extract_pointcloud(self) -> np.ndarray:
        pts, count = extract_points(self.state.vol, _volume_pose(self.params, self.device),
                                    self.params)
        self._points_cache = pts[: int(count)].cpu().numpy()
        return self._points_cache

    def save_pointcloud(self, path: str) -> None:
        from kinfu_tpu_torch.io.ply import write_ply

        pts = self._points_cache if self._points_cache is not None else self.extract_pointcloud()
        write_ply(path, pts)

    def extract_pointcloud_colored(self):
        """(points [n,3], colours uint8 [n,3]): the coloured variant of
        extract_pointcloud (the reference extracts xyz only)."""
        pts, cols, count = extract_points_colored(
            self.state.vol, _volume_pose(self.params, self.device), self.params)
        n = int(count)
        return pts[:n].cpu().numpy(), cols[:n].cpu().numpy()

    def render_3d(self, **kwargs) -> np.ndarray:
        """Offline 3D overview (cloud, volume cube, trajectory, frustum): the
        headless counterpart of the reference's cv::viz window
        (main.cpp:82-86). kwargs go to viz3d.render_3d_view."""
        from kinfu_tpu_torch.pipeline.viz3d import render_3d_view

        pts, cols = self.extract_pointcloud_colored()
        return render_3d_view(
            pts,
            colors=cols if len(cols) else None,
            trajectory=self.pose_record,
            cur_pose=self.pose_record[-1],
            volume_pose=np.asarray(self.params.volume_pose),
            volume_extent=self.params.volume_range,
            **kwargs,
        )

    def save_3d(self, path: str, **kwargs) -> None:
        raise NotImplementedError(
            "save_3d needs the PNG writer of io/images.py, which comes with the data "
            "loaders and the CLI: ROADMAP.md queue 1, item 9. render_3d() returns the "
            "image as an array.")

    def save_poses(self, path: str) -> None:
        """Write the trajectory in the reference's poses.txt format
        (main.cpp:95-98 / doc/poses.txt)."""
        from kinfu_tpu_torch.io.poses import write_poses_reference_format

        write_poses_reference_format(path, self.pose_record)
