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
back once per frame.

Two modes of the JAX session add mapping (mapping/):
  - relocalize=True keeps the map through a tracking loss and tries to
    re-acquire it from the nearest keyframe's pose (`relocalize_step`)
    before it gives up and wipes;
  - pose_graph=True keeps keyframes with their model maps and frames,
    detects a return to a non-adjacent keyframe, registers the frame
    against it by ICP, optimizes the keyframe graph and corrects the
    trajectory, then rebuilds the map at the corrected poses.
Both run the integrate and raycast dispatchers (`volume/`), which on the
card launch K2-K5. A third, streaming=True, runs the camera-following
volume (`pipeline/streaming.py`): the grid shifts by whole voxels to keep
the view ahead of the camera inside it, for corridor-scale sequences. Its
state is a `StreamingState` (the step's state in `.kinfu`, the grid's
offset in `.origin_vox`); it excludes relocalization and the pose graph,
as in the JAX package.

On the card, a session with neither relocalization nor the pose graph
whose volume takes the fused update (`pipeline/graphed.py::graphed_ok`:
the plain and the streaming session) replays its step from CUDA graphs
after its first frames (`GraphedStep`): its state tensors, and the device
buffers each frame is uploaded into, keep their addresses for the whole
session, and `reset()` resets them in place.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant, resolve_device
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import compose, inverse, pose_from_matrix, pose_matrix
from kinfu_tpu_torch.mapping.keyframes import KeyframeStore
from kinfu_tpu_torch.mapping.loop_closure import LoopClosureConfig, close_loop, find_candidate
from kinfu_tpu_torch.mapping.relocalize import Relocalizer, TrackingStatus
from kinfu_tpu_torch.pipeline.graphed import GraphedStep, graphed_ok, reset_state_
from kinfu_tpu_torch.pipeline.kinfu import (
    _measurement,
    _model_pyramid,
    _volume_pose,
    init_state,
    make_step_fn,
    relocalize_step,
)
from kinfu_tpu_torch.pipeline.render import render_normals, render_phong
from kinfu_tpu_torch.pipeline.streaming import (
    _vol_pose_dyn,
    init_streaming_state,
    make_streaming_step_fn,
)
from kinfu_tpu_torch.tracking.icp import rigid_icp
from kinfu_tpu_torch.utils.profiling import span
from kinfu_tpu_torch.volume.extract import extract_points, extract_points_colored
from kinfu_tpu_torch.volume.integrate import integrate
from kinfu_tpu_torch.volume.raycast import raycast
from kinfu_tpu_torch.volume.tsdf import reset_volume


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
        loop_config=None,
    ):
        if streaming and relocalize:
            raise ValueError("streaming + relocalize not supported together")
        self.intr = intr
        self.params = params or KinFuParams()
        self.device = resolve_device(device)
        self.streaming = streaming
        if streaming:
            # camera-following moving volume; the reference's grid is fixed
            # in space (kinectfusion.cpp:181-184)
            self.state = init_streaming_state(self.params, intr, device=self.device)
            self._step = make_streaming_step_fn(self.params, intr)
        else:
            self.state = init_state(self.params, intr, device=self.device)
            # with relocalization on, a tracking failure keeps the map (the
            # relocalizer owns recovery); otherwise the reference's
            # auto-reset
            self._step = make_step_fn(self.params, intr, auto_reset=not relocalize)
        self.relocalizer = None
        self.keyframes = None
        if relocalize:
            self.relocalizer = Relocalizer(num_pixels=intr.width * intr.height)
            self.keyframes = KeyframeStore()
        # ---- pose graph / loop closure (mapping/loop_closure.py) ----
        self.pose_graph = pose_graph and not streaming
        # ---- the step replayed from CUDA graphs (pipeline/graphed.py) ----
        self._graphed = graphed_ok(self.device, self._kinfu.vol.tsdf.shape, self.params,
                                   relocalize, self.pose_graph)
        if self._graphed:
            self._step = GraphedStep(self._step)
        self._inputs = None
        self.loop_closures: List[dict] = []
        if self.pose_graph:
            self.loop_config = loop_config or LoopClosureConfig()
            self.pg_keyframes = KeyframeStore(
                min_translation=self.loop_config.kf_min_translation,
                min_rotation_deg=self.loop_config.kf_min_rotation_deg,
            )
            self._pg_cooldown = 0
        self.pose_record: List[np.ndarray] = [np.eye(4, dtype=np.float32)]
        self.frame_count = 1
        self._calls = 0
        self.last_icp_inliers = 0
        self._points_cache: Optional[np.ndarray] = None

    @property
    def _kinfu(self):
        """The step's `KinFuState` (`state.kinfu` in streaming mode)."""
        return self.state.kinfu if self.streaming else self.state

    def _volume(self):
        """(volume, world-from-volume pose) of the grid as it is placed."""
        if self.streaming:
            return self.state.kinfu.vol, _vol_pose_dyn(self.params, self.state.origin_vox)
        return self.state.vol, _volume_pose(self.params, self.device)

    def _tensor(self, a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
        """A host array on the session's device (the copy waits for nothing
        on the card)."""
        return constant(np.asarray(a), dtype, self.device)

    def pipeline(self, color_rgb: np.ndarray, depth_mm: np.ndarray) -> bool:
        """Process one frame (numpy colour [H,W,3] uint8, depth [H,W] in
        mm); returns tracking success. Parity: kinectfusion::pipeline
        (kinectfusion.cpp:78-131). While a profiler records, the call is
        the span `kinfu.session.pipeline` (args: the call's number in this
        session as "frame"), holding `kinfu.session.upload`, `.step` and
        `.fetch`."""
        self._calls += 1
        with span("kinfu.session.pipeline", frame=self._calls):
            with span("kinfu.session.upload"):
                depth, color = self._upload(depth_mm, color_rgb)
            with span("kinfu.session.step"):
                self.state, out = self._step(self.state, depth, color)
            with span("kinfu.session.fetch"):
                pose_m = out.pose_matrix.cpu().numpy()
                ok = bool(out.tracking_ok)
                self.last_icp_inliers = int(out.icp_inliers)
            # a new frame changes the volume: save_pointcloud extracts again
            # (the JAX session would write a cloud extracted before this frame)
            self._points_cache = None

            if not ok and self.relocalizer is not None:
                ok, pose_m = self._try_relocalize(depth, color)

            if ok:
                if self.frame_count >= 2:
                    self.pose_record.append(pose_m)
                self.frame_count += 1
                if self.keyframes is not None:
                    self.keyframes.maybe_add(self.frame_count, pose_m)
                if self.pose_graph:
                    pose_m = self._pose_graph_update(depth, color, pose_m)
            elif self.relocalizer is None:
                # reference parity: the step has already reset the device state
                self.pose_record = [np.eye(4, dtype=np.float32)]
                self.frame_count = 1
                self._clear_pose_graph()
            return ok

    def _upload(self, depth_mm: np.ndarray, color_rgb: np.ndarray):
        """The frame on the session's device: float32 depth [H,W] and uint8
        colour [H,W,3]. A graphed step reads them from buffers allocated at
        the first frame, which each frame is copied into."""
        depth = np.asarray(depth_mm, dtype=np.float32)
        color = np.asarray(color_rgb, dtype=np.uint8)
        if not self._graphed:
            return (torch.as_tensor(depth, device=self.device),
                    torch.as_tensor(color, device=self.device))
        host = (torch.as_tensor(depth), torch.as_tensor(color))
        if self._inputs is None:
            self._inputs = tuple(torch.empty_like(t, device=self.device) for t in host)
        for buf, t in zip(self._inputs, host):
            buf.copy_(t)
        return self._inputs

    def _clear_pose_graph(self) -> None:
        """A map wipe invalidates every keyframe (their poses live in the
        discarded coordinate frame): clear them, or a later closure would
        correct the fresh trajectory against stale geometry."""
        if self.pose_graph:
            self.pg_keyframes.keyframes.clear()
            self._pg_cooldown = 0

    def _closure_icp(self, cur_v, cur_n, kf_v, kf_n, z0: np.ndarray):
        """ICP of the current measurement against a keyframe's stored model
        maps, seeded with the drifted relative estimate z0 = T_kf^-1 T_cur
        (ICP's 15 mm gate cannot associate across the raw revisit offset):
        the current maps are pre-transformed by z0, ICP estimates the
        residual increment, and Z = inc @ z0. Zero-normal (invalid) pixels
        stay masked under the rotation. Returns (Z 4x4 on the device, ok,
        inliers)."""
        z0_t = self._tensor(z0, torch.float32)
        R0, t0 = z0_t[:3, :3], z0_t[:3, 3]
        cv = tuple(v @ R0.T + t0 for v in cur_v)
        cn = tuple(n @ R0.T for n in cur_n)
        res = rigid_icp(cv, cn, kf_v, kf_n, self.intr, self.params)
        return pose_matrix(res.pose) @ z0_t, res.ok, res.num_inliers

    def _pose_graph_update(self, depth, color, pose_m: np.ndarray) -> np.ndarray:
        """Keyframe bookkeeping and loop-closure detection and correction
        for one tracked frame. Returns the (possibly corrected) current
        pose. The pose graph is off in streaming mode, so `self.state` is a
        plain `KinFuState`."""
        ks = self.state
        cur_index = len(self.pose_record) - 1
        if self._pg_cooldown > 0:
            self._pg_cooldown -= 1
        else:
            cand = find_candidate(self.pg_keyframes, pose_m, self.loop_config)
            if cand is not None:
                kf = self.pg_keyframes.keyframes[cand]
                _, cur_v, cur_n = _measurement(depth, self.params, self.intr)
                z0 = np.linalg.inv(kf.pose.astype(np.float64)) @ pose_m.astype(np.float64)
                z, ok, ninl = self._closure_icp(
                    cur_v, cur_n,
                    tuple(self._tensor(v, torch.float32) for v in kf.vmaps),
                    tuple(self._tensor(n, torch.float32) for n in kf.nmaps),
                    z0.astype(np.float32),
                )
                thresh = self.loop_config.min_inlier_frac * (self.intr.width * self.intr.height)
                if bool(ok) and int(ninl) >= thresh:
                    corrected, new_cur, rms = close_loop(
                        self.pg_keyframes, self.pose_record, cand, pose_m,
                        z.cpu().numpy(), self.loop_config, device=self.device)
                    self.pose_record = corrected
                    pose_m = new_cur
                    self.pose_record[cur_index] = new_cur
                    if self.loop_config.reintegrate_on_closure:
                        # the map adopts the correction too: re-fuse the
                        # stored keyframe frames at their optimized poses
                        # (close_loop has updated kf.pose in place)
                        self._rebuild_map(depth, color, new_cur)
                    else:
                        self.state = self.state._replace(
                            pose=pose_from_matrix(self._tensor(new_cur, torch.float32)))
                    self.loop_closures.append({
                        "frame": cur_index,
                        "keyframe": int(kf.index),
                        "inliers": int(ninl),
                        "rms": rms,
                    })
                    self._pg_cooldown = self.loop_config.cooldown_frames

        self.pg_keyframes.maybe_add(
            cur_index,
            pose_m,
            vmaps=tuple(v.cpu().numpy() for v in ks.model_vmaps),
            nmaps=tuple(n.cpu().numpy() for n in ks.model_nmaps),
            # copies: on the CPU the frame tensors share the caller's arrays
            depth=depth.cpu().numpy().copy(),
            color=color.cpu().numpy().copy(),
        )
        return pose_m

    def _rebuild_map(self, depth, color, new_cur: np.ndarray) -> None:
        """Re-integrate the stored keyframe frames (then the current frame)
        into the reset volume at their corrected poses, then rebuild the
        model maps by raycasting from the corrected current pose, so that
        tracking, extraction and export after a closure agree with the
        corrected trajectory. Keyframes without frames are skipped, as in
        the JAX session. On the card each frame is one launch of K2 and the
        sweeps of K3, and the raycast K4 and K5."""
        p, intr = self.params, self.intr
        vol_pose = _volume_pose(p, self.device)
        vol = reset_volume(self.state.vol)

        def fuse(depth_t, color_t, pose_t):
            dmaps, _, _ = _measurement(depth_t, p, intr)
            vol2cam = compose(inverse(pose_from_matrix(pose_t)), vol_pose)
            integrate(vol, dmaps[0], color_t, vol2cam, intr, p)

        for kf in self.pg_keyframes.keyframes:
            if kf.depth is None:
                continue
            fuse(self._tensor(kf.depth, torch.float32), self._tensor(kf.color, torch.uint8),
                 self._tensor(kf.pose, torch.float32))
        cur = self._tensor(new_cur, torch.float32)
        fuse(torch.as_tensor(depth, dtype=torch.float32, device=self.device),
             torch.as_tensor(color, dtype=torch.uint8, device=self.device), cur)
        cur_pose = pose_from_matrix(cur)
        rv, rn = raycast(vol, compose(inverse(vol_pose), cur_pose), intr, p)
        mv, mn = _model_pyramid(rv, rn, p.pyramid_height)
        self.state = self.state._replace(vol=vol, model_vmaps=mv, model_nmaps=mn,
                                         pose=cur_pose)

    def _try_relocalize(self, depth, color):
        """Try to re-acquire the kept map from a keyframe seed pose; wipe
        everything only after the relocalizer gives up (the reference wipes
        at once, kinectfusion.cpp:97-102)."""
        status = self.relocalizer.on_frame(False, self.last_icp_inliers)
        if status is TrackingStatus.LOST and len(self.keyframes or []) > 0:
            seed = self.keyframes.nearest(self.pose_record[-1]).pose
            self.state, out = relocalize_step(self.state, depth, color, seed,
                                              self.params, self.intr)
            ok = bool(out.tracking_ok)
            self.last_icp_inliers = int(out.icp_inliers)
            if ok:
                status = self.relocalizer.on_frame(True, self.last_icp_inliers)
                if status is TrackingStatus.OK:
                    return True, out.pose_matrix.cpu().numpy()
            return False, out.pose_matrix.cpu().numpy()
        if status is TrackingStatus.RESET:
            self.reset()
        return False, np.eye(4, dtype=np.float32)

    def reset(self) -> None:
        if self._graphed:
            # in place: the graphs hold the state's addresses
            reset_state_(self.state)
        elif self.streaming:
            self.state = init_streaming_state(self.params, self.intr, device=self.device)
        else:
            self.state = init_state(self.params, self.intr, device=self.device)
        self.pose_record = [np.eye(4, dtype=np.float32)]
        self.frame_count = 1
        self._points_cache = None
        self._clear_pose_graph()

    def get_render_map(self, mode: str = PHONG) -> np.ndarray:
        """[H, W, 3] uint8 view of the model maps: Phong-shaded or normals."""
        st = self._kinfu
        if mode == self.NORMAL:
            img = render_normals(st.model_nmaps[0])
        else:
            img = render_phong(st.pose.t, st.model_vmaps[0], st.model_nmaps[0])
        return img.cpu().numpy()

    def get_cur_camera_pose(self) -> np.ndarray:
        return self.pose_record[-1]

    def extract_pointcloud(self) -> np.ndarray:
        pts, count = extract_points(*self._volume(), self.params)
        self._points_cache = pts[: int(count)].cpu().numpy()
        return self._points_cache

    def save_pointcloud(self, path: str) -> None:
        from kinfu_tpu_torch.io.ply import write_ply

        pts = self._points_cache if self._points_cache is not None else self.extract_pointcloud()
        write_ply(path, pts)

    def extract_pointcloud_colored(self):
        """(points [n,3], colours uint8 [n,3]): the coloured variant of
        extract_pointcloud (the reference extracts xyz only)."""
        pts, cols, count = extract_points_colored(*self._volume(), self.params)
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
            volume_pose=pose_matrix(self._volume()[1]).cpu().numpy(),
            volume_extent=self.params.volume_range,
            **kwargs,
        )

    def save_3d(self, path: str, **kwargs) -> None:
        """Write `render_3d(**kwargs)` as an 8-bit RGB PNG."""
        from kinfu_tpu_torch.io.images import write_color_png

        write_color_png(path, self.render_3d(**kwargs))

    def save_poses(self, path: str) -> None:
        """Write the trajectory in the reference's poses.txt format
        (main.cpp:95-98 / doc/poses.txt)."""
        from kinfu_tpu_torch.io.poses import write_poses_reference_format

        write_poses_reference_format(path, self.pose_record)
