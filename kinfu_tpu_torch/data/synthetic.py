"""Analytic synthetic RGB-D scenes for tests and benchmarks (numpy-only copy
of kinfu_tpu/data/synthetic.py, on the port's Intrinsics).

The reference validates against a bundled PNG sequence plus a golden
trajectory (SURVEY.md section 4); that dataset is not redistributable, so the
test strategy here renders exact depth maps from closed-form geometry
(spheres, planes, boxes) along known trajectories — giving analytic ground
truth for the TSDF (signed distance is known everywhere), the raycast
(surface position known per ray), and ICP/trajectory tests (poses known).

Depth is *z-depth* (camera-frame z), matching real sensors and the
back-projection convention of image_process.cu:29-55.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np

from kinfu_tpu_torch.geometry.intrinsics import Intrinsics

# A primitive maps world-frame ray (origin [3], dirs [...,3]) to hit
# parameter s (z-depth multiplier), +inf for miss.
Primitive = Callable[[np.ndarray, np.ndarray], np.ndarray]


def sphere(center: Sequence[float], radius: float) -> Primitive:
    c = np.asarray(center, dtype=np.float64)

    def hit(o, d):
        oc = o - c
        a = np.sum(d * d, axis=-1)
        b = 2.0 * np.sum(d * oc, axis=-1)
        cc = np.sum(oc * oc) - radius * radius
        disc = b * b - 4 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        s1 = (-b - sq) / (2 * a)
        s2 = (-b + sq) / (2 * a)
        s = np.where(s1 > 1e-6, s1, s2)
        return np.where((disc >= 0) & (s > 1e-6), s, np.inf)

    return hit


def plane(point: Sequence[float], normal: Sequence[float]) -> Primitive:
    p0 = np.asarray(point, dtype=np.float64)
    n = np.asarray(normal, dtype=np.float64)
    n = n / np.linalg.norm(n)

    def hit(o, d):
        denom = np.sum(d * n, axis=-1)
        s = np.sum((p0 - o) * n) / np.where(np.abs(denom) < 1e-12, 1e-12, denom)
        return np.where((np.abs(denom) > 1e-12) & (s > 1e-6), s, np.inf)

    return hit


def box(lo: Sequence[float], hi: Sequence[float]) -> Primitive:
    """Hollow axis-aligned box seen from inside or outside (slab method)."""
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)

    def hit(o, d):
        safe = np.where(np.abs(d) < 1e-12, 1e-12, d)
        t1 = (lo - o) / safe
        t2 = (hi - o) / safe
        tmin = np.max(np.minimum(t1, t2), axis=-1)
        tmax = np.min(np.maximum(t1, t2), axis=-1)
        valid = tmax > np.maximum(tmin, 0)
        s = np.where(tmin > 1e-6, tmin, tmax)
        return np.where(valid & (s > 1e-6), s, np.inf)

    return hit


@dataclasses.dataclass
class SyntheticScene:
    primitives: List[Primitive]
    #: sdf(points [N,3]) -> signed distance; optional, for volume tests
    sdf: Callable[[np.ndarray], np.ndarray] | None = None

    def render_depth(
        self,
        pose_w_from_c: np.ndarray,
        intr: Intrinsics,
        max_depth: float = 10.0,
    ) -> np.ndarray:
        """Exact z-depth map [H, W] in metres for a world-from-camera pose."""
        T = np.asarray(pose_w_from_c, dtype=np.float64)
        R, t = T[:3, :3], T[:3, 3]
        v, u = np.mgrid[0 : intr.height, 0 : intr.width].astype(np.float64)
        dirs_cam = np.stack(
            [(u - intr.cx) / intr.fx, (v - intr.cy) / intr.fy, np.ones_like(u)],
            axis=-1,
        )
        dirs_w = dirs_cam @ R.T  # unit-z-depth directions in world frame
        s = np.full(u.shape, np.inf)
        for prim in self.primitives:
            s = np.minimum(s, prim(t, dirs_w))
        depth = np.where(np.isfinite(s) & (s <= max_depth), s, 0.0)
        return depth.astype(np.float32)

    def render_frame(
        self, pose_w_from_c: np.ndarray, intr: Intrinsics, depth_scale: float = 0.001
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(depth_raw [H,W] f32 in sensor units, color [H,W,3] u8)."""
        depth_m = self.render_depth(pose_w_from_c, intr)
        depth_raw = (depth_m / depth_scale).astype(np.float32)
        # simple depth-shaded grey + channel gradient as texture
        norm = np.clip(depth_m / 4.0, 0, 1)
        color = np.stack(
            [
                (norm * 255),
                ((1 - norm) * 255),
                np.full_like(norm, 128.0),
            ],
            axis=-1,
        ).astype(np.uint8)
        return depth_raw, color


def default_test_scene() -> SyntheticScene:
    """A sphere in front of two tilted planes inside the default 3 m volume.

    World frame: camera starts at origin looking +z; the default volume
    occupies x,y in [-1.5, 1.5], z in [0.5, 3.5] (kinectfusion.cpp:184).

    The geometry deliberately constrains all 6 DoF for ICP: a sphere alone
    leaves rotations about its centre unobservable and an axis-aligned plane
    leaves in-plane motion unobservable; the tilted-plane pair + sphere
    removes every such gauge freedom.
    """
    # Geometry notes (these choices are load-bearing for the ICP tests):
    #   - the sphere sits OFF the optical axis: centred on the axis, rotation
    #     about that axis is constrained only by the plane tilts
    #     (ill-conditioned normal equations)
    #   - sphere + a single visible plane still has an exact 1-DoF gauge
    #     (rotation about the line through the sphere centre parallel to the
    #     plane normal), so at least two non-parallel planes must actually be
    #     VISIBLE — the floor and wall are placed close enough that the back
    #     plane does not occlude them in a 640x480-style frustum.
    sphere_c = np.array([0.45, -0.25, 1.7])
    sphere_r = 0.4
    back_p = np.array([0.0, 0.0, 2.6])
    back_n = np.array([0.25, 0.1, -1.0])
    back_n = back_n / np.linalg.norm(back_n)
    floor_p = np.array([0.0, 0.5, 0.0])
    floor_n = np.array([0.05, -1.0, 0.1])
    floor_n = floor_n / np.linalg.norm(floor_n)
    wall_p = np.array([-0.85, 0.0, 0.0])
    wall_n = np.array([1.0, 0.0, -0.15])
    wall_n = wall_n / np.linalg.norm(wall_n)

    prims = [
        sphere(center=sphere_c, radius=sphere_r),
        plane(point=back_p, normal=back_n),
        plane(point=floor_p, normal=floor_n),
        plane(point=wall_p, normal=wall_n),
    ]

    def sdf(p):
        # union of solids: sphere + the half-spaces behind each plane.
        # all normals point into free space (toward the camera at the
        # origin), so the half-space signed distance is +((p - p0) . n).
        d_sphere = np.linalg.norm(p - sphere_c, axis=-1) - sphere_r
        d_back = np.sum((p - back_p) * back_n, axis=-1)
        d_floor = np.sum((p - floor_p) * floor_n, axis=-1)
        d_wall = np.sum((p - wall_p) * wall_n, axis=-1)
        return np.minimum(
            np.minimum(d_sphere, d_wall), np.minimum(d_back, d_floor)
        )

    return SyntheticScene(prims, sdf)


def make_translation_trajectory(
    n: int, step: Sequence[float] = (0.01, 0.0, 0.005)
) -> List[np.ndarray]:
    """Pure-translation camera path starting at identity."""
    poses = []
    for i in range(n):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = np.asarray(step, dtype=np.float32) * i
        poses.append(T)
    return poses


def make_orbit_trajectory(
    n: int,
    target: Sequence[float] = (0.0, 0.0, 1.8),
    angle_step_deg: float = 0.5,
    axis: str = "y",
) -> List[np.ndarray]:
    """Small orbit around a target point (keeps it centred in view)."""
    target = np.asarray(target, dtype=np.float64)
    poses = []
    for i in range(n):
        a = np.radians(angle_step_deg * i)
        ca, sa = np.cos(a), np.sin(a)
        if axis == "y":
            R = np.array([[ca, 0, sa], [0, 1, 0], [-sa, 0, ca]])
        else:
            R = np.array([[1, 0, 0], [0, ca, -sa], [0, sa, ca]])
        # rotate the camera centre about the target, keep looking at it
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = target - R @ target
        poses.append(T.astype(np.float32))
    return poses


def corner_test_scene(yaw_deg: float = 50.0) -> "SyntheticScene":
    """A trackable scene centred on the +z/+x cube-edge direction.

    Pairs with `yaw_trajectory`: a camera yawed `yaw_deg` about y sees a
    sphere + two tilted planes along that direction, all inside the
    default 3 m volume — the frustum straddles the +z/+x cube edge, so the
    JAX fused step's multi-face CHAIN branch runs every frame
    (kinfu_tpu/ops/fused_step.py branch 6; tools/hw_bisect.py --corner)."""
    a = np.deg2rad(yaw_deg)
    d = np.array([np.sin(a), 0.0, np.cos(a)])
    back_n = -d + np.array([0.1, 0.05, 0.0])
    back_n = back_n / np.linalg.norm(back_n)
    floor_n = np.array([0.05, -1.0, 0.1])
    floor_n = floor_n / np.linalg.norm(floor_n)
    return SyntheticScene(
        [
            sphere(center=d * 1.4 + np.array([0.0, -0.1, 0.0]), radius=0.4),
            plane(point=d * 2.4, normal=back_n),
            plane(point=np.array([0.0, 0.5, 0.0]), normal=floor_n),
        ]
    )


def yaw_trajectory(
    traj: List[np.ndarray], yaw_deg: float = 50.0
) -> List[np.ndarray]:
    """Yaw every pose of a trajectory about the camera y axis."""
    a = np.deg2rad(yaw_deg)
    Ry = np.eye(4, dtype=np.float32)
    Ry[:3, :3] = np.array(
        [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]],
        np.float32,
    )
    return [T @ Ry for T in traj]
