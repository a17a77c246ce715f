"""Offline 3D map view: point cloud, volume cube, trajectory and camera
frustum (numpy-only copy of kinfu_tpu/pipeline/viz3d.py).

The headless counterpart of the reference's live cv::viz window
(main.cpp:82-86; golden image doc/3D.png): a z-buffered point splat of the
extracted (optionally coloured) cloud, the volume cube wireframe, the
trajectory polyline and the current camera frustum, projected from a
configurable viewpoint into an RGB image. Pure numpy.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# wireframe colours (RGB)
_CUBE_RGB = (90, 90, 110)
_TRAJ_RGB = (240, 200, 60)
_FRUSTUM_RGB = (80, 220, 100)
_BG_TOP = np.array([24, 26, 34], np.float32)
_BG_BOT = np.array([44, 48, 62], np.float32)


def _normalize(v):
    return v / max(np.linalg.norm(v), 1e-12)


def look_at(eye: np.ndarray, target: np.ndarray, up=(0.0, -1.0, 0.0)):
    """World->view rotation with the pipeline's camera convention
    (+z forward, +x right, +y down; `up` is the world up direction, -y by
    default to match the sensor frame)."""
    eye = np.asarray(eye, np.float64)
    fwd = _normalize(np.asarray(target, np.float64) - eye)
    up = np.asarray(up, np.float64)
    right = _normalize(np.cross(up, fwd) * -1.0)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])  # rows: view x, y, z in world coords
    return R, eye


def _project(R, eye, pts, f, cx, cy):
    pc = (pts - eye) @ R.T
    z = pc[:, 2]
    ok = z > 1e-6
    zs = np.where(ok, z, 1.0)
    u = pc[:, 0] / zs * f + cx
    v = pc[:, 1] / zs * f + cy
    return u, v, z, ok


def _draw_polyline(img, R, eye, f, cx, cy, pts, color, samples_per_seg=120):
    h, w = img.shape[:2]
    pts = np.asarray(pts, np.float64)
    if len(pts) < 2:
        return
    t = np.linspace(0.0, 1.0, samples_per_seg)[:, None]
    seg = pts[:-1][:, None, :] * (1 - t)[None] + pts[1:][:, None, :] * t[None]
    u, v, z, ok = _project(R, eye, seg.reshape(-1, 3), f, cx, cy)
    ui = np.rint(u).astype(np.int64)
    vi = np.rint(v).astype(np.int64)
    keep = ok & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
    img[vi[keep], ui[keep]] = color
    # 1px thickening for visibility
    keep2 = keep & (vi + 1 < h)
    img[vi[keep2] + 1, ui[keep2]] = color


def render_3d_view(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    trajectory: Optional[Sequence[np.ndarray]] = None,
    cur_pose: Optional[np.ndarray] = None,
    volume_pose: Optional[np.ndarray] = None,
    volume_extent: Optional[Tuple[float, float, float]] = None,
    width: int = 960,
    height: int = 720,
    eye: Optional[np.ndarray] = None,
    target: Optional[np.ndarray] = None,
    fov_deg: float = 55.0,
    point_px: int = 2,
    frustum_depth: float = 0.4,
    frustum_aspect: Tuple[float, float] = (0.52, 0.4),
) -> np.ndarray:
    """Render the reconstruction overview to an RGB u8 [height, width, 3].

    points: [N,3] world-frame cloud (as from extract_points); zero-padded
    tails are fine (a point exactly at the origin is dropped only if it is
    a pad — callers should slice to the true count). colors: optional
    [N,3] u8. trajectory: sequence of 4x4 world-from-camera poses (their
    translations draw the path). cur_pose: 4x4 whose frustum is drawn.
    volume_pose + volume_extent (metres) draw the TSDF cube wireframe.
    eye/target default to an oblique overview of the volume.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)

    # scene bounds drive the default viewpoint
    if volume_pose is not None and volume_extent is not None:
        T = np.asarray(volume_pose, np.float64)
        ex = np.asarray(volume_extent, np.float64)
        corners01 = np.array(
            [[i, j, k] for i in (0, 1) for j in (0, 1) for k in (0, 1)],
            np.float64,
        )
        cube = corners01 * ex @ T[:3, :3].T + T[:3, 3]
        centre = cube.mean(axis=0)
        radius = float(np.linalg.norm(ex) / 2)
    else:
        cube = None
        finite = pts[np.isfinite(pts).all(axis=1)]
        centre = finite.mean(axis=0) if len(finite) else np.zeros(3)
        radius = (
            float(np.percentile(np.linalg.norm(finite - centre, axis=1), 95))
            if len(finite)
            else 1.0
        )

    if target is None:
        target = centre
    if eye is None:
        # above-left-behind overview, like the reference's doc/3D.png
        eye = centre + np.array([-1.1, -0.9, -1.35]) * radius

    R, eye = look_at(eye, target)
    f = (width / 2) / np.tan(np.deg2rad(fov_deg) / 2)
    cx, cy = (width - 1) / 2, (height - 1) / 2

    # background: vertical gradient
    g = np.linspace(0.0, 1.0, height, dtype=np.float32)[:, None, None]
    img = (_BG_TOP * (1 - g) + _BG_BOT * g).astype(np.uint8)
    img = np.broadcast_to(img, (height, width, 3)).copy()

    # ---- point splat (z-buffer via far-to-near ordered writes) ----
    u, v, z, ok = _project(R, eye, pts, f, cx, cy)
    ui = np.rint(u).astype(np.int64)
    vi = np.rint(v).astype(np.int64)
    keep = (
        ok
        & (ui >= 0)
        & (ui < width - point_px + 1)
        & (vi >= 0)
        & (vi < height - point_px + 1)
        & np.isfinite(z)
    )
    # drop zero-pad tail (exact origin)
    keep &= ~np.all(pts == 0.0, axis=1)
    idx = np.nonzero(keep)[0]
    order = idx[np.argsort(-z[idx])]  # far first; near overwrites
    if colors is not None:
        cols = np.asarray(colors, np.uint8).reshape(-1, 3)[order]
    else:
        # depth-shaded two-tone (near = light teal, far = deep blue)
        zn = z[order]
        lo, hi = (np.percentile(zn, 5), np.percentile(zn, 95)) if len(zn) else (0, 1)
        t = np.clip((zn - lo) / max(hi - lo, 1e-9), 0, 1)[:, None]
        near_c = np.array([170, 230, 225], np.float32)
        far_c = np.array([60, 90, 160], np.float32)
        cols = (near_c * (1 - t) + far_c * t).astype(np.uint8)
    uo, vo = ui[order], vi[order]
    for di in range(point_px):
        for dj in range(point_px):
            img[vo + di, uo + dj] = cols

    # ---- volume cube wireframe ----
    if cube is not None:
        edges = [
            (a, b)
            for a in range(8)
            for b in range(a + 1, 8)
            if bin(a ^ b).count("1") == 1
        ]
        for a, b in edges:
            _draw_polyline(img, R, eye, f, cx, cy, [cube[a], cube[b]], _CUBE_RGB)

    # ---- trajectory ----
    if trajectory is not None and len(trajectory) >= 2:
        path = np.stack([np.asarray(T, np.float64)[:3, 3] for T in trajectory])
        _draw_polyline(img, R, eye, f, cx, cy, path, _TRAJ_RGB)

    # ---- current camera frustum ----
    if cur_pose is not None:
        T = np.asarray(cur_pose, np.float64)
        c = T[:3, 3]
        ax, ay = frustum_aspect
        for sx in (-1, 1):
            for sy in (-1, 1):
                d = T[:3, :3] @ np.array([sx * ax, sy * ay, 1.0])
                _draw_polyline(
                    img, R, eye, f, cx, cy, [c, c + d * frustum_depth],
                    _FRUSTUM_RGB,
                )
        quad = [
            c + T[:3, :3] @ np.array([sx * ax, sy * ay, 1.0]) * frustum_depth
            for sx, sy in ((-1, -1), (-1, 1), (1, 1), (1, -1), (-1, -1))
        ]
        _draw_polyline(img, R, eye, f, cx, cy, quad, _FRUSTUM_RGB)

    return img
