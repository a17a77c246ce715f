"""The least device time of a frame's work: the bytes its ICP, fusion
and raycast must move and the float32 operations they must do, counted
from the frame's sizes and from the pixels and voxels its work needs (as
the reference works them out on the frame), whatever implements them.

Peaks: NVIDIA H100 SXM (data sheet), HBM 3.35 TB/s, float32 outside the
tensor cores 67 TFLOP/s, at the card's full 700 W. Operations per work
item are the port's published counts (chip_smoke.py OPS): 150 per
current pixel and ICP iteration, 24 per voxel a frame updates, 20 per
voxel whose colour it mixes, 15 per raycast step.

Bytes, each counted once:
  - measurement: the float32 depth read, and a vertex and a normal map
    (24 B a pixel) written at every level;
  - ICP: at every level the current and the model maps (48 B a pixel)
    read;
  - fusion: 8 B read and written (TSDF and weight) for each voxel the
    frame updates, 8 B more where it mixes the colour (`fuse_counts`);
  - raycast: 2 B for each distinct voxel that a ray samples before it
    reaches the surface the frame observes at its pixel, or leaves the
    volume where the frame observes none; the vertex and normal maps
    written (24 B a pixel), and the model maps of the coarser levels.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from kfbench.reference import kinfu as K

HBM_BPS = 3.35e12
F32_FLOPS = 67e12
OPS = {"icp_pixel_iteration": 150, "fuse_update": 24, "fuse_colour": 20, "raycast_step": 15}


def origins(st, pose_record: List[np.ndarray]) -> List:
    """The grid's origin after each frame of a session's pose record (the
    bootstrap frame first), by the reference's rule; None on a fixed
    grid."""
    if st.margin is None:
        return [None] * len(pose_record)
    from kfbench.reference.compare import _shift_of

    o = torch.zeros(3, dtype=torch.int64)
    out = [o]
    for T in pose_record[1:]:
        o = o + _shift_of(st, torch.as_tensor(np.asarray(T), dtype=torch.float32), o)
        out.append(o)
    return out


def ray_voxels(depth_m, cam2vol, st) -> tuple:
    """(distinct voxels sampled, samples) of the frame's raycast: unit
    steps from where each ray enters the box to the observed surface's
    range, or to where it leaves the box."""
    g, cam = st.grid, st.cam
    dev = depth_m.device
    dt = torch.float32
    X, Y, Z = g.dims
    vox = torch.tensor(g.voxel, dtype=dt, device=dev)
    box = torch.tensor([X * g.voxel[0], Y * g.voxel[1], Z * g.voxel[2]], dtype=dt, device=dev)
    org, dirs = K.camera_rays(cam2vol, cam, dt)
    tn, tf = K.ray_box(org, dirs, box)
    u, v = K._pixel_grid(cam, dt, dev)
    lam = torch.sqrt(((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2 + 1.0)
    rng = depth_m * lam
    t0 = torch.clamp(tn, min=0.0) + g.voxel[0]
    t_end = torch.where(rng > 0, torch.minimum(rng, tf), tf)
    seen = torch.zeros(Z * Y * X, dtype=torch.bool, device=dev)
    samples = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(math.ceil(math.sqrt(sum((d * s) ** 2 for d, s in zip(g.dims, g.voxel)))
                          / g.voxel[0])) + 2
    for k in range(steps):
        t = t0 + k * g.voxel[0]
        live = t < t_end
        p = torch.round((org + dirs * t[..., None]) / vox).long()
        inb = live & (p >= 0).all(-1) & (p[..., 0] < X) & (p[..., 1] < Y) & (p[..., 2] < Z)
        seen[((p[..., 2] * Y + p[..., 1]) * X + p[..., 0])[inb]] = True
        samples += live.sum()
    return int(seen.sum()), int(samples)


def frame_work(st, depth_mm: np.ndarray, pose: np.ndarray, origin) -> dict:
    """{"bytes", "ops"} of one frame's work, from its raw depth, the
    world-from-camera pose it was fused at, and its grid's origin."""
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    cam, cfg = st.cam, st.cfg
    ds, _, _ = K.measurement(torch.as_tensor(depth_mm.astype(np.float32), device=dev), cam, cfg,
                             torch.float32)
    T = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=dev)
    vp = st.vol_pose(origin, dev)
    n_upd, n_col = K.fuse_counts(ds[0], torch.linalg.inv(T) @ vp, cam, st.grid)
    n_vox, n_steps = ray_voxels(ds[0], torch.linalg.inv(vp) @ T, st)
    px = [cam.level(lv).width * cam.level(lv).height for lv in range(cfg["pyramid_height"])]
    iters = sum(p * n for p, n in zip(px, cfg["icp_iters"]))
    nbytes = (4 * px[0] + 24 * sum(px)          # measurement
              + 48 * sum(px)                    # ICP
              + 8 * n_upd + 8 * n_col           # fusion
              + 2 * n_vox + 24 * sum(px))       # raycast and the model pyramid
    ops = (OPS["icp_pixel_iteration"] * iters + OPS["fuse_update"] * n_upd
           + OPS["fuse_colour"] * n_col + OPS["raycast_step"] * n_steps)
    return {"bytes": nbytes, "ops": ops, "least_s": max(nbytes / HBM_BPS, ops / F32_FLOPS),
            "voxels_updated": n_upd, "ray_voxels": n_vox}
