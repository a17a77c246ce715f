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


def slab_of(st, rank: int, world: int, dim: int) -> tuple:
    """(dim, lo, hi): the planes lo..hi-1 of the natural array dim `dim`
    (0 = Z, 1 = Y) that rank `rank` of `world` holds."""
    n = st.grid.dims[2 - dim] // world
    return dim, rank * n, (rank + 1) * n


def ray_voxels(depth_m, cam2vol, st, slab=None) -> tuple:
    """(distinct voxels sampled, samples) of the frame's raycast: unit
    steps from where each ray enters the box to the observed surface's
    range, or to where it leaves the box. With `slab` (`slab_of`), those
    of one slab: the samples whose voxel lies in it, a sample outside the
    grid counted in the slab nearest to it."""
    g, cam = st.grid, st.cam
    dev = depth_m.device
    dt = torch.float32
    X, Y, Z = g.dims
    a, lo, hi = (2, 0, Z) if slab is None else (2 - slab[0], slab[1], slab[2])
    n_a = g.dims[a]
    Xl, Yl, Zl = (hi - lo if i == a else g.dims[i] for i in range(3))
    vox = torch.tensor(g.voxel, dtype=dt, device=dev)
    box = torch.tensor([X * g.voxel[0], Y * g.voxel[1], Z * g.voxel[2]], dtype=dt, device=dev)
    org, dirs = K.camera_rays(cam2vol, cam, dt)
    tn, tf = K.ray_box(org, dirs, box)
    u, v = K._pixel_grid(cam, dt, dev)
    lam = torch.sqrt(((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2 + 1.0)
    rng = depth_m * lam
    t0 = torch.clamp(tn, min=0.0) + g.voxel[0]
    t_end = torch.where(rng > 0, torch.minimum(rng, tf), tf)
    seen = torch.zeros(Zl * Yl * Xl, dtype=torch.bool, device=dev)
    samples = torch.zeros((), dtype=torch.int64, device=dev)
    steps = int(math.ceil(math.sqrt(sum((d * s) ** 2 for d, s in zip(g.dims, g.voxel)))
                          / g.voxel[0])) + 2
    for k in range(steps):
        t = t0 + k * g.voxel[0]
        live = t < t_end
        p = torch.round((org + dirs * t[..., None]) / vox).long()
        pa = p[..., a].clamp(0, n_a - 1)
        mine = live & (pa >= lo) & (pa < hi)
        inb = mine & (p >= 0).all(-1) & (p[..., 0] < X) & (p[..., 1] < Y) & (p[..., 2] < Z)
        q = p
        if lo:
            q = p.clone()
            q[..., a] -= lo
        seen[((q[..., 2] * Yl + q[..., 1]) * Xl + q[..., 0])[inb]] = True
        samples += mine.sum()
    return int(seen.sum()), int(samples)


def frame_work(st, depth_mm: np.ndarray, pose: np.ndarray, origin, part=None,
               device=None) -> dict:
    """{"bytes", "ops"} of one frame's work, from its raw depth, the
    world-from-camera pose it was fused at, and its grid's origin. With
    `part` (rank, world, dim), the work of one rank of the sharded step:
    the whole measurement, its block of image rows in the ICP, its slab's
    voxels (`slab_of`) and ray samples, and the whole maps written."""
    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")
    cam, cfg = st.cam, st.cfg
    ds, _, _ = K.measurement(torch.as_tensor(depth_mm.astype(np.float32), device=dev), cam, cfg,
                             torch.float32)
    T = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=dev)
    vp = st.vol_pose(origin, dev)
    levels = [cam.level(lv) for lv in range(cfg["pyramid_height"])]
    px = [c.width * c.height for c in levels]
    if part is None:
        n_upd, n_col = K.fuse_counts(ds[0], torch.linalg.inv(T) @ vp, cam, st.grid)
        n_vox, n_steps = ray_voxels(ds[0], torch.linalg.inv(vp) @ T, st)
        px_icp = px
    else:
        rank, world, dim = part
        slab = slab_of(st, rank, world, dim)
        shape = [st.grid.dims[2], st.grid.dims[1], st.grid.dims[0]]
        shape[dim] = slab[2] - slab[1]
        lo = [0, 0, 0]
        lo[2 - dim] = slab[1]
        n_upd, n_col = K.fuse_counts(ds[0], torch.linalg.inv(T) @ vp, cam, st.grid, lo=lo,
                                     shape=shape)
        n_vox, n_steps = ray_voxels(ds[0], torch.linalg.inv(vp) @ T, st, slab)
        # the row blocks of the sharded ICP: ceil(H / world) rows a rank
        px_icp = [c.width * max(0, min(-(-c.height // world), c.height
                                       - rank * -(-c.height // world))) for c in levels]
    iters = sum(p * n for p, n in zip(px_icp, cfg["icp_iters"]))
    nbytes = (4 * px[0] + 24 * sum(px)          # measurement
              + 48 * sum(px_icp)                # ICP
              + 8 * n_upd + 8 * n_col           # fusion
              + 2 * n_vox + 24 * sum(px))       # raycast and the model pyramid
    ops = (OPS["icp_pixel_iteration"] * iters + OPS["fuse_update"] * n_upd
           + OPS["fuse_colour"] * n_col + OPS["raycast_step"] * n_steps)
    return {"bytes": nbytes, "ops": ops, "least_s": max(nbytes / HBM_BPS, ops / F32_FLOPS),
            "voxels_updated": n_upd, "ray_voxels": n_vox}
