"""Raycast surface prediction: the march family, shading and the dispatcher
(port of kinfu_tpu/volume/raycast.py).

All rays march in lockstep, sampling the TSDF with nearest-voxel gathers;
hit refinement and normals run afterwards as one vectorised pass over the
recorded hit parameters. The JAX package computes all of this outside any
Pallas kernel, so it stays plain PyTorch on every device. Its
`lax.while_loop`s become Python loops that stop when no ray is alive and
never run past the JAX bound on steps. On a CUDA device that test reads
the device once a step, so "hier" and "step" are opt-in there: "auto"
takes the warped raycast (K4 + face shading + K5,
`ops/face_raycast.py::raycast_warped`), which never reads the device.

The marcher and shader take a local Z-slab of the global volume (`z0h` =
global z index of local row 0, `dims_g` = global dims), as in JAX; the
single-device path passes the full volume.

Math parity with device::raycast (tsdf_volume.cu:113-279):
  - ray = cam2vol.R @ K^-1 [u,v,1], normalised, origin cam2vol.t
  - AABB clip to [0, volume_range], start at max(tnear,0)+step, step = one
    voxel
  - nearest-voxel TSDF sampling, invalid outside [1, dims-2]; an invalid
    sample never triggers a crossing test
  - -,+ crossing (backface) ends the ray without a hit
  - +,- crossing: linear refinement, vertex = org + dir*Ts, normal = central
    difference of trilinear TSDF at +-voxel/2, outputs in the camera frame
with the JAX package's two recorded fixes (DIVERGENCES.md items 2 and 10).
Small matrix-vector products are written out element by element in the
JAX operation order, so that they round as XLA's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import PIX_CLAMP, rint_index, sqrt32
from kinfu_tpu_torch.volume.tsdf import SHORTMAX, TSDFVolume, tsdf_to_float

_INF = 1e30


class MarchResult(NamedTuple):
    #: ray parameter of the first +,- crossing, +inf when none
    hit_t: torch.Tensor
    #: ray parameter of the first -,+ (backface) event, +inf when none
    back_t: torch.Tensor


def _index(x: torch.Tensor) -> torch.Tensor:
    """rint to int64, a NaN as an out-of-bounds index (the float-to-int32
    cast of XLA:CPU turns it into INT32_MIN)."""
    return rint_index(torch.nan_to_num(x, nan=-PIX_CLAMP, posinf=PIX_CLAMP,
                                       neginf=-PIX_CLAMP))


def _floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) to int64, clamped to +-2^24 (NaN as -2^24)."""
    x = torch.nan_to_num(x, nan=-PIX_CLAMP, posinf=PIX_CLAMP, neginf=-PIX_CLAMP)
    return torch.floor(x).clamp(-PIX_CLAMP, PIX_CLAMP).long()


def _f32(values) -> torch.Tensor:
    return torch.tensor(np.asarray(values, np.float32))


def _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p_vox):
    """Nearest-voxel TSDF at float *global* voxel coords ([..., 3] x,y,z):
    (value, valid). The backing array covers global z rows
    [z0h, z0h + local_z); validity is the reference's 1-voxel global border
    and local availability."""
    Zg, Y, X = dims_g
    xi = _index(p_vox[..., 0])
    yi = _index(p_vox[..., 1])
    zi = _index(p_vox[..., 2])
    valid = (xi >= 1) & (xi < X - 1) & (yi >= 1) & (yi < Y - 1) & (zi >= 1) & (zi < Zg - 1)
    zl = zi - z0h
    valid = valid & (zl >= 0) & (zl < local_z)
    lin = ((zl * Y + yi) * X + xi).clamp(0, local_z * Y * X - 1)
    return tsdf_to_float(tsdf_flat[lin]), valid


def trilinear(tsdf_flat, dims_g, z0h, local_z, p_vox):
    """Trilinear TSDF interpolation at float global voxel coords (corner
    convention): (value, valid). Parity: device::interpolate
    (tsdf_volume.cu:139-161), floor anchor, invalid outside [0, dims-2]."""
    Zg, Y, X = dims_g
    g = torch.floor(p_vox)
    gx = _floor_index(p_vox[..., 0])
    gy = _floor_index(p_vox[..., 1])
    gz = _floor_index(p_vox[..., 2])
    valid = (gx >= 0) & (gx < X - 1) & (gy >= 0) & (gy < Y - 1) & (gz >= 0) & (gz < Zg - 1)
    gzl = gz - z0h
    valid = valid & (gzl >= 0) & (gzl < local_z - 1)

    a = p_vox[..., 0] - g[..., 0]
    b = p_vox[..., 1] - g[..., 1]
    c = p_vox[..., 2] - g[..., 2]

    gxc = gx.clamp(0, X - 2)
    gyc = gy.clamp(0, Y - 2)
    gzc = gzl.clamp(0, local_z - 2)

    acc = torch.zeros(p_vox.shape[:-1], dtype=torch.float32, device=p_vox.device)
    for dx in (0, 1):
        wx = a if dx else (1.0 - a)
        for dy in (0, 1):
            wy = b if dy else (1.0 - b)
            for dz in (0, 1):
                wz = c if dz else (1.0 - c)
                lin = ((gzc + dz) * Y + (gyc + dy)) * X + (gxc + dx)
                acc = acc + tsdf_to_float(tsdf_flat[lin]) * wx * wy * wz
    return acc, valid


def ray_aabb(org, dirs, box_max):
    """Per-ray entry/exit parameters for the [0, box_max] AABB
    (device::intersect, tsdf_volume.cu:120-136)."""
    safe_dirs = torch.where(dirs.abs() < 1e-12, 1e-12, dirs)
    tbot = (0.0 - org) / safe_dirs
    ttop = (box_max - org) / safe_dirs
    tnear = torch.minimum(tbot, ttop).amax(dim=-1)
    tfar = torch.maximum(tbot, ttop).amin(dim=-1)
    return tnear, tfar


def _point(org, dirs, t):
    """org + dirs * t, per ray."""
    return org + dirs * t[..., None]


def march_steps_bound(dims_g, voxel_size, step: float) -> int:
    """The most steps `march` can take: a ray marches while its sample is
    inside its AABB chord, which is at most the volume's diagonal."""
    diag = math.sqrt(sum((d * v) ** 2 for d, v in zip(dims_g, voxel_size)))
    return int(math.ceil(diag / step)) + 2


def march(
    tsdf_local: torch.Tensor,
    dims_g: Tuple[int, int, int],
    z0h: int,
    org: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    step: float,
    inv_vs: torch.Tensor,
    k_start: torch.Tensor | None = None,
    max_steps: int | None = None,
) -> MarchResult:
    """Lockstep ray march over sample grid t_k = t_start + k*step, starting
    at k = k_start (default 0) while t_k < t_end. Sample positions come
    from an integer counter, never accumulated. tsdf_local: [local_Z, Y, X]
    int16 slab covering global z rows [z0h, z0h + local_Z). The loop ends
    when no ray is alive, after at most `max_steps` steps (default: the
    volume diagonal over `step`, which no ray can outlast)."""
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    if k_start is None:
        k_start = torch.zeros(t_start.shape, dtype=torch.int32, device=t_start.device)
    if max_steps is None:
        vs = (1.0 / inv_vs).tolist()
        max_steps = march_steps_bound(dims_g, vs, step)

    def t_of(k):
        return t_start + k.float() * step

    k = k_start
    t0 = t_of(k)
    f_prev, v_prev = _sample_nearest(tsdf_flat, dims_g, z0h, local_z, _point(org, dirs, t0) * inv_vs)
    alive = t0 < t_end
    hit_t = torch.full(t0.shape, _INF, dtype=torch.float32, device=t0.device)
    back_t = hit_t.clone()

    for _ in range(max_steps):
        if not bool(alive.any()):
            break
        knext = k + 1
        tcur = t_of(k)
        tnext = t_of(knext)
        f_next, v_next = _sample_nearest(tsdf_flat, dims_g, z0h, local_z,
                                         _point(org, dirs, tnext) * inv_vs)
        both = v_prev & v_next & alive
        front = both & (f_prev > 0.0) & (f_next < 0.0)
        back = both & (f_prev < 0.0) & (f_next > 0.0)
        frac = f_prev / torch.clamp(f_prev - f_next, min=1e-30)
        hit_t = torch.where(front, torch.minimum(hit_t, tcur + step * frac), hit_t)
        back_t = torch.where(back, torch.minimum(back_t, tnext), back_t)
        alive = alive & ~front & ~back & (tnext < t_end)
        k, f_prev, v_prev = knext, f_next, v_next
    return MarchResult(hit_t=hit_t, back_t=back_t)


def march_chunked(
    tsdf_local: torch.Tensor,
    dims_g: Tuple[int, int, int],
    z0h: int,
    org: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    step: float,
    inv_vs: torch.Tensor,
    max_steps: int,
    chunk: int = 64,
) -> MarchResult:
    """Chunked lockstep march with the events of `march`: each iteration
    samples `chunk`+1 positions of every ray at once, finds the crossings
    of the chunk and keeps each ray's earliest event; at most
    ceil(max_steps / chunk) iterations."""
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    n_chunks = max(1, -(-max_steps // chunk))
    dev = t_start.device

    offs = torch.arange(chunk + 1, dtype=torch.float32, device=dev) * step
    hit_t = torch.full(t_start.shape, _INF, dtype=torch.float32, device=dev)
    back_t = hit_t.clone()
    active = t_start < t_end

    for k in range(n_chunks):
        if not bool(active.any()):
            break
        base = t_start + float(np.float32(k * chunk) * np.float32(step))
        t = base[..., None] + offs  # [H, W, C+1]
        p = org + dirs[..., None, :] * t[..., None]
        f, v = _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p * inv_vs)

        fp, fn = f[..., :-1], f[..., 1:]
        vp, vn = v[..., :-1], v[..., 1:]
        in_rng = t[..., :-1] < t_end[..., None]
        both = vp & vn & in_rng
        front = both & (fp > 0.0) & (fn < 0.0)
        back = both & (fp < 0.0) & (fn > 0.0)

        any_evt = front | back
        has_evt = any_evt.any(dim=-1)
        first = any_evt.to(torch.uint8).argmax(dim=-1, keepdim=True)

        t_prev = torch.take_along_dim(t[..., :-1], first, dim=-1)[..., 0]
        f_prev = torch.take_along_dim(fp, first, dim=-1)[..., 0]
        f_next = torch.take_along_dim(fn, first, dim=-1)[..., 0]
        is_front = torch.take_along_dim(front, first, dim=-1)[..., 0]

        frac = f_prev / torch.clamp(f_prev - f_next, min=1e-30)
        t_hit = t_prev + step * frac

        ev = active & has_evt
        hit_t = torch.where(ev & is_front, t_hit, hit_t)
        back_t = torch.where(ev & ~is_front, t_prev + step, back_t)

        exhausted = base + chunk * step >= t_end
        active = active & ~has_evt & ~exhausted
    return MarchResult(hit_t=hit_t, back_t=back_t)


def build_occupancy(tsdf: torch.Tensor, block: int = 8) -> torch.Tensor:
    """Coarse occupancy grid for empty-space skipping: a `block`^3 cell is
    occupied iff it holds a voxel with TSDF < 0 (no march event can start
    in a cell whose samples are all >= 0). Needs every dim divisible by
    `block`."""
    Z, Y, X = tsdf.shape
    b = block
    m = tsdf.reshape(Z // b, b, Y // b, b, X // b, b).amin(dim=(1, 3, 5))
    return m < 0


def march_hier(
    tsdf_local: torch.Tensor,
    occ: torch.Tensor,
    org: torch.Tensor,
    dirs: torch.Tensor,
    t_start: torch.Tensor,
    t_end: torch.Tensor,
    step: float,
    inv_vs: torch.Tensor,
    block: int = 8,
    max_iters: int | None = None,
) -> MarchResult:
    """Two-level lockstep march: DDA over coarse cells, fine steps only
    inside cells that can hold a crossing. Same events as `march` up to
    the sub-step sampling phase: fine sampling inside an occupied cell
    starts two steps before the cell entry. Every iteration reads one
    entry per ray of a combined fine+coarse table; at most `max_iters`
    iterations (default 8 (Z + Y + X), the JAX bound)."""
    Zl, Y, X = tsdf_local.shape
    Zc, Yc, Xc = occ.shape
    assert (Zc, Yc, Xc) == (Zl // block, Y // block, X // block)
    n_fine = Zl * Y * X
    dev = tsdf_local.device

    # coarse cells with the TSDF's sign convention: negative == occupied
    one = torch.ones((), dtype=torch.int16, device=dev)
    comb = torch.cat([tsdf_local.reshape(-1), torch.where(occ.reshape(-1), -one, one)])

    if max_iters is None:
        max_iters = int(8 * (Zl + Y + X))

    vs = 1.0 / inv_vs  # [3] metres per voxel
    cmax = torch.tensor([Xc - 1, Yc - 1, Zc - 1], dtype=torch.int64, device=dev)

    # Rays march independently, so the loop runs on the live ones only: the
    # working set shrinks to them whenever fewer than half of it live. The
    # events are those of the full lockstep loop.
    shape = t_start.shape
    n_rays = t_start.numel()
    hit_g = torch.full((n_rays,), _INF, dtype=torch.float32, device=dev)
    back_g = hit_g.clone()
    idx = torch.arange(n_rays, device=dev)
    dirs_w = dirs.reshape(-1, 3)
    t_start_w = t_start.reshape(-1)
    t_end_w = t_end.reshape(-1)

    def sample_indices(t, dirs_w, safe_dirs, pos_dir):
        """(fine linear index, fine validity, coarse linear index, cell exit
        t) at ray parameter t."""
        p = _point(org, dirs_w, t) * inv_vs  # voxel coords
        xi, yi, zi = _index(p[..., 0]), _index(p[..., 1]), _index(p[..., 2])
        v = (xi >= 1) & (xi < X - 1) & (yi >= 1) & (yi < Y - 1) & (zi >= 1) & (zi < Zl - 1)
        fine_lin = ((zi * Y + yi) * X + xi).clamp(0, n_fine - 1)
        # block is a power of two here: p / block == p * (1 / block) exactly
        cell = _floor_index(p / block)
        cc = torch.minimum(cell.clamp(min=0), cmax)
        coarse_lin = n_fine + (cc[..., 2] * Yc + cc[..., 1]) * Xc + cc[..., 0]
        bound_vox = (cell + pos_dir.long()).float() * block
        t_ax = (bound_vox * vs - org) / safe_dirs
        return fine_lin, v, coarse_lin, t_ax.amin(dim=-1)

    t = t_start_w
    f_prev = torch.zeros(n_rays, dtype=torch.float32, device=dev)
    v_prev = torch.zeros(n_rays, dtype=torch.bool, device=dev)
    coarse = torch.ones(n_rays, dtype=torch.bool, device=dev)
    fine_until = torch.full((n_rays,), -_INF, dtype=torch.float32, device=dev)
    alive = t < t_end_w
    hit_t = hit_g.clone()
    back_t = hit_g.clone()
    safe_dirs = torch.where(dirs_w.abs() < 1e-12, 1e-12, dirs_w)
    pos_dir = dirs_w > 0

    for _ in range(max_iters):
        n_alive = int(alive.sum())
        if n_alive == 0:
            break
        if 2 * n_alive < idx.numel():
            hit_g[idx], back_g[idx] = hit_t, back_t
            keep = alive.nonzero()[:, 0]
            idx, dirs_w, t_start_w, t_end_w = idx[keep], dirs_w[keep], t_start_w[keep], t_end_w[keep]
            t, f_prev, v_prev, coarse, fine_until, alive, hit_t, back_t = (
                a[keep] for a in (t, f_prev, v_prev, coarse, fine_until, alive, hit_t, back_t))
            safe_dirs, pos_dir = safe_dirs[keep], pos_dir[keep]

        tnext = t + step
        fine_lin, v_next, _, _ = sample_indices(tnext, dirs_w, safe_dirs, pos_dir)
        _, _, coarse_lin, t_exit = sample_indices(t, dirs_w, safe_dirs, pos_dir)

        raw = comb[torch.where(coarse, coarse_lin, fine_lin)]
        neg = raw < 0

        # fine rays: crossing tests on consecutive samples
        f_next = raw.float() * (1.0 / SHORTMAX)
        both = ~coarse & alive & v_prev & v_next
        front = both & (f_prev > 0.0) & (f_next < 0.0)
        back = both & (f_prev < 0.0) & (f_next > 0.0)
        frac = f_prev / torch.clamp(f_prev - f_next, min=1e-30)
        hit_t = torch.where(front, torch.minimum(hit_t, t + step * frac), hit_t)
        back_t = torch.where(back, torch.minimum(back_t, tnext), back_t)

        # coarse rays: skip an empty cell, or drop to fine steps two steps early
        occupied = coarse & neg
        t_skip = torch.maximum(t_exit + 0.05 * step, t + 0.25 * step)
        t_enter = torch.maximum(t - 2.0 * step, t_start_w - step)

        t_new = torch.where(coarse, torch.where(occupied, t_enter, t_skip), tnext)
        coarse_new = torch.where(coarse, ~occupied, tnext >= fine_until)
        fine_until = torch.where(occupied, t_exit, fine_until)
        f_prev = torch.where(coarse, 0.0, f_next)
        v_prev = ~coarse & v_next

        alive_new = alive & ~front & ~back & (t_new < t_end_w)
        t = torch.where(alive, t_new, t)
        coarse, alive = coarse_new, alive_new
    hit_g[idx], back_g[idx] = hit_t, back_t
    return MarchResult(hit_t=hit_g.reshape(shape), back_t=back_g.reshape(shape))


def shade(
    tsdf_local: torch.Tensor,
    dims_g: Tuple[int, int, int],
    z0h: int,
    org: torch.Tensor,
    dirs: torch.Tensor,
    hit_t: torch.Tensor,
    hit_mask: torch.Tensor,
    voxel_size: Tuple[float, float, float],
):
    """Vertex (volume frame) + trilinear-gradient normal at the hits:
    (vertex [H,W,3], normal [H,W,3], valid [H,W])."""
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    dev = org.device
    vsx, vsy, vsz = voxel_size
    inv_vs = _f32([1.0 / vsx, 1.0 / vsy, 1.0 / vsz]).to(dev)
    delta = _f32([vsx, vsy, vsz]) * 0.5

    t_safe = torch.where(hit_mask, torch.clamp(hit_t, max=1e30), 0.0)
    vertex = _point(org, dirs, t_safe)

    def axis_grad(axis):
        e = torch.zeros(3, dtype=torch.float32)
        e[axis] = delta[axis]
        e = e.to(dev)
        f1, v1 = trilinear(tsdf_flat, dims_g, z0h, local_z, (vertex + e) * inv_vs)
        f2, v2 = trilinear(tsdf_flat, dims_g, z0h, local_z, (vertex - e) * inv_vs)
        return (f1 - f2) / float(2.0 * delta[axis]), v1 & v2

    gx, vx = axis_grad(0)
    gy, vy = axis_grad(1)
    gz, vz = axis_grad(2)
    n = torch.stack([gx, gy, gz], dim=-1)
    nrm = sqrt32(gx * gx + gy * gy + gz * gz)[..., None]
    valid = hit_mask & vx & vy & vz & (nrm[..., 0] > 1e-20)
    n = n / torch.clamp(nrm, min=1e-30)
    return vertex, n, valid


def _rotate(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v per [..., 3] vector, summed in order j = 0, 1, 2."""
    return torch.stack([R[i, 0] * v[..., 0] + R[i, 1] * v[..., 1] + R[i, 2] * v[..., 2]
                        for i in range(3)], dim=-1)


def _rotate_t(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v per [..., 3] vector, summed in order j = 0, 1, 2."""
    return _rotate(R.transpose(0, 1), v)


def camera_rays(cam2vol: Pose, intr: Intrinsics):
    """(origin [3], unit direction [H,W,3]) of all pixel rays in the volume
    frame (tsdf_volume.cu:217-220)."""
    R, t = cam2vol
    d = _rotate(R, intr.pixel_rays(R.device))
    nrm = sqrt32(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])
    return t, d / nrm[..., None]


def resolve_raycast_mode(params: KinFuParams, shape_zyx, device, block: int = 8) -> str:
    """"warped", "hier" or "step": "auto" is "warped" on a CUDA device when
    `warp_dims_ok`, else "hier" when every dim divides by `block`, else
    "step"; "warped" on an untileable volume falls back as "auto" does (the
    JAX package's shape rule, kinfu_tpu/volume/raycast.py:533-541)."""
    from kinfu_tpu_torch.ops.facewarp import warp_dims_ok

    Z, Y, X = shape_zyx
    mode = params.raycast_mode
    warp_ok = warp_dims_ok(tuple(shape_zyx))
    if mode == "warped" and not warp_ok:
        mode = "auto"
    if mode == "auto":
        if torch.device(device).type == "cuda" and warp_ok:
            mode = "warped"
        elif Z % block == 0 and Y % block == 0 and X % block == 0:
            mode = "hier"
        else:
            mode = "step"
    return mode


def raycast(
    vol: TSDFVolume,
    cam2vol: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    gate: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-device raycast: camera-frame vertex/normal maps [H, W, 3],
    zero where no surface was found. `gate`, a device bool, gives zero maps
    where it is False (in warped mode it joins the face flags that K4 and
    K5 read; in "hier" and "step" no ray starts)."""
    Z, Y, X = vol.tsdf.shape
    dev = vol.tsdf.device
    block = 8
    mode = resolve_raycast_mode(params, (Z, Y, X), dev, block)
    if mode == "warped":
        from kinfu_tpu_torch.ops.face_raycast import raycast_warped

        return raycast_warped(vol, cam2vol, intr, params, gate=gate)

    vsx, vsy, vsz = params.voxel_size
    step = params.raycast_step_voxels * vsx
    inv_vs = _f32([1.0 / vsx, 1.0 / vsy, 1.0 / vsz]).to(dev)

    org, dirs = camera_rays(cam2vol, intr)
    box_max = _f32(params.volume_range).to(dev)
    tnear, tfar = ray_aabb(org, dirs, box_max)
    t_start = torch.clamp(tnear, min=0.0) + step
    if gate is not None:
        tfar = torch.where(gate, tfar, -_INF)

    if mode == "hier":
        occ = build_occupancy(vol.tsdf, block)
        res = march_hier(vol.tsdf, occ, org, dirs, t_start, tfar, step, inv_vs, block)
    elif mode == "step":
        res = march(vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs,
                    max_steps=march_steps_bound((Z, Y, X), params.voxel_size, step))
    else:
        raise ValueError(f"unknown raycast_mode: {params.raycast_mode!r}")
    hit = (res.hit_t < res.back_t) & (res.hit_t < _INF)

    vertex, n, valid = shade(vol.tsdf, (Z, Y, X), 0, org, dirs, res.hit_t, hit,
                             params.voxel_size)
    R, _ = cam2vol
    vcam = _rotate_t(R, vertex - org)
    ncam = _rotate_t(R, n)
    m = valid[..., None]
    return torch.where(m, vcam, 0.0), torch.where(m, ncam, 0.0)
