"""Raycast surface prediction: the march family, shading and the dispatcher
(port of kinfu_tpu/volume/raycast.py).

The JAX package marches all rays in lockstep inside one `lax.while_loop`,
sampling the TSDF with nearest-voxel gathers, whose condition the device
evaluates; hit refinement and normals run afterwards as one vectorised
pass over the recorded hit parameters. All of it runs outside Pallas. Here
each march has a plain PyTorch twin (`march`, `march_hier`), a Python loop
that stops when no ray is alive and never runs past the JAX bound, and a
hand-written CUDA kernel with one thread per ray that loops until that
ray's own stop: M1 (`march_rays`, csrc/march_rays.cu) and M2
(`march_hier_rays`, csrc/march_hier.cu). A CPU tensor takes the twin, a
CUDA tensor launches the kernel or raises, so "hier" and "step" read the
device no more than "warped" (K4 + R1 + K5,
`ops/face_raycast.py::raycast_warped`), which "auto" takes on the card
wherever `warp_dims_ok`. Occupancy and shading stay plain PyTorch, built
with device constants so that they make no host sync either.

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

import functools
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import PIX_CLAMP, rint_index, sqrt32
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.volume.tsdf import SHORTMAX, TSDFVolume, tsdf_to_float

_INF = 1e30
#: the kernels' loop bound when the caller gives none (int32 max)
_NO_BOUND = 2**31 - 1


class MarchResult(NamedTuple):
    #: ray parameter of the first +,- crossing, +inf when none
    hit_t: torch.Tensor
    #: ray parameter of the first -,+ (backface) event, +inf when none
    back_t: torch.Tensor


class MarchWork(NamedTuple):
    """What a march kernel must do on given inputs, filled in place by its
    plain twin (`march_work`, `march_hier_work`)."""

    #: bool, one flag per element the kernel may read (the volume's voxels,
    #: then, for `march_hier`, the occupancy cells): set where a live ray
    #: reads it (a voxel of a valid sample, any cell)
    read: torch.Tensor
    #: int64 [3]: loop iterations of live rays that sample a voxel, of them
    #: those whose two samples are both valid (the crossing rules run), and
    #: (`march_hier`) iterations of live rays in coarse mode
    counts: torch.Tensor


def _index(x: torch.Tensor) -> torch.Tensor:
    """rint to int64, a NaN as an out-of-bounds index (the float-to-int32
    cast of XLA:CPU turns it into INT32_MIN)."""
    return rint_index(torch.nan_to_num(x, nan=-PIX_CLAMP, posinf=PIX_CLAMP,
                                       neginf=-PIX_CLAMP))


def _floor_index(x: torch.Tensor) -> torch.Tensor:
    """floor(x) to int64, clamped to +-2^24 (NaN as -2^24)."""
    x = torch.nan_to_num(x, nan=-PIX_CLAMP, posinf=PIX_CLAMP, neginf=-PIX_CLAMP)
    return torch.floor(x).clamp(-PIX_CLAMP, PIX_CLAMP).long()


@functools.lru_cache(maxsize=None)
def f32_constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """float32 `values` on `device`, built once per device and values
    (`device.constant`: no host sync on the card). Must not be written to."""
    return constant(np.asarray(values, np.float32), torch.float32, device)


def inv_voxel_size(voxel_size, device) -> torch.Tensor:
    """float32 [1 / vsx, 1 / vsy, 1 / vsz] on `device`, a cached constant."""
    return f32_constant(tuple(1.0 / v for v in voxel_size), torch.device(device))


def _sample_nearest(tsdf_flat, dims_g, z0h, local_z, p_vox):
    """Nearest-voxel TSDF at float *global* voxel coords ([..., 3] x,y,z):
    (value, valid). The backing array covers global z rows
    [z0h, z0h + local_z); validity is the reference's 1-voxel global border
    and local availability."""
    lin, valid = _nearest_index(dims_g, z0h, local_z, p_vox)
    return tsdf_to_float(tsdf_flat[lin]), valid


def _nearest_index(dims_g, z0h, local_z, p_vox):
    """`_sample_nearest`'s (linear index into the slab, valid)."""
    Zg, Y, X = dims_g
    xi = _index(p_vox[..., 0])
    yi = _index(p_vox[..., 1])
    zi = _index(p_vox[..., 2])
    valid = (xi >= 1) & (xi < X - 1) & (yi >= 1) & (yi < Y - 1) & (zi >= 1) & (zi < Zg - 1)
    zl = zi - z0h
    valid = valid & (zl >= 0) & (zl < local_z)
    lin = ((zl * Y + yi) * X + xi).clamp(0, local_z * Y * X - 1)
    return lin, valid


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
    work: MarchWork | None = None,
) -> MarchResult:
    """Lockstep ray march over sample grid t_k = t_start + k*step, starting
    at k = k_start (default 0) while t_k < t_end: the plain twin of M1
    (`march_rays`). Sample positions come from an integer counter, never
    accumulated. tsdf_local: [local_Z, Y, X] int16 slab covering global z
    rows [z0h, z0h + local_Z). The loop ends when no ray is alive, after at
    most `max_steps` steps; with None it has no bound, as JAX's has none:
    every ray ends at its finite t_end (the dispatchers pass
    `march_steps_bound`). The loop's test reads the device once a step (use
    `march_rays` there). `work` (`march_work`) receives what M1 must do."""
    local_z = tsdf_local.shape[0]
    tsdf_flat = tsdf_local.reshape(-1)
    if k_start is None:
        k_start = torch.zeros(t_start.shape, dtype=torch.int32, device=t_start.device)

    def t_of(k):
        return t_start + k.float() * step

    def sample(t):
        lin, valid = _nearest_index(dims_g, z0h, local_z, _point(org, dirs, t) * inv_vs)
        return lin, tsdf_to_float(tsdf_flat[lin]), valid

    k = k_start
    t0 = t_of(k)
    lin, f_prev, v_prev = sample(t0)
    alive = t0 < t_end
    if work is not None:
        work.read[lin[alive & v_prev]] = True
    hit_t = torch.full(t0.shape, _INF, dtype=torch.float32, device=t0.device)
    back_t = hit_t.clone()

    n = 0
    while max_steps is None or n < max_steps:
        if not bool(alive.any()):
            break
        n += 1
        knext = k + 1
        tcur = t_of(k)
        tnext = t_of(knext)
        lin, f_next, v_next = sample(tnext)
        both = v_prev & v_next & alive
        if work is not None:
            work.read[lin[alive & v_next]] = True
            work.counts[0] += alive.sum()
            work.counts[1] += both.sum()
        front = both & (f_prev > 0.0) & (f_next < 0.0)
        back = both & (f_prev < 0.0) & (f_next > 0.0)
        frac = f_prev / torch.clamp(f_prev - f_next, min=1e-30)
        hit_t = torch.where(front, torch.minimum(hit_t, tcur + step * frac), hit_t)
        back_t = torch.where(back, torch.minimum(back_t, tnext), back_t)
        alive = alive & ~front & ~back & (tnext < t_end)
        k, f_prev, v_prev = knext, f_next, v_next
    return MarchResult(hit_t=hit_t, back_t=back_t)


def _ray_tensors(name: str, org, dirs, t_start, t_end, inv_vs):
    """The float32 ray arrays a march kernel takes, contiguous (a pose's
    translation is a strided view), checked against t_start's shape."""
    shape = tuple(t_start.shape)
    out = [a.contiguous() for a in (org, dirs, t_start, t_end, inv_vs)]
    for a, want in zip(out, ((3,), shape + (3,), shape, shape, (3,))):
        kernels.check(name, a, torch.float32, want)
    return out


def march_rays(
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
    """M1: `march`'s events. CPU tensors take `march`; CUDA tensors launch
    csrc/march_rays.cu, one thread a ray, with no host read. The full
    volume passes z0h = 0 and dims_g = its shape; the Z-slab form a
    halo-padded slab, its global row z0h, and per-ray `k_start` and
    `t_end`. `max_steps` None: no bound, as in `march`."""
    if tsdf_local.device.type == "cpu":
        return march(tsdf_local, dims_g, z0h, org, dirs, t_start, t_end, step, inv_vs,
                     k_start=k_start, max_steps=max_steps)
    kernels.library()
    local_z, Y, X = tsdf_local.shape
    if tuple(dims_g[1:]) != (Y, X):
        raise ValueError(f"march_rays: dims_g {tuple(dims_g)} do not match the slab's "
                         f"{(Y, X)} rows and columns")
    max_steps = _NO_BOUND if max_steps is None else min(max_steps, _NO_BOUND)
    org, dirs, t_start, t_end, inv_vs = _ray_tensors("march_rays", org, dirs, t_start, t_end,
                                                     inv_vs)
    kernels.check_cuda("march_rays", tsdf_local, org, dirs, t_start, t_end, inv_vs)
    kernels.check("march_rays", tsdf_local, torch.int16, (local_z, Y, X))
    if k_start is not None:
        kernels.check_cuda("march_rays", tsdf_local, k_start)
        kernels.check("march_rays k_start", k_start, torch.int32, t_start.shape)
    hit = torch.empty_like(t_start)
    back = torch.empty_like(t_start)
    kernels.launch(
        "kinfu_march_rays",
        kernels.ptr(tsdf_local), kernels.ptr(org), kernels.ptr(dirs), kernels.ptr(t_start),
        kernels.ptr(t_end), None if k_start is None else kernels.ptr(k_start),
        kernels.ptr(inv_vs), kernels.ptr(hit), kernels.ptr(back),
        t_start.numel(), local_z, int(dims_g[0]), Y, X, int(z0h), int(max_steps),
        float(np.float32(step)),
        kernels.lengths(tsdf_local, org, dirs, t_start, t_end, k_start, inv_vs, hit, back),
    )
    return MarchResult(hit_t=hit, back_t=back)


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
    ceil(max_steps / chunk) iterations. It stays plain PyTorch, with a host
    read a chunk: only tests call it, as in JAX, where no dispatcher takes
    it (kinfu_tpu/volume/raycast.py:527-528)."""
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
    work: MarchWork | None = None,
) -> MarchResult:
    """Two-level lockstep march, the plain twin of M2 (`march_hier_rays`):
    DDA over coarse cells, fine steps only inside cells that can hold a
    crossing. Same events as `march` up to the sub-step sampling phase:
    fine sampling inside an occupied cell starts two steps before the cell
    entry. Every iteration reads one entry per ray of a combined
    fine+coarse table; at most `max_iters` iterations (default 8 (Z + Y +
    X), the JAX bound). Its loop test reads the device once an iteration.
    `work` (`march_hier_work`) receives what M2 must do; its `read` indexes
    the combined table."""
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
    cmax = constant([Xc - 1, Yc - 1, Zc - 1], torch.int64, dev)

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

        lin = torch.where(coarse, coarse_lin, fine_lin)
        raw = comb[lin]
        neg = raw < 0
        if work is not None:
            work.read[lin[alive & (coarse | v_next)]] = True
            work.counts[0] += (alive & ~coarse).sum()
            work.counts[1] += (alive & ~coarse & v_prev & v_next).sum()
            work.counts[2] += (alive & coarse).sum()

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


def march_hier_rays(
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
    """M2: `march_hier`'s events. CPU tensors take `march_hier`; CUDA
    tensors launch csrc/march_hier.cu, one thread a ray, with no host read.
    The loop's float scalars (step, 0.05 step, 0.25 step, 2 step) are
    formed in double here and rounded to float32, as PyTorch rounds the
    twin's Python scalars."""
    if tsdf_local.device.type == "cpu":
        return march_hier(tsdf_local, occ, org, dirs, t_start, t_end, step, inv_vs, block,
                          max_iters)
    kernels.library()
    Zl, Y, X = tsdf_local.shape
    if max_iters is None:
        max_iters = int(8 * (Zl + Y + X))
    org, dirs, t_start, t_end, inv_vs = _ray_tensors("march_hier_rays", org, dirs, t_start,
                                                     t_end, inv_vs)
    kernels.check_cuda("march_hier_rays", tsdf_local, occ, org, dirs, t_start, t_end, inv_vs)
    kernels.check("march_hier_rays", tsdf_local, torch.int16, (Zl, Y, X))
    kernels.check("march_hier_rays", occ, torch.bool, (Zl // block, Y // block, X // block))
    hit = torch.empty_like(t_start)
    back = torch.empty_like(t_start)
    f32 = np.float32
    kernels.launch(
        "kinfu_march_hier",
        kernels.ptr(tsdf_local), kernels.ptr(occ), kernels.ptr(org), kernels.ptr(dirs),
        kernels.ptr(t_start), kernels.ptr(t_end), kernels.ptr(inv_vs), kernels.ptr(hit),
        kernels.ptr(back), t_start.numel(), Zl, Y, X, int(block), int(min(max_iters, _NO_BOUND)),
        float(f32(step)), float(f32(0.05 * step)), float(f32(0.25 * step)),
        float(f32(2.0 * step)),
        kernels.lengths(tsdf_local, occ, org, dirs, t_start, t_end, inv_vs, hit, back),
    )
    return MarchResult(hit_t=hit, back_t=back)


def _new_work(n_read: int, device) -> MarchWork:
    return MarchWork(read=torch.zeros(n_read, dtype=torch.bool, device=device),
                     counts=torch.zeros(3, dtype=torch.int64, device=device))


def march_work(tsdf_local, dims_g, z0h, org, dirs, t_start, t_end, step, inv_vs,
               k_start=None, max_steps=None):
    """What M1 must do on `march_rays`'s inputs, as device counts from its
    twin: (distinct voxels the live rays read, their loop iterations, the
    iterations whose two samples are valid). chip_smoke.py turns them into
    M1's bound."""
    work = _new_work(tsdf_local.numel(), tsdf_local.device)
    march(tsdf_local, dims_g, z0h, org, dirs, t_start, t_end, step, inv_vs, k_start=k_start,
          max_steps=max_steps, work=work)
    return work.read.sum(), work.counts[0], work.counts[1]


def march_hier_work(tsdf_local, occ, org, dirs, t_start, t_end, step, inv_vs, block=8,
                    max_iters=None):
    """What M2 must do on `march_hier_rays`'s inputs, as device counts from
    its twin: (distinct voxels and distinct occupancy cells the live rays
    read, their fine iterations, of those the ones whose two samples are
    valid, their coarse iterations). chip_smoke.py turns them into M2's
    bound."""
    n_fine = tsdf_local.numel()
    work = _new_work(n_fine + occ.numel(), tsdf_local.device)
    march_hier(tsdf_local, occ, org, dirs, t_start, t_end, step, inv_vs, block, max_iters,
               work=work)
    return (work.read[:n_fine].sum(), work.read[n_fine:].sum(), work.counts[0],
            work.counts[1], work.counts[2])


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
    inv_vs = inv_voxel_size(voxel_size, dev)
    delta = np.float32(voxel_size) * np.float32(0.5)

    t_safe = torch.where(hit_mask, torch.clamp(hit_t, max=1e30), 0.0)
    vertex = _point(org, dirs, t_safe)

    def axis_grad(axis):
        e = f32_constant(tuple(float(delta[a]) if a == axis else 0.0 for a in range(3)), dev)
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


def march_inputs(cam2vol: Pose, intr: Intrinsics, params: KinFuParams):
    """The march raycast's rays: (org [3], dirs [H,W,3], t_start, t_end
    [H,W], step, inv_vs), each ray clipped to the volume's box and starting
    one step inside it (tsdf_volume.cu:225-232); built from device
    constants, so no host sync."""
    dev = cam2vol.R.device
    step = params.raycast_step_voxels * params.voxel_size[0]
    org, dirs = camera_rays(cam2vol, intr)
    tnear, tfar = ray_aabb(org, dirs, f32_constant(tuple(params.volume_range), dev))
    return (org, dirs, torch.clamp(tnear, min=0.0) + step, tfar, step,
            inv_voxel_size(params.voxel_size, dev))


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

    org, dirs, t_start, tfar, step, inv_vs = march_inputs(cam2vol, intr, params)
    if gate is not None:
        tfar = torch.where(gate, tfar, -_INF)

    if mode == "hier":
        occ = build_occupancy(vol.tsdf, block)
        res = march_hier_rays(vol.tsdf, occ, org, dirs, t_start, tfar, step, inv_vs, block)
    elif mode == "step":
        res = march_rays(vol.tsdf, (Z, Y, X), 0, org, dirs, t_start, tfar, step, inv_vs,
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
