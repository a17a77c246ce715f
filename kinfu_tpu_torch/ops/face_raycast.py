"""Cube-face plane-sweep raycast (port of kinfu_tpu/ops/pallas_raycast.py),
and kernels K4 (the sweep) and K5 (the resample onto the camera grid).

Per cube face, rays through the virtual face pixel (i, j) have primed
direction d' = ((j-c)/f, (i-c)/f, 1). Marching in t = z' - o'_z, one
nearest-voxel sample per primed plane, a ray records the refined front
(+ to -) crossing, a back (- to +) crossing, or an outward exit, and stops
there. The face-grid hit field is shaded in plain PyTorch (`face_fields`)
and resampled to the camera grid.

K4 (`sweep_rays`, csrc/sweep_rays.cu) replaces `_sweep_kernel`
(kinfu_tpu/ops/pallas_raycast.py:114-284): one CUDA thread per face ray,
marching the primed planes of its interval (`ray_plane_interval`) in order,
eight loads at a time, through the natural volume via the face's signed
permutation. It keeps the TPU kernel's semantics: the
`t_cover` bound of its row windows (L161), the [1, N-2] validity bounds,
the NaN carry of the previous sample, the front/back/exit rules
(L254-273), the early exit once a ray has resolved, and the static tile
ownership (8x128 face tiles with any pixel inside the padded cone). It
drops what only skipped work: the occupancy pooling, the summed-area
tables and the visit lists (L321-443).

K5 (`resample_composite`, csrc/resample_face.cu) replaces
`_resample_kernel` (L579-624) and the per-face glue around it: one launch
a frame, one thread per camera pixel, finds the face that owns the pixel's
ray (the exact ownership test of `_face_pass`, L699-705), takes that
face's nearest face pixel and writes the composite vertex, normal and
valid mask in the volume frame, as the fused step's composite over the
faces (kinfu_tpu/ops/fused_step.py:132-144) keeps what the owning face
gives.

`sweep_rays_plain` and `resample_composite_plain` are their plain PyTorch
versions; `resample_face_plain` is the one-face resample of the JAX
package's `_resample_face`, whose arithmetic the composite's plain version
repeats for each face.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import recip, rint_index
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.ops.face_integrate import prime
from kinfu_tpu_torch.ops.facewarp import (
    FaceFrame,
    face_frames,
    frame_tensors,
    primed_offset,
    primed_voxel_size,
)
from kinfu_tpu_torch.volume.tsdf import SHORTMAX

_INF = 1e30
#: row windows of the TPU sweep per (tile, plane); they bound `t_cover`
_N_WIN = 4
#: extra face pixels beyond the +-45 deg ownership cone that still march
_OWN_PAD_PX = 2.0


class RaySpec(NamedTuple):
    """Static geometry of the virtual raycast face grid."""

    size: int  # square face, pixels (multiple of 128)
    focal: float  # virtual focal length, pixels

    @property
    def centre(self) -> float:
        return (self.size - 1) / 2.0


def default_ray_spec() -> RaySpec:
    return RaySpec(size=640, focal=261.0)


def prime_geometry(frame: FaceFrame, params: KinFuParams, device):
    """(D [3,3], offset [3], primed voxel size) of a face frame."""
    D, off = frame_tensors(frame, params.volume_dims, params.voxel_size, device)
    return D, off, primed_voxel_size(frame, params.voxel_size)


@functools.lru_cache(maxsize=None)
def _ray_consts(vs_p, spec: RaySpec, device):
    """The constant parts of `ray_params` on `device`: primed voxel size,
    face focal, face centre, t_cover, ownership tan bound; 5 spare zeros."""
    f32 = torch.float32
    vs = torch.tensor(vs_p, dtype=f32)
    f = torch.tensor(spec.focal, dtype=f32)
    # farthest plane the TPU kernel's 4 row windows cover (L161), in its
    # float32 operation order
    t_cover = torch.tensor((8.0 * _N_WIN - 9.0) / 7.0, dtype=f32) * f * vs[1] * 0.99
    tail = torch.tensor([spec.centre, 1.0 + _OWN_PAD_PX / spec.focal], dtype=f32)
    mid = torch.cat([vs, f.reshape(1), tail[:1], t_cover.reshape(1), tail[1:]])
    return constant(mid, f32, device), constant([0.0] * 5, f32, device)


def ray_params(org_p: torch.Tensor, vs_p, spec: RaySpec,
               gate: torch.Tensor) -> torch.Tensor:
    """K4's device parameter block f32[16]: primed origin (3), primed voxel
    size (3), face focal, face centre, t_cover, ownership tan bound, gate
    (1 = march, 0 = write no events), 5 spare."""
    mid, spare = _ray_consts(tuple(vs_p), spec, org_p.device)
    return torch.cat([org_p.float(), mid, gate.reshape(1).float(), spare])


def _own_mask(spec: RaySpec, own_tan: torch.Tensor, device) -> torch.Tensor:
    """[F, F] static tile ownership: 8x128 tiles with any pixel inside the
    padded +-45 deg cone (pallas_raycast.py:397-403)."""
    F = spec.size
    pix = torch.arange(F, dtype=torch.float32, device=device)
    tan = ((pix - spec.centre) * recip(spec.focal)).abs()
    ok_1d = tan <= own_tan
    row_ok = ok_1d.reshape(F // 8, 8).any(dim=1).repeat_interleave(8)
    col_ok = ok_1d.reshape(F // 128, 128).any(dim=1).repeat_interleave(128)
    return row_ok[:, None] & col_ok[None, :]


def sweep_rays_plain(tsdf: torch.Tensor, frame: FaceFrame, prm: torch.Tensor,
                     spec: RaySpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4: (hit_t, back_t) [F, F] f32 in the
    t = z' - o'_z parameterization, +inf (1e30) where there is no event."""
    ht, bt, _ = _march(tsdf, frame, prm, spec)
    return ht, bt


def sweep_rays_work(tsdf: torch.Tensor, frame: FaceFrame, prm: torch.Tensor,
                    spec: RaySpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """What K4 must do on these inputs, as device counts: (distinct voxels
    the rays sample, ray-plane steps they march). A ray marches plane by
    plane until it resolves and samples the voxel of each valid plane on
    its way, so the counts depend on the surface. chip_smoke.py turns them
    into K4's bound."""
    touched = torch.zeros(tsdf.numel(), dtype=torch.bool, device=tsdf.device)
    _, _, steps = _march(tsdf, frame, prm, spec, touched)
    return touched.sum(), steps


def _march(tsdf: torch.Tensor, frame: FaceFrame, prm: torch.Tensor, spec: RaySpec,
           touched: torch.Tensor | None = None):
    """The plain march: (hit_t, back_t, ray-plane steps of the live rays).
    Where `touched` (bool, tsdf.numel()) is given, it marks every voxel of
    the primed volume that a live ray samples."""
    t_p = prime(tsdf, frame)
    Zp, Yp, Xp = t_p.shape
    dev = tsdf.device
    F = spec.size
    ox, oy, oz, vsx, vsy, vsz = prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]
    f, c, t_cover, own_tan, gate = prm[6], prm[7], prm[8], prm[9], prm[10]
    inv_vsx = 1.0 / vsx
    inv_vsy = 1.0 / vsy
    pix = torch.arange(F, dtype=torch.float32, device=dev)
    # the face focal is static in the JAX package: reciprocal multiply
    dy = ((pix - c) * (1.0 / f))[:, None]
    dx = ((pix - c) * (1.0 / f))[None, :]
    inf = torch.tensor(_INF, dtype=torch.float32, device=dev)
    nan = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    ht = inf.expand(F, F).clone()
    bt = inf.expand(F, F).clone()
    fp = nan.expand(F, F).clone()
    alive = _own_mask(spec, own_tan, dev) & (gate != 0)
    flat = t_p.reshape(-1)
    steps = torch.zeros((), dtype=torch.int64, device=dev)

    for zg in range(Zp):
        t_m = float(zg) * vsz - oz
        t_ok = (t_m > 1e-6) & (t_m <= t_cover)
        ts = torch.clamp(t_m, min=1e-6)
        yv = (oy + dy * ts) * inv_vsy
        xv = (ox + dx * ts) * inv_vsx
        yi = rint_index(yv)
        xi = rint_index(xv)
        lin = (zg * Yp + yi.clamp(0, Yp - 1)) * Xp + xi.clamp(0, Xp - 1)
        f_new = flat[lin].float() * (1.0 / SHORTMAX)
        yok = (yi >= 1) & (yi < Yp - 1)
        xok = (xi >= 1) & (xi < Xp - 1)
        valid = t_ok & (1 <= zg < Zp - 1) & yok & xok

        live = alive & (ht >= _INF) & (bt >= _INF)
        if touched is not None:
            touched[lin[live & valid]] = True
            steps = steps + live.sum()
        # a NaN previous sample fails both comparisons (no event)
        front = live & valid & (fp > 0.0) & (f_new < 0.0)
        back = live & valid & (fp < 0.0) & (f_new > 0.0)
        denom = fp - f_new
        frac = fp / torch.where(denom.abs() < 1e-30, torch.full_like(denom, 1e-30), denom)
        ht = torch.where(front, t_m - vsz + vsz * frac, ht)
        bt = torch.where(back, t_m, bt)
        exit_out = (
            ((xi >= Xp - 1) & (dx > 0))
            | ((xi <= 0) & (dx < 0))
            | ((yi >= Yp - 1) & (dy > 0))
            | ((yi <= 0) & (dy < 0))
        ) & t_ok
        bt = torch.where(live & ~front & ~back & exit_out, t_m, bt)
        fp = torch.where(valid, f_new, nan)
    return ht, bt, steps


def _first_plane(n: int, pred, shape, device) -> torch.Tensor:
    """Per ray, the first plane of [0, n) where `pred(z)` holds (n if none),
    by bisection; `pred` is false, then true, along the planes."""
    a = torch.zeros(shape, dtype=torch.int64, device=device)
    b = torch.full(shape, n, dtype=torch.int64, device=device)
    for _ in range(n.bit_length()):
        m = (a + b) // 2
        p = pred(m.clamp(max=n - 1)) & (a < b)
        b = torch.where(p, m, b)
        a = torch.where(~p & (a < b), m + 1, a)
    return a


def ray_plane_interval(prm: torch.Tensor, frame: FaceFrame, dims_p,
                       spec: RaySpec) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per face ray, the planes [z_first, z_last] (int64 [F, F]) that K4
    marches, and the last plane of their valid run, v_last: from the first
    plane where the sample can be valid or an outward exit can fire, to the
    plane where the exit fires (the ray has resolved there at the latest)
    or else its last valid plane. Each condition of the march is monotone in
    the plane index, so bisection on the march's own float expressions finds
    the planes exactly. The valid samples are the run [z_first, v_last]
    (empty when v_last < z_first); before it the march carries fp = NaN and
    changes nothing, and past it only the exit at z_last can fire (when
    z_last > v_last). Rays of unowned tiles and of a gated-off face get
    empty intervals (z_first = Zp, z_last = v_last = -1).
    csrc/sweep_rays.cu computes the same in the kernel; the tests use this
    twin."""
    Zp, Yp, Xp = dims_p
    dev = prm.device
    F = spec.size
    ox, oy, oz, vsx, vsy, vsz = prm[0], prm[1], prm[2], prm[3], prm[4], prm[5]
    f, c, t_cover, own_tan, gate = prm[6], prm[7], prm[8], prm[9], prm[10]
    pix = torch.arange(F, dtype=torch.float32, device=dev)
    dy = ((pix - c) * (1.0 / f))[:, None].expand(F, F)
    dx = ((pix - c) * (1.0 / f))[None, :].expand(F, F)

    def t_m(z):
        return z.float() * vsz - oz

    def first(pred):
        return _first_plane(Zp, pred, (F, F), dev)

    def span(o, d, inv_vs, n):
        """(first plane inside [1, n-2] moving inward, first plane of the
        outward exit), Zp where there is none."""
        def idx(z):
            return rint_index((o + d * torch.clamp(t_m(z), min=1e-6)) * inv_vs)
        up_in, up_out = first(lambda z: idx(z) >= 1), first(lambda z: idx(z) >= n - 1)
        dn_in, dn_out = first(lambda z: idx(z) <= n - 2), first(lambda z: idx(z) <= 0)
        i0 = idx(torch.zeros((F, F), dtype=torch.int64, device=dev))
        flat_in = torch.where((i0 >= 1) & (i0 <= n - 2), 0, Zp)
        zp = torch.full_like(flat_in, Zp)
        return (torch.where(d > 0, up_in, torch.where(d < 0, dn_in, flat_in)),
                torch.where(d > 0, up_out, torch.where(d < 0, dn_out, zp)))

    p_t = first(lambda z: t_m(z) > 1e-6)
    p_c = first(lambda z: t_m(z) > t_cover)
    x_in, x_out = span(ox, dx, 1.0 / vsx, Xp)
    y_in, y_out = span(oy, dy, 1.0 / vsy, Yp)
    v_lo = torch.maximum(torch.maximum(p_t.clamp(min=1), x_in), y_in)
    v_hi = torch.minimum(torch.minimum(p_c.clamp(max=Zp - 1), x_out), y_out) - 1
    e = torch.maximum(p_t, torch.minimum(x_out, y_out))
    exits = e < p_c
    has_valid = v_lo <= v_hi
    z_first = torch.where(has_valid, v_lo, torch.where(exits, e, Zp))
    z_last = torch.where(exits, e, v_hi)
    alive = _own_mask(spec, own_tan, dev) & (gate != 0) & (has_valid | exits)
    return (torch.where(alive, z_first, Zp), torch.where(alive, z_last, -1),
            torch.where(alive, v_hi, -1))


def sweep_rays(tsdf: torch.Tensor, frame: FaceFrame, prm: torch.Tensor,
               spec: RaySpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: march every face ray through the volume seen from `frame`. CPU
    tensors take the plain version; CUDA tensors launch csrc/sweep_rays.cu."""
    if tsdf.device.type == "cpu":
        return sweep_rays_plain(tsdf, frame, prm, spec)
    kernels.library()
    Z, Y, X = tsdf.shape
    kernels.check_cuda("sweep_rays", tsdf, prm)
    kernels.check("sweep_rays", tsdf, torch.int16, (Z, Y, X))
    kernels.check("sweep_rays", prm, torch.float32, (16,))
    F = spec.size
    hit = torch.empty((F, F), dtype=torch.float32, device=tsdf.device)
    back = torch.empty((F, F), dtype=torch.float32, device=tsdf.device)
    kernels.launch(
        "kinfu_sweep_rays",
        kernels.ptr(tsdf), kernels.ptr(prm), kernels.ptr(hit), kernels.ptr(back),
        Z, Y, X, *frame.axes, int(frame.flip), F,
    )
    return hit, back


def face_fields(hit: torch.Tensor, back: torch.Tensor, origin_p: torch.Tensor,
                spec: RaySpec):
    """(t_valid, normal' [F,F,3], nvalid) on the face grid
    (pallas_raycast.py:482-576): 3x3 smoothing of t, normals from central
    differences oriented toward the camera, and the silhouette fill. Plain
    PyTorch, with neighbours from `torch.roll` as JAX takes them from
    `jnp.roll`."""
    F = spec.size
    dev = hit.device
    ok = (hit < back) & (hit < _INF)
    t = torch.where(ok, hit, _INF)

    pix = torch.arange(F, dtype=torch.float32, device=dev)
    dxr = ((pix - spec.centre) * recip(spec.focal))[None, :]
    dyr = ((pix - spec.centre) * recip(spec.focal))[:, None]

    def sh(a, di, dj):
        return torch.roll(a, shifts=(-di, -dj), dims=(0, 1))

    okf32 = ok.float()
    tz = torch.clamp(hit, max=1e30) * okf32
    wsum = torch.zeros_like(okf32)
    tsum = torch.zeros_like(tz)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            wsum = wsum + sh(okf32, di, dj)
            tsum = tsum + sh(tz, di, dj)
    t_s = tsum / torch.clamp(wsum, min=1.0) * okf32

    vx = origin_p[0] + dxr * t_s
    vy = origin_p[1] + dyr * t_s
    vz = origin_p[2] + t_s
    v = torch.stack([vx, vy, vz], dim=-1)

    ok_r = sh(ok, 0, 1) & sh(ok, 0, -1) & sh(ok, 1, 0) & sh(ok, -1, 0) & ok
    du = sh(v, 0, 1) - sh(v, 0, -1)
    dv = sh(v, 1, 0) - sh(v, -1, 0)
    n = torch.linalg.cross(du, dv, dim=-1)
    tmag = torch.clamp(t, min=1e-6)
    disc = torch.maximum((sh(t, 0, 1) - sh(t, 0, -1)).abs(),
                         (sh(t, 1, 0) - sh(t, -1, 0)).abs())
    ok_n = ok_r & (disc < 0.05 * tmag)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    ok_n = ok_n & (nn[..., 0] > 1e-20)
    n = n / torch.clamp(nn, min=1e-30)
    d3 = torch.stack([dxr.expand(F, F), dyr.expand(F, F),
                      torch.ones((F, F), dtype=torch.float32, device=dev)], dim=-1)
    flip = (n * d3).sum(dim=-1) > 0
    sign = 1.0 - 2.0 * flip.float()
    n = n * sign[..., None] * ok_n[..., None].float()

    nsum = torch.zeros_like(n)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            nsum = nsum + sh(n, di, dj)
    nsn = torch.linalg.vector_norm(nsum, dim=-1, keepdim=True)
    n_fill = nsum / torch.clamp(nsn, min=1e-30)
    usable = nsn[..., 0] > 1e-20
    rim = ok & ~ok_n & usable
    n = torch.where(rim[..., None], n_fill, n)
    t_avg = tsum / torch.clamp(wsum, min=1.0)
    fill = ~ok & (wsum > 0.5) & usable
    t = torch.where(fill, t_avg, t)
    n = torch.where(fill[..., None], n_fill, n)
    return t, n, ok_n | rim | fill


def resample_face_plain(t_f: torch.Tensor, n_f: torch.Tensor, prm: torch.Tensor,
                        intr: Intrinsics) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K5: nearest-face-pixel resample of
    (t [F,F], normal' [F,F,3]) onto the camera grid; +inf (1e30) and 0
    outside the face or where the gate is 0."""
    F = t_f.shape[0]
    dev = t_f.device
    h, w = intr.height, intr.width
    a = prm[:9]
    fx, fy, cx, cy, gate, f, c = prm[9], prm[10], prm[11], prm[12], prm[13], prm[14], prm[15]
    # the focal lengths are static in the JAX package: reciprocal multiplies
    lx = ((torch.arange(w, dtype=torch.float32, device=dev) - cx) * (1.0 / fx))[None, :]
    ly = ((torch.arange(h, dtype=torch.float32, device=dev) - cy) * (1.0 / fy))[:, None]
    dpx = a[0] * lx + a[1] * ly + a[2]
    dpy = a[3] * lx + a[4] * ly + a[5]
    dpz = a[6] * lx + a[7] * ly + a[8]
    fwd = dpz > 1e-6
    zs = torch.where(fwd, dpz, torch.ones_like(dpz))
    fu = rint_index(f * dpx / zs + c)
    fv = rint_index(f * dpy / zs + c)
    inb = fwd & (fu >= 0) & (fu < F) & (fv >= 0) & (fv < F) & (gate != 0)
    lin = fv.clamp(0, F - 1) * F + fu.clamp(0, F - 1)
    t = torch.where(inb, t_f.reshape(-1)[lin], torch.full_like(dpz, _INF))
    n = torch.where(inb[..., None], n_f.reshape(-1, 3)[lin], torch.zeros((), device=dev))
    return t, n


#: columns of the composite's parameter block, per face: A (camera ray to
#: primed direction, row-major), the primed camera origin, the primed
#: offset, each primed axis's natural axis and sign (D's rows), the
#: ownership flags gt_x, gt_y, one spare
COMPOSITE_COLS = 24
#: the faces K5 composites: all of face_frames(), in its order
_N_FACES = len(face_frames())


@functools.lru_cache(maxsize=None)
def _composite_consts(dims_xyz, voxel_size, device):
    """(D [6,3,3], the constant columns [6,12] of the block) on `device`."""
    frames = face_frames()
    tail = np.zeros((len(frames), 12), np.float32)
    for f, fr in enumerate(frames):
        tail[f, 0:3] = primed_offset(fr, dims_xyz, voxel_size)
        tail[f, 3:6] = np.abs(fr.D).argmax(axis=1)
        tail[f, 6:9] = fr.D.sum(axis=1)
        tail[f, 9:11] = fr.gt_x, fr.gt_y
    return (constant(np.stack([fr.D for fr in frames]), torch.float32, device),
            constant(tail, torch.float32, device))


def composite_params(cam2vol: Pose, params: KinFuParams) -> torch.Tensor:
    """K5's device parameter block f32[6, COMPOSITE_COLS] in face_frames()
    order; column 9:12 is each face's primed camera origin D org + off,
    which the face's sweep (K4) and shading take too."""
    R, org = cam2vol
    D, tail = _composite_consts(tuple(params.volume_dims), tuple(params.voxel_size), R.device)
    A = D @ R  # camera pixel ray -> primed direction
    org_p = D @ org + tail[:, 0:3]
    return torch.cat([A.reshape(-1, 9), org_p, tail], dim=1)


def _owned_rays(prm: torch.Tensor, gates: torch.Tensor, intr: Intrinsics, F: int,
                spec: RaySpec):
    """Per face f, in order: (f, primed ray (dpx, dpy, dpz) [H, W] each,
    own & gates[f], inb, the linear index of the nearest face pixel). A
    pixel's ray is owned by the face whose primed z dominates its |x| and
    |y| (z>y>x tie-break, the exact test of pallas_raycast.py:699-705); inb
    says that the nearest face pixel of a forward ray lies on the face
    (pallas_raycast.py:579-624). The primed ray is A [lx, ly, 1] written
    element-wise, in K5's order."""
    dev = prm.device
    lx = ((torch.arange(intr.width, dtype=torch.float32, device=dev) - intr.cx)
          * recip(intr.fx))[None, :]
    ly = ((torch.arange(intr.height, dtype=torch.float32, device=dev) - intr.cy)
          * recip(intr.fy))[:, None]
    f32 = np.float32
    focal, centre = float(f32(spec.focal)), float(f32(spec.centre))
    for f in range(prm.shape[0]):
        a = prm[f]
        dpx = a[0] * lx + a[1] * ly + a[2]
        dpy = a[3] * lx + a[4] * ly + a[5]
        dpz = a[6] * lx + a[7] * ly + a[8]
        adx, ady = dpx.abs(), dpy.abs()
        own_x = torch.where(a[21] != 0, adx < dpz, adx <= dpz)
        own_y = torch.where(a[22] != 0, ady < dpz, ady <= dpz)
        own = (dpz > 0) & own_x & own_y & gates[f]
        fwd = dpz > 1e-6
        zs = torch.where(fwd, dpz, torch.ones_like(dpz))
        fu = rint_index(focal * dpx / zs + centre)
        fv = rint_index(focal * dpy / zs + centre)
        inb = fwd & (fu >= 0) & (fu < F) & (fv >= 0) & (fv < F)
        yield f, (dpx, dpy, dpz), own, inb, fv.clamp(0, F - 1) * F + fu.clamp(0, F - 1)


def resample_composite_plain(t_f: Sequence[torch.Tensor], n_f: Sequence[torch.Tensor],
                             prm: torch.Tensor, gates: torch.Tensor, intr: Intrinsics,
                             spec: RaySpec):
    """Plain PyTorch version of K5: the six faces' (t [F,F], normal' [F,F,3])
    resampled onto the camera grid and composited. Returns (vertex [H,W,3],
    normal [H,W,3], valid [H,W]) in the volume frame, zero where no face
    with its gate set owns the pixel or took a sample: per face, in face
    order, the resample of `resample_face_plain`, the vertex on the pixel's
    ray p' = org' + d' / max(d'z, 1e-9) t, unprimed by the face's signed
    permutation (an index and a sign), kept where the face owns the pixel
    and sampled a hit (`_face_pass` and the composite of
    kinfu_tpu/ops/fused_step.py:132-144)."""
    h, w = intr.height, intr.width
    dev = prm.device
    F = t_f[0].shape[0]
    vertex = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    normal = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
    valid = torch.zeros((h, w), dtype=torch.bool, device=dev)
    axes, signs = prm[:, 15:18].long().tolist(), prm[:, 18:21].tolist()
    for f, d_p, own, inb, lin in _owned_rays(prm, gates, intr, F, spec):
        t = torch.where(inb, t_f[f].reshape(-1)[lin], _INF)
        n_p = torch.where(inb[..., None], n_f[f].reshape(-1, 3)[lin], 0.0)
        ok = t < _INF
        tsafe = torch.where(ok, t, 0.0)
        dzc = torch.clamp(d_p[2], min=1e-9)
        p_v, n_v = [None] * 3, [None] * 3
        for i in range(3):
            q = prm[f, 9 + i] + d_p[i] / dzc * tsafe - prm[f, 12 + i]
            p_v[axes[f][i]] = signs[f][i] * q
            n_v[axes[f][i]] = signs[f][i] * n_p[..., i]
        p_v, n_v = torch.stack(p_v, dim=-1), torch.stack(n_v, dim=-1)
        m = own & ok
        vertex = torch.where(m[..., None], p_v, vertex)
        normal = torch.where(m[..., None], n_v, normal)
        valid = (m & (n_v.abs() > 0).any(dim=-1)) | valid
    return vertex, normal, valid


def resample_composite_work(prm: torch.Tensor, gates: torch.Tensor, intr: Intrinsics,
                            F: int, spec: RaySpec) -> torch.Tensor:
    """What K5 must read of the face fields on these inputs, as a device
    count: the distinct face pixels (of all six faces) that an owned camera
    pixel samples (each 16 bytes of t and normal'). chip_smoke.py turns it
    into K5's bound."""
    read = torch.zeros(prm.shape[0] * F * F, dtype=torch.bool, device=prm.device)
    for f, _, own, inb, lin in _owned_rays(prm, gates, intr, F, spec):
        read[f * F * F + lin[own & inb]] = True
    return read.sum()


def resample_composite(t_f: Sequence[torch.Tensor], n_f: Sequence[torch.Tensor],
                       prm: torch.Tensor, gates: torch.Tensor, intr: Intrinsics,
                       spec: RaySpec):
    """K5: (vertex, normal, valid) of the camera grid from the six faces'
    fields, in one launch. CPU tensors take the plain version; CUDA tensors
    launch csrc/resample_face.cu."""
    if prm.device.type == "cpu":
        return resample_composite_plain(t_f, n_f, prm, gates, intr, spec)
    kernels.library()
    nf = _N_FACES
    F = t_f[0].shape[0]
    kernels.check_cuda("resample_face", *t_f, *n_f, prm, gates)
    if len(t_f) != nf or len(n_f) != nf:
        raise ValueError(f"resample_face: expected the fields of {nf} faces")
    for t, n in zip(t_f, n_f):
        kernels.check("resample_face", t, torch.float32, (F, F))
        kernels.check("resample_face", n, torch.float32, (F, F, 3))
    kernels.check("resample_face", prm, torch.float32, (nf, COMPOSITE_COLS))
    kernels.check("resample_face", gates, torch.bool, (nf,))
    h, w = intr.height, intr.width
    vertex = torch.empty((h, w, 3), dtype=torch.float32, device=prm.device)
    normal = torch.empty((h, w, 3), dtype=torch.float32, device=prm.device)
    valid = torch.empty((h, w), dtype=torch.bool, device=prm.device)
    kernels.launch(
        "kinfu_resample_face",
        kernels.ptr_array(t_f), kernels.ptr_array(n_f), kernels.ptr(prm), kernels.ptr(gates),
        kernels.ptr(vertex), kernels.ptr(normal), kernels.ptr(valid),
        float(intr.fx), float(intr.fy), float(intr.cx), float(intr.cy),
        float(spec.focal), float(spec.centre), h, w, F,
    )
    return vertex, normal, valid


def sweep_and_shade(tsdf: torch.Tensor, frame: FaceFrame, org_p: torch.Tensor,
                    params: KinFuParams, spec: RaySpec, gate: torch.Tensor):
    """One face's sweep (K4) and shading: its face-grid (t [F,F],
    normal' [F,F,3]), +inf and 0 where it has no surface, and everywhere
    when the device flag `gate` is 0 (pallas_raycast.py:673-689).
    `org_p` is the face's primed camera origin (`composite_params`)."""
    vs_p = primed_voxel_size(frame, params.voxel_size)
    hit, back = sweep_rays(tsdf, frame, ray_params(org_p, vs_p, spec, gate), spec)
    t_f, n_f, _ = face_fields(hit, back, org_p, spec)
    return t_f, n_f
