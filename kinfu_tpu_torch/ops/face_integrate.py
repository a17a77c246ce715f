"""TSDF fusion against axis-aligned face images (port of
kinfu_tpu/ops/pallas_integrate.py), and kernel K3 that runs one face's
sweep.

One sweep per cube face the frustum touches. Each face sees the volume
through its signed axis permutation (face_frames) as a "+z'" sweep and
updates exactly the voxels it owns (dominant |d| component, z>y>x
tie-break), so the six sweeps compose without double updates. Per primed
plane, a gate and the mip scalars (`slab_geometry`) are the same
expressions as the TPU kernel's; plain PyTorch evaluates them for every
plane into a small device table that the sweep reads.

K3 (`sweep_face`, csrc/face_integrate.cu) replaces the Pallas kernel
`_kernel` (kinfu_tpu/ops/pallas_integrate.py:204-390), in place: each block
schedules, in natural coordinates, only the voxels inside each plane's
footprint (`plane_footprint`, the rectangle of primed voxels that can pass
the face-pixel and ownership tests and see the camera's frustum), one CUDA
thread per voxel. `sweep_face_plain` is its plain PyTorch version.

K3's shard form is the same launch on one rank's slab of a sharded volume
(kinfu_tpu/parallel/sharded.py:432-460): the slab's origin is folded into
the pose, so the slab is a volume of its own, and the frames are the
`shard_dim` set of `face_frames`, whose Y-sharded +-x faces sweep in the
(2, 1, 0) frame (`integrate_faces(..., shard_dim=)`).

Differences of form from the TPU kernel, none of result:
  - no prime/unprime transposes of the volume (L422-431): the kernel maps
    its natural voxel index to primed coordinates itself;
  - the 3-window row gather (`_window_gather`, L121-147) is a direct load:
    where `cover_ok` holds the windows cover every row a strip reads, and
    `cover_ok` stays in the ownership mask;
  - no y-blocking, and the footprint in place of the slab work lists: the
    plane gate uses the full Y range, which is the TPU kernel's own gate
    whenever one y-block spans the whole plane (at 512^3, L465-471).
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import recip, sqrt32
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.ops.facewarp import (
    FaceFrame,
    FaceSpec,
    build_faces,
    default_face_spec,
    face_frames,
    face_geometry,
    face_params,
    primed_voxel_size,
)
from kinfu_tpu_torch.volume.tsdf import SHORTMAX, TSDFVolume, pack_rgb

#: mip target: finest level with slope <= _S_MAX face px / voxel
_S_MAX = 2.0
#: coverage limit of the clamped coarsest level; planes beyond it are
#: masked (the TPU kernel's 3-window bound, DIVERGENCES.md 19)
_S_COVER = 2.2
#: a face is needed when a sampled frustum direction is within this margin
#: of its ownership cone
_FACE_MARGIN = 0.75

#: columns of the per-plane table read by the sweep
TABLE_COLS = ("dz", "dzs", "au", "bu", "av", "bv", "row_off", "width", "slab_do")


@functools.lru_cache(maxsize=None)
def _mip_tables(spec: FaceSpec, device):
    """Per mip level: (1 / 2^l f32, row offset i64, width i64) on `device`."""
    return (constant([1.0 / (1 << l) for l in range(spec.levels)], torch.float32, device),
            constant(spec.row_offsets, torch.int64, device),
            constant([spec.size >> l for l in range(spec.levels)], torch.int64, device))


def _mip_scalars(spec: FaceSpec, slope: torch.Tensor):
    """(inv_scale, row_off, width, cover_ok) per plane from the full-res
    slope (pallas_integrate.py:93-118): level L = smallest with
    slope / 2^L <= _S_MAX, clamped to the pyramid."""
    lvl = torch.zeros_like(slope, dtype=torch.int64)
    for l in range(1, spec.levels):
        lvl = lvl + (slope > _S_MAX * (1 << (l - 1))).long()
    inv_scales, row_offs, widths = _mip_tables(spec, slope.device)
    inv_scale, row_off, width = inv_scales[lvl], row_offs[lvl], widths[lvl]
    cover_ok = slope * inv_scale <= _S_COVER
    return inv_scale, row_off, width, cover_ok


def _min_abs(lo, hi):
    """min |x| over the interval [lo, hi] (elementwise)."""
    zero = torch.zeros_like(lo)
    return torch.where(lo > 0.0, lo, torch.where(hi < 0.0, -hi, zero))


def slab_geometry(spec: FaceSpec, prm: torch.Tensor, n_planes: int,
                  x_dim: int, y_dim: int) -> Dict[str, torch.Tensor]:
    """Per-plane gate and affine face-coordinate scalars for every primed
    plane (pallas_integrate.py:155-201 with full-Y bounds). `prm` is the
    sweep's parameter block (`sweep_params`)."""
    cx, cy, cz, vsx, vsy, vsz, focal, centre, trunc_mm, _, r_max_mm = prm[:11]
    f32 = torch.float32
    zf = torch.arange(n_planes, dtype=f32, device=prm.device)
    dz = zf * vsz - cz
    dz_ok = dz > 1e-3
    dzs = torch.clamp(dz, min=1e-3)
    slope = focal * torch.maximum(vsx, vsy) / dzs
    inv_scale, row_off, width, cover_ok = _mip_scalars(spec, slope)
    slab_ok = dz_ok & cover_ok

    au = focal * vsx / dzs * inv_scale
    bu = (-focal * cx / dzs + centre) * inv_scale
    av = focal * vsy / dzs * inv_scale
    bv = (-focal * cy / dzs + centre) * inv_scale

    y_lo_f = torch.zeros((), dtype=f32, device=prm.device)
    y_hi_f = torch.full((), float(y_dim - 1), dtype=f32, device=prm.device)
    x_hi_f = torch.full((), float(x_dim - 1), dtype=f32, device=prm.device)
    dx_min_f = _min_abs(-cx, x_hi_f * vsx - cx)
    dy_min_f = _min_abs(y_lo_f * vsy - cy, y_hi_f * vsy - cy)
    u_hi_f = au * x_hi_f + bu
    v_lo_f = av * y_lo_f + bv
    v_hi_f = av * y_hi_f + bv
    r_min_slab_mm = sqrt32(dx_min_f * dx_min_f + dy_min_f * dy_min_f + dz * dz) * 1000.0
    width_f = width.to(f32)
    slab_do = (
        slab_ok
        & (dx_min_f <= dzs)
        & (dy_min_f <= dzs)
        & (u_hi_f >= -0.5)
        & (bu <= width_f - 0.5)
        & (v_hi_f >= -0.5)
        & (v_lo_f <= width_f - 0.5)
        & (r_min_slab_mm <= r_max_mm + trunc_mm)
    )
    return dict(dz=dz, dzs=dzs, au=au, bu=bu, av=av, bv=bv,
                row_off=row_off.to(f32), width=width_f, slab_do=slab_do.to(f32))


def plane_table(spec: FaceSpec, prm: torch.Tensor, dims_p) -> torch.Tensor:
    """[Zp, len(TABLE_COLS)] f32 device table of `slab_geometry`."""
    Zp, Yp, Xp = dims_p
    g = slab_geometry(spec, prm, Zp, Xp, Yp)
    return torch.stack([g[k] for k in TABLE_COLS], dim=1).contiguous()


def camera_frustum(prm: torch.Tensor):
    """(tx_lo, tx_hi, ty_lo, ty_hi, ok): bounds of the primed tangents
    (x'/z', y'/z') of the camera image's rays, from K3's parameter block
    (the image size at [12:14], K2's block `face_params` at [16:32]). A face
    pixel can hold an observation only where K2 projects its ray into the
    image, half a pixel inside the corners taken here; the image maps to a
    convex quadrilateral of the face, so its corners bound it. ok is False
    where a corner ray is not in front of the face."""
    a = prm[16:32]
    w, h = prm[12], prm[13]
    lo = torch.full_like(w, -1.0)
    u = torch.stack([lo, w, lo, w])
    v = torch.stack([lo, lo, h, h])
    lx = (u - a[11]) / a[9]
    ly = (v - a[12]) / a[10]
    # primed direction = A^T (lx, ly, 1), A row-major camera-from-primed
    px = a[0] * lx + a[3] * ly + a[6]
    py = a[1] * lx + a[4] * ly + a[7]
    pz = a[2] * lx + a[5] * ly + a[8]
    ok = (pz > 0).all()
    tx, ty = px / pz, py / pz
    return tx.min(), tx.max(), ty.min(), ty.max(), ok


def plane_footprint(table: torch.Tensor, prm: torch.Tensor, dims_p) -> torch.Tensor:
    """int64 [Zp, 4] (x_lo, x_hi, y_lo, y_hi), inclusive primed bounds of
    each plane's footprint: the voxels that can pass K3's tests. The face
    pixel u = rint(au x + bu) lies in [0, width) only where au x + bu lies
    in [-0.5, width - 0.5]; |dx| <= dzs only where x lies in
    [(cx - dzs) / vsx, (cx + dzs) / vsx]; and the pixel holds an
    observation only where its ray's tangent lies in the camera frustum's
    bounds (`camera_frustum`), which the voxel's tangent (x vsx - cx) / dzs
    misses by at most half a pixel of the plane's mip level, vsx / (2 au
    dzs), plus a margin of one level-0 face pixel, 1 / f. The same for y;
    each bound widened by one voxel against rounding. A plane whose gate is
    0, or whose rectangle is empty, gives (0, -1, 0, -1). K3 computes the
    same rectangles in the kernel; the tests and chip_smoke.py use this
    twin."""
    Zp, Yp, Xp = dims_p
    col = {k: table[:, i] for i, k in enumerate(TABLE_COLS)}
    cx, cy, vsx, vsy, f = prm[0], prm[1], prm[3], prm[4], prm[6]
    dzs, width = col["dzs"], col["width"]
    tx_lo, tx_hi, ty_lo, ty_hi, seen = camera_frustum(prm)

    def span(a, b, c, vs, t_lo, t_hi, n):
        lo = torch.maximum((-0.5 - b) / a, (c - dzs) / vs)
        hi = torch.minimum((width - 0.5 - b) / a, (c + dzs) / vs)
        dt = 0.5 * vs / (a * dzs) + 1.0 / f
        lo = torch.where(seen, torch.maximum(lo, (c + dzs * (t_lo - dt)) / vs), lo)
        hi = torch.where(seen, torch.minimum(hi, (c + dzs * (t_hi + dt)) / vs), hi)
        return ((torch.floor(lo.clamp(-2.0, n + 2.0)).long() - 1).clamp(min=0),
                (torch.ceil(hi.clamp(-2.0, n + 2.0)).long() + 1).clamp(max=n - 1))

    x_lo, x_hi = span(col["au"], col["bu"], cx, vsx, tx_lo, tx_hi, Xp)
    y_lo, y_hi = span(col["av"], col["bv"], cy, vsy, ty_lo, ty_hi, Yp)
    fp = torch.stack([x_lo, x_hi, y_lo, y_hi], dim=1)
    empty = (col["slab_do"] == 0) | (x_lo > x_hi) | (y_lo > y_hi)
    none = torch.tensor([0, -1, 0, -1], device=table.device)
    return torch.where(empty[:, None], none, fp)


def footprint_voxels(fp: torch.Tensor) -> torch.Tensor:
    """Voxels inside the rectangles of `plane_footprint` (device count)."""
    return ((fp[:, 1] - fp[:, 0] + 1).clamp(min=0) * (fp[:, 3] - fp[:, 2] + 1).clamp(min=0)).sum()


def sweep_params(c_primed: torch.Tensor, vs_p, spec: FaceSpec,
                 params: KinFuParams, r_max_mm: torch.Tensor,
                 gate: torch.Tensor, face_prm: torch.Tensor,
                 intr: Intrinsics) -> torch.Tensor:
    """K3's device parameter block f32[32]: primed camera centre (3), primed
    voxel size (3), face focal, face centre, trunc (mm), max weight, max
    observed range (mm), gate (1 = sweep, 0 = leave the volume as it is),
    the camera image's width and height, 2 spare, then K2's parameter block
    `face_prm` (16), from which K3 bounds each plane's footprint by the
    camera's frustum."""
    mid, tail = _sweep_consts(tuple(vs_p), spec, params.trunc_dist * 1000.0,
                              float(params.tsdf_max_weight), intr.width, intr.height,
                              c_primed.device)
    return torch.cat([c_primed.float(), mid, r_max_mm.reshape(1).float(),
                      gate.reshape(1).float(), tail, face_prm.float()])


@functools.lru_cache(maxsize=None)
def _sweep_consts(vs_p, spec: FaceSpec, trunc_mm: float, max_weight: float, width: int,
                  height: int, device):
    """The constant parts of `sweep_params` on `device`."""
    return (constant([*vs_p, spec.focal, spec.centre, trunc_mm, max_weight], torch.float32,
                     device),
            constant([float(width), float(height), 0.0, 0.0], torch.float32, device))


def prime(a: torch.Tensor, frame: FaceFrame) -> torch.Tensor:
    """The primed array of `frame` (a copy)."""
    a = a.permute(frame.axes)
    return torch.flip(a, dims=(0,)) if frame.flip else a.contiguous()


def unprime(a: torch.Tensor, frame: FaceFrame) -> torch.Tensor:
    """Inverse of `prime`."""
    a = torch.flip(a, dims=(0,)) if frame.flip else a
    return a.permute(tuple(int(i) for i in np.argsort(frame.axes)))


def sweep_face_plain(vol: TSDFVolume, frame: FaceFrame, face_range: torch.Tensor,
                     face_color: torch.Tensor, prm: torch.Tensor,
                     table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: one face's fusion sweep, in place.
    Returns what the sweep did, as device counts: (voxels whose TSDF and
    weight it updated, voxels whose colour it mixed). K3 reads and writes
    those voxels' fields and no others."""
    t_p, w_p, c_p = prime(vol.tsdf, frame), prime(vol.weight, frame), prime(vol.color, frame)
    Zp, Yp, Xp = t_p.shape
    dev = t_p.device
    F = face_range.shape[1]
    cx, cy, vsx, vsy = prm[0], prm[1], prm[3], prm[4]
    trunc_mm, max_weight, gate = prm[8], prm[9], prm[11]
    col = {k: table[:, i].reshape(Zp, 1, 1) for i, k in enumerate(TABLE_COLS)}

    xi = torch.arange(Xp, device=dev)
    yi = torch.arange(Yp, device=dev)
    # the TPU kernel's operation order: (local * vs - c) + base * vs, with
    # 128-lane chunks along x and 8-row strips along y
    dx = (((xi % 128).float() * vsx - cx) + (xi - xi % 128).float() * vsx).reshape(1, 1, Xp)
    dy = (((yi % 8).float() * vsy - cy) + (yi - yi % 8).float() * vsy).reshape(1, Yp, 1)
    dz, dzs = col["dz"], col["dzs"]

    u_mip = torch.round(col["au"] * xi.float().reshape(1, 1, Xp) + col["bu"]).clamp(-1, F).long()
    v_mip = torch.round(col["av"] * yi.float().reshape(1, Yp, 1) + col["bv"]).clamp(-1, F).long()
    width = col["width"].long()
    u_ok = (u_mip >= 0) & (u_mip < width)
    v_ok = (v_mip >= 0) & (v_mip < width)
    row = col["row_off"].long() + v_mip.clamp(min=0)
    lin = (row * F + u_mip.clamp(min=0)).clamp(0, face_range.numel() - 1)
    lin = lin.expand(Zp, Yp, Xp)
    r_obs = face_range.reshape(-1)[lin].float()
    c_obs = face_color.reshape(-1)[lin]

    adx, ady = dx.abs(), dy.abs()
    own_x = (adx < dzs) if frame.gt_x else (adx <= dzs)
    own_y = (ady < dzs) if frame.gt_y else (ady <= dzs)
    # slab_do implies dz_ok & cover_ok; the gate covers the face flag
    own = own_x & own_y & (col["slab_do"] != 0) & (gate != 0)
    valid = own & u_ok & v_ok & (r_obs > 0)

    r_vox = sqrt32(dx * dx + dy * dy + dz * dz) * 1000.0
    sdf = r_obs - r_vox
    upd = valid & (sdf >= -trunc_mm)
    # trunc_mm is static in the JAX package: its compiler multiplies by the
    # float32 reciprocal (numerics.py)
    tsdf_obs = torch.clamp(sdf * (1.0 / trunc_mm), max=1.0)

    inv_short = torch.tensor(1.0 / SHORTMAX, dtype=torch.float32, device=dev)
    t_old = t_p.float() * inv_short
    w_old = w_p.float()
    w_new = torch.minimum(w_old + 1.0, max_weight)
    t_new = (t_old * w_old + tsdf_obs) / (w_old + 1.0)
    t_fix = torch.trunc(torch.clamp(t_new * SHORTMAX, -SHORTMAX, SHORTMAX)).to(torch.int16)

    cupd = upd & (sdf <= trunc_mm * 0.5) & (sdf >= -trunc_mm * 0.5)

    def mix(shift):
        o = ((c_p >> shift) & 0xFF).float()
        p = ((c_obs >> shift) & 0xFF).float()
        m = (w_new * o + p) / (w_new + 1.0)
        return torch.clamp(m, 0.0, 255.0).to(torch.int32)

    c_new = (mix(16) << 16) | (mix(8) << 8) | mix(0)

    vol.tsdf.copy_(unprime(torch.where(upd, t_fix, t_p), frame))
    vol.weight.copy_(unprime(torch.where(upd, w_new.to(torch.int16), w_p), frame))
    vol.color.copy_(unprime(torch.where(cupd, c_new, c_p), frame))
    return upd.sum(), cupd.sum()


def sweep_face(vol: TSDFVolume, frame: FaceFrame, face_range: torch.Tensor,
               face_color: torch.Tensor, prm: torch.Tensor,
               table: torch.Tensor, blocks: int = 0) -> None:
    """K3: one face's fusion sweep, in place. CPU tensors take the plain
    version; CUDA tensors launch csrc/face_integrate.cu on a persistent
    grid of `blocks` blocks (0: as many as the SMs hold at once). Every
    grid size writes the same bits: one warp owns each row it updates."""
    if vol.tsdf.device.type == "cpu":
        sweep_face_plain(vol, frame, face_range, face_color, prm, table)
        return
    kernels.library()
    Z, Y, X = vol.tsdf.shape
    dims_p = tuple(vol.tsdf.shape[a] for a in frame.axes)
    kernels.check_cuda("face_integrate", vol.tsdf, vol.weight, vol.color,
                       face_range, face_color, prm, table)
    kernels.check("face_integrate", vol.weight, torch.int16, (Z, Y, X))
    kernels.check("face_integrate", vol.tsdf, torch.int16, (Z, Y, X))
    kernels.check("face_integrate", vol.color, torch.int32, (Z, Y, X))
    kernels.check("face_integrate", face_color, torch.int32, face_range.shape)
    kernels.check("face_integrate", face_range, torch.int16, face_range.shape)
    kernels.check("face_integrate", prm, torch.float32, (32,))
    kernels.check("face_integrate", table, torch.float32, (dims_p[0], len(TABLE_COLS)))
    kernels.launch(
        "kinfu_face_integrate",
        kernels.ptr(vol.tsdf), kernels.ptr(vol.weight), kernels.ptr(vol.color),
        kernels.ptr(face_range), kernels.ptr(face_color), kernels.ptr(prm),
        kernels.ptr(table),
        Z, Y, X, *frame.axes, int(frame.flip), int(frame.gt_x), int(frame.gt_y),
        face_range.shape[1], face_range.shape[0], int(blocks),
        kernels.lengths(vol.tsdf, vol.weight, vol.color, face_range, face_color, prm, table),
    )


@functools.lru_cache(maxsize=None)
def _sweep_axes(device):
    """[6, 3] f32: each face frame's sweep direction (D's last row), which
    every frame set of `face_frames` shares."""
    return constant(np.stack([fr.D[2] for fr in face_frames()]), torch.float32, device)


def faces_needed(vol2cam: Pose, intr: Intrinsics, margin: float = _FACE_MARGIN) -> torch.Tensor:
    """bool [6] device flags in face_frames() order: True when a sampled
    frustum direction (7x7 pixel grid) is within `margin` of the face's
    ownership cone (pallas_integrate.py:578-600)."""
    R, _ = vol2cam
    dev = R.device
    n = 7
    u = torch.linspace(0.0, intr.width - 1.0, n, device=dev)
    v = torch.linspace(0.0, intr.height - 1.0, n, device=dev)
    lx = ((u[None, :] - intr.cx) * recip(intr.fx)).expand(n, n)
    ly = ((v[:, None] - intr.cy) * recip(intr.fy)).expand(n, n)
    d_cam = torch.stack([lx, ly, torch.ones((n, n), device=dev)], dim=-1)
    d_vol = d_cam @ R  # R^T @ d_cam
    dinf = d_vol.abs().amax(dim=-1)
    D = _sweep_axes(dev)
    comp = torch.einsum("fk,hwk->fhw", D, d_vol)
    return (comp >= margin * dinf).flatten(1).any(dim=1)


def integrate_faces(vol: TSDFVolume, depth_m: torch.Tensor, col_packed: torch.Tensor,
                    vol2cam: Pose, intr: Intrinsics, params: KinFuParams, spec: FaceSpec,
                    gates: torch.Tensor, names: tuple | None = None,
                    shard_dim: int | None = None) -> None:
    """Build the six face stacks in one launch of K2, then sweep each face
    into the volume (K3), in place (the counterpart of `_sweep_face`,
    pallas_integrate.py:393-575, once per face). Nothing changes for a face
    whose device flag gates[f] is 0; `names`, when given, limits the sweeps
    to those faces (the stacks follow the gates).

    The shard form: `vol` is one rank's slab of a volume sharded along
    `shard_dim`, and `vol2cam` has the slab's origin folded in
    (`volume/integrate.py::fold_shard_origin`), so the slab is a volume of
    its own seen from a shifted camera; the frames are the `shard_dim` set
    of `face_frames`, and the faces' geometry, footprints and plane tables
    come from the slab's dims (kinfu_tpu/parallel/sharded.py:432-460)."""
    dims_xyz = tuple(reversed(vol.tsdf.shape))
    vs = params.voxel_size
    frames = face_frames(shard_dim)
    geo = [face_geometry(vol2cam, frame, dims_xyz, vs) for frame in frames]
    prm6 = torch.stack([face_params(A, intr, gates[f], spec) for f, (A, _) in enumerate(geo)])
    face_range, face_color, r_max = build_faces(depth_m, col_packed, prm6, spec)
    for f, frame in enumerate(frames):
        if names is not None and frame.name not in names:
            continue
        prm = sweep_params(geo[f][1], primed_voxel_size(frame, vs), spec, params,
                           r_max[f].float(), gates[f], prm6[f], intr)
        dims_p = tuple(vol.tsdf.shape[a] for a in frame.axes)
        sweep_face(vol, frame, face_range[f], face_color[f], prm,
                   plane_table(spec, prm, dims_p))


def integrate_warped(
    vol: TSDFVolume,
    depth_m: torch.Tensor,
    color_rgb: torch.Tensor,
    vol2cam: Pose,
    intr: Intrinsics,
    params: KinFuParams,
    spec: FaceSpec | None = None,
    faces: str | tuple | torch.Tensor = "auto",
    gate: torch.Tensor | None = None,
    shard_dim: int | None = None,
) -> TSDFVolume:
    """Fuse one frame into `vol` in place via face warps + sweeps.

    faces="auto" runs every face the frustum touches, gated by the device
    flags of `faces_needed` (no host read); bool [6] device flags are used
    as they are; an explicit tuple of face names runs exactly those sweeps.
    `gate`, a device bool, joins every face's flag: where it is False no
    face writes anything. `shard_dim` selects the frame set of a slab
    (`integrate_faces`)."""
    spec = spec or default_face_spec()
    col_packed = pack_rgb(color_rgb)
    names = None
    if isinstance(faces, torch.Tensor):
        gates = faces
    elif faces == "auto":
        gates = faces_needed(vol2cam, intr)
    else:
        names = tuple(faces)
        gates = pinned_gates(names, vol.tsdf.device)
    if gate is not None:
        gates = gates & gate
    integrate_faces(vol, depth_m, col_packed, vol2cam, intr, params, spec, gates, names,
                    shard_dim)
    return vol


@functools.lru_cache(maxsize=None)
def pinned_gates(names: tuple, device) -> torch.Tensor:
    """bool [6] on `device`, in face_frames() order: the faces in `names`."""
    return constant([fr.name in names for fr in face_frames()], torch.bool, device)
