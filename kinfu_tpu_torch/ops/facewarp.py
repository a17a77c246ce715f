"""Axis-aligned virtual-camera range images ("faces") for separable fusion
(port of kinfu_tpu/ops/facewarp.py), and kernel K2 that builds them.

The depth frame is resampled once per frame into a virtual pinhole camera
at the camera centre with an axis-aligned orientation in (primed) volume
coordinates, so the voxel -> face-pixel map of the fusion sweep is affine
per plane. The face stores range r = ||p_obs - c|| in int16 millimetres
and the packed colour, as a stack of nearest-subsampled mip levels: level
l occupies rows [row_offsets[l], row_offsets[l] + size>>l), each level's
row block padded to a multiple of 8.

K2 (`build_face`, csrc/build_face.cu) replaces the Pallas kernel
`_build_face_kernel` (kinfu_tpu/ops/facewarp.py:285-350): one CUDA thread
per stack pixel samples the camera frame along the primed ray of its face
pixel (i<<l, j<<l). `build_face_plain` is its plain PyTorch version, which
computes exactly what `_build_face_jnp` + `_stack_mips` compute.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import rint_index, sqrt32
from kinfu_tpu_torch.ops import kernels


def _align8(n: int) -> int:
    return (n + 7) & ~7


class FaceSpec(NamedTuple):
    """Static geometry of a virtual face image."""

    size: int  # square face, pixels
    focal: float  # virtual focal length, pixels
    levels: int  # mip levels (level 0 = base)

    @property
    def centre(self) -> float:
        return (self.size - 1) / 2.0

    @property
    def level_rows(self) -> tuple:
        """Rows allocated per level in the stack (multiples of 8)."""
        return tuple(_align8(self.size >> l) for l in range(self.levels))

    @property
    def stack_rows(self) -> int:
        return sum(self.level_rows)

    @property
    def row_offsets(self) -> tuple:
        offs, r = [], 0
        for rows in self.level_rows:
            offs.append(r)
            r += rows
        return tuple(offs)


def default_face_spec() -> FaceSpec:
    """640 px face at f=261 with 7 mip levels (the JAX package's default)."""
    return FaceSpec(size=640, focal=261.0, levels=7)


class FaceFrame(NamedTuple):
    """One of the six axis-aligned sweep frames: a signed permutation of the
    volume axes that maps this face's direction to primed +z.

    Primed coords p' = D @ p + offset, `offset` nonzero only on the flipped
    sweep axis. The primed array is `transpose(volume, axes)`, flipped along
    its first axis when `flip`; the kernels index the natural volume through
    this permutation instead of copying it."""

    name: str
    #: 3x3 signed permutation, primed-from-original (rows: x', y', z')
    D: np.ndarray
    #: axes taking the [Z, Y, X] volume to [Z', Y', X']
    axes: Tuple[int, int, int]
    #: flip the primed z (sweep) axis (negative faces)
    flip: bool
    #: ownership comparisons: strict > when comparing |d_z'| against
    #: |d_x'| / |d_y'| (z>y>x tie-break)
    gt_x: bool
    gt_y: bool


def face_frames() -> Tuple[FaceFrame, ...]:
    """The six cube-map sweep frames (kinfu_tpu/ops/facewarp.py:117-159 with
    shard_dim=None; the sharded frame set comes with the sharded step).

    Exclusive voxel ownership (z>y>x priority on ties):
      z owns iff |dz| >= |dy| and |dz| >= |dx|
      y owns iff |dy| >  |dz| and |dy| >= |dx|
      x owns iff |dx| >  |dz| and |dx| >  |dy|
    """
    ex, ey, ez = np.eye(3, dtype=np.float32)
    out = []
    for sign in (1.0, -1.0):
        s = "+" if sign > 0 else "-"
        out.append(FaceFrame(f"{s}z", np.stack([ex, ey, sign * ez]), (0, 1, 2),
                             sign < 0, gt_x=False, gt_y=False))
        out.append(FaceFrame(f"{s}y", np.stack([ex, ez, sign * ey]), (1, 0, 2),
                             sign < 0, gt_x=False, gt_y=True))
        out.append(FaceFrame(f"{s}x", np.stack([ey, ez, sign * ex]), (2, 0, 1),
                             sign < 0, gt_x=True, gt_y=True))
    return tuple(out)


def warp_dims_ok(shape_zyx: Tuple[int, int, int]) -> bool:
    """The JAX package's eligibility rule for the warped kernels (primed
    Zp % 8, Yp % 8, Xp % 128 for every face). The CUDA kernels take any
    shape; the rule is kept so that "auto" picks the same path as JAX."""
    for fr in face_frames():
        Zp, Yp, Xp = (shape_zyx[a] for a in fr.axes)
        if Zp % 8 or Yp % 8 or Xp % 128:
            return False
    return True


def primed_offset(frame: FaceFrame, dims_xyz, voxel_size) -> np.ndarray:
    """Offset of primed coords: (N-1) * voxel on the flipped sweep axis."""
    off = np.zeros(3, np.float32)
    if frame.flip:
        a = int(np.argmax(np.abs(frame.D[2])))  # orig axis of primed z
        off[2] = (dims_xyz[a] - 1) * voxel_size[a]
    return off


def primed_voxel_size(frame: FaceFrame, voxel_size) -> Tuple[float, float, float]:
    """vs'_i = voxel size of the original axis that primed axis i maps to."""
    return tuple(float(voxel_size[int(np.argmax(np.abs(frame.D[i])))]) for i in range(3))


def face_geometry(vol2cam: Pose, frame: FaceFrame, dims_xyz, voxel_size):
    """(A camera-from-primed direction map [3,3], c_primed [3]) for a face
    frame (kinfu_tpu/ops/facewarp.py:193-210)."""
    R, t = vol2cam
    # camera centre in volume coords, -R^T t, summed in the order of XLA's
    # dot (a library matmul may fuse or reorder and move it by an ulp)
    c = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    D = torch.as_tensor(frame.D, dtype=torch.float32, device=R.device)
    off = torch.as_tensor(primed_offset(frame, dims_xyz, voxel_size), device=R.device)
    c_primed = D @ c + off
    A = R @ D.T  # primed -> original volume frame, then to camera
    return A, c_primed


def face_params(A: torch.Tensor, intr: Intrinsics, gate: torch.Tensor,
                spec: FaceSpec) -> torch.Tensor:
    """K2's device parameter block f32[16]: A row-major (9), fx, fy, cx, cy,
    gate (1 = build, 0 = write an empty stack), face focal, face centre."""
    dev = A.device
    tail = torch.tensor([intr.fx, intr.fy, intr.cx, intr.cy], dtype=torch.float32,
                        device=dev)
    face = torch.tensor([spec.focal, spec.centre], dtype=torch.float32, device=dev)
    return torch.cat([A.reshape(-1).float(), tail, gate.reshape(1).float(), face])


def _row_tables(spec: FaceSpec, device):
    """Per stack row: (mip level, row within the level)."""
    lvl = np.zeros(spec.stack_rows, np.int64)
    row = np.zeros(spec.stack_rows, np.int64)
    for l, (rows, off) in enumerate(zip(spec.level_rows, spec.row_offsets)):
        lvl[off : off + rows] = l
        row[off : off + rows] = np.arange(rows)
    return torch.as_tensor(lvl, device=device), torch.as_tensor(row, device=device)


def shade_sample(depth, col, u, v, inb, inv_fx, inv_fy, cx, cy):
    """(range_mm f32, colour i32), both zero where invalid, from a sampled
    (depth, packed colour) at the rounded pixel (u, v). Range r = depth *
    ||K^-1 [u,v,1]|| of the rounded pixel (kinfu_tpu/ops/facewarp.py:235-247;
    the JAX package divides by the static focal lengths, i.e. multiplies by
    their float32 reciprocals, see numerics.py)."""
    lx = (u.float() - cx) * inv_fx
    ly = (v.float() - cy) * inv_fy
    lam = sqrt32(lx * lx + ly * ly + 1.0)
    r_mm = depth * lam * 1000.0
    valid = inb & (depth > 0)
    r_mm = torch.where(valid, torch.clamp(r_mm, 1.0, 32767.0), torch.zeros_like(r_mm))
    return r_mm, torch.where(valid, col, torch.zeros_like(col))


def build_face_plain(depth_m: torch.Tensor, col_packed: torch.Tensor,
                     prm: torch.Tensor, spec: FaceSpec):
    """Plain PyTorch version of K2: (range_mm i16, colour i32), both
    [stack_rows, size]. Every stack pixel (i, j) of level l samples the ray
    of face pixel (i<<l, j<<l); the level padding is zero."""
    h, w = depth_m.shape
    dev = depth_m.device
    lvl, row = _row_tables(spec, dev)
    scale = (1 << lvl).float()[:, None]
    wl = (spec.size >> lvl).float()[:, None]
    ii = row.float()[:, None]
    jj = torch.arange(spec.size, dtype=torch.float32, device=dev)[None, :]
    # the face focal and the camera focals are static in the JAX package:
    # divisions by them are multiplications by float32 reciprocals
    inv_f, c = 1.0 / prm[14], prm[15]
    dpx = (jj * scale - c) * inv_f
    dpy = (ii * scale - c) * inv_f
    a = prm[:9]
    fx, fy, cx, cy = prm[9], prm[10], prm[11], prm[12]
    dcx = a[0] * dpx + a[1] * dpy + a[2]
    dcy = a[3] * dpx + a[4] * dpy + a[5]
    dcz = a[6] * dpx + a[7] * dpy + a[8]
    in_front = dcz > 1e-6
    zs = torch.where(in_front, dcz, torch.ones_like(dcz))
    u = rint_index(dcx / zs * fx + cx)
    v = rint_index(dcy / zs * fy + cy)
    inb = in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    uc = u.clamp(0, w - 1)
    vc = v.clamp(0, h - 1)
    r_mm, col = shade_sample(depth_m[vc, uc], col_packed[vc, uc], u, v, inb,
                             1.0 / fx, 1.0 / fy, cx, cy)
    keep = (ii < wl) & (jj < wl) & (prm[13] != 0)
    range_mm = torch.where(keep, r_mm, torch.zeros_like(r_mm)).to(torch.int16)
    return range_mm, torch.where(keep, col, torch.zeros_like(col))


def build_face(depth_m: torch.Tensor, col_packed: torch.Tensor,
               prm: torch.Tensor, spec: FaceSpec):
    """K2: the mip-stacked face image. CPU tensors take the plain version;
    CUDA tensors launch csrc/build_face.cu."""
    if depth_m.device.type == "cpu":
        return build_face_plain(depth_m, col_packed, prm, spec)
    kernels.library()
    h, w = depth_m.shape
    kernels.check_cuda("build_face", depth_m, col_packed, prm)
    kernels.check("build_face", depth_m, torch.float32, (h, w))
    kernels.check("build_face", col_packed, torch.int32, (h, w))
    kernels.check("build_face", prm, torch.float32, (16,))
    range_mm = torch.empty((spec.stack_rows, spec.size), dtype=torch.int16,
                           device=depth_m.device)
    color = torch.empty((spec.stack_rows, spec.size), dtype=torch.int32,
                        device=depth_m.device)
    kernels.launch(
        "kinfu_build_face",
        kernels.ptr(depth_m), kernels.ptr(col_packed), kernels.ptr(prm),
        kernels.ptr(range_mm), kernels.ptr(color),
        h, w, spec.size, spec.levels,
    )
    return range_mm, color
