"""Axis-aligned virtual-camera range images ("faces") for separable fusion
(port of kinfu_tpu/ops/facewarp.py), and kernel K2 that builds them.

The depth frame is resampled once per frame into a virtual pinhole camera
at the camera centre with an axis-aligned orientation in (primed) volume
coordinates, so the voxel -> face-pixel map of the fusion sweep is affine
per plane. The face stores range r = ||p_obs - c|| in int16 millimetres
and the packed colour, as a stack of nearest-subsampled mip levels: level
l occupies rows [row_offsets[l], row_offsets[l] + size>>l), each level's
row block padded to a multiple of 8.

K2 (`build_faces`, csrc/build_face.cu) replaces the Pallas kernel
`_build_face_kernel` (kinfu_tpu/ops/facewarp.py:285-350): one launch builds
the stacks of all six faces, a CUDA thread per level-0 face pixel, which
also writes that pixel's value into every mip level that holds it, and
reduces each face's largest range on the card. `build_faces_plain` is its
plain PyTorch version: six `build_face_plain` stacks, each of which computes
exactly what `_build_face_jnp` + `_stack_mips` compute.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.geometry.intrinsics import Intrinsics
from kinfu_tpu_torch.geometry.se3 import Pose
from kinfu_tpu_torch.numerics import rint_index, sqrt32
from kinfu_tpu_torch.ops import kernels


#: the cube faces a frame is fused through
FACES = 6


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


@functools.lru_cache(maxsize=None)
def _frame_tensors(name: str, axes, flip: bool, dims_xyz, voxel_size, device):
    frame = next(fr for fr in face_frames() if (fr.name, fr.axes, fr.flip) == (name, axes, flip))
    return (constant(frame.D, torch.float32, device),
            constant(primed_offset(frame, dims_xyz, voxel_size), torch.float32, device))


def frame_tensors(frame: FaceFrame, dims_xyz, voxel_size, device):
    """(D [3,3], primed offset [3]) of a face frame on `device`, built once
    per frame, volume and device (no host copy in the step)."""
    return _frame_tensors(frame.name, frame.axes, frame.flip, tuple(dims_xyz),
                          tuple(voxel_size), torch.device(device))


def face_geometry(vol2cam: Pose, frame: FaceFrame, dims_xyz, voxel_size):
    """(A camera-from-primed direction map [3,3], c_primed [3]) for a face
    frame (kinfu_tpu/ops/facewarp.py:193-210)."""
    R, t = vol2cam
    # camera centre in volume coords, -R^T t, summed in the order of XLA's
    # dot (a library matmul may fuse or reorder and move it by an ulp)
    c = -(R[0] * t[0] + R[1] * t[1] + R[2] * t[2])
    D, off = frame_tensors(frame, dims_xyz, voxel_size, R.device)
    c_primed = D @ c + off
    A = R @ D.T  # primed -> original volume frame, then to camera
    return A, c_primed


@functools.lru_cache(maxsize=None)
def _face_param_tail(intr: Intrinsics, focal: float, centre: float, device):
    return (constant([intr.fx, intr.fy, intr.cx, intr.cy], torch.float32, device),
            constant([focal, centre], torch.float32, device))


def face_params(A: torch.Tensor, intr: Intrinsics, gate: torch.Tensor,
                spec: FaceSpec) -> torch.Tensor:
    """K2's device parameter block f32[16]: A row-major (9), fx, fy, cx, cy,
    gate (1 = build, 0 = write an empty stack), face focal, face centre."""
    cam, face = _face_param_tail(intr, float(spec.focal), float(spec.centre), A.device)
    return torch.cat([A.reshape(-1).float(), cam, gate.reshape(1).float(), face])


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


def _ray_pixels(prm: torch.Tensor, jj: torch.Tensor, ii: torch.Tensor, h: int, w: int):
    """(u, v, in bounds): the rounded camera pixel of the primed ray through
    face coordinates (jj, ii) (face pixel numbers, float32), from K2's
    parameter block."""
    # the face focal and the camera focals are static in the JAX package:
    # divisions by them are multiplications by float32 reciprocals
    inv_f, c = 1.0 / prm[14], prm[15]
    dpx = (jj - c) * inv_f
    dpy = (ii - c) * inv_f
    a = prm[:9]
    fx, fy, cx, cy = prm[9], prm[10], prm[11], prm[12]
    dcx = a[0] * dpx + a[1] * dpy + a[2]
    dcy = a[3] * dpx + a[4] * dpy + a[5]
    dcz = a[6] * dpx + a[7] * dpy + a[8]
    in_front = dcz > 1e-6
    zs = torch.where(in_front, dcz, torch.ones_like(dcz))
    u = rint_index(dcx / zs * fx + cx)
    v = rint_index(dcy / zs * fy + cy)
    return u, v, in_front & (u >= 0) & (u < w) & (v >= 0) & (v < h)


def build_face_plain(depth_m: torch.Tensor, col_packed: torch.Tensor,
                     prm: torch.Tensor, spec: FaceSpec):
    """Plain PyTorch version of K2 for one face: (range_mm i16, colour
    i32), both [stack_rows, size]. Every stack pixel (i, j) of level l
    samples the ray of face pixel (i<<l, j<<l); the level padding is zero,
    and so is the whole stack where the gate prm[13] is 0."""
    h, w = depth_m.shape
    dev = depth_m.device
    lvl, row = _row_tables(spec, dev)
    scale = (1 << lvl).float()[:, None]
    wl = (spec.size >> lvl).float()[:, None]
    ii = row.float()[:, None]
    jj = torch.arange(spec.size, dtype=torch.float32, device=dev)[None, :]
    u, v, inb = _ray_pixels(prm, jj * scale, ii * scale, h, w)
    uc = u.clamp(0, w - 1)
    vc = v.clamp(0, h - 1)
    fx, fy, cx, cy = prm[9], prm[10], prm[11], prm[12]
    r_mm, col = shade_sample(depth_m[vc, uc], col_packed[vc, uc], u, v, inb,
                             1.0 / fx, 1.0 / fy, cx, cy)
    keep = (ii < wl) & (jj < wl) & (prm[13] != 0)
    range_mm = torch.where(keep, r_mm, torch.zeros_like(r_mm)).to(torch.int16)
    return range_mm, torch.where(keep, col, torch.zeros_like(col))


def face_reads(prm: torch.Tensor, spec: FaceSpec, h: int, w: int) -> torch.Tensor:
    """bool [h, w]: the camera pixels K2 loads (depth and colour) for one
    face, whatever its gate: each level-0 face pixel loads its ray's rounded
    pixel, clipped into the frame, and the mips reuse those loads."""
    n = torch.arange(spec.size, dtype=torch.float32, device=prm.device)
    u, v, _ = _ray_pixels(prm, n[None, :], n[:, None], h, w)
    seen = torch.zeros(h * w, dtype=torch.bool, device=prm.device)
    seen[(v.clamp(0, h - 1) * w + u.clamp(0, w - 1)).reshape(-1)] = True
    return seen.reshape(h, w)


def build_faces_work(prm6: torch.Tensor, spec: FaceSpec, h: int, w: int) -> torch.Tensor:
    """Device count of the camera pixels K2 loads, 8 bytes each, summed
    over the faces whose gate is set (`face_reads`)."""
    total = torch.zeros((), dtype=torch.int64, device=prm6.device)
    for f in range(FACES):
        total = total + torch.where(prm6[f, 13] != 0, face_reads(prm6[f], spec, h, w).sum(), 0)
    return total


def build_faces_plain(depth_m: torch.Tensor, col_packed: torch.Tensor,
                      prm6: torch.Tensor, spec: FaceSpec):
    """Plain PyTorch version of K2 over the six faces: (range_mm i16
    [6, stack_rows, size], colour i32 [6, stack_rows, size], r_max i32 [6]),
    face f built from its parameter block prm6[f] (`face_params`); a face
    whose gate is 0 gets a zero stack and r_max 0."""
    stacks = [build_face_plain(depth_m, col_packed, prm6[f], spec) for f in range(FACES)]
    range_mm = torch.stack([r for r, _ in stacks])
    return (range_mm, torch.stack([c for _, c in stacks]),
            range_mm.flatten(1).amax(dim=1).to(torch.int32))


def build_faces(depth_m: torch.Tensor, col_packed: torch.Tensor,
                prm6: torch.Tensor, spec: FaceSpec):
    """K2: the six faces' mip-stacked images and their largest ranges, in
    one launch. CPU tensors take the plain version; CUDA tensors launch
    csrc/build_face.cu, which writes nothing for a face whose gate is 0
    (its stack is left as allocated and its r_max is 0: the fusion sweep
    reads the same gate first and never reads such a stack)."""
    if depth_m.device.type == "cpu":
        return build_faces_plain(depth_m, col_packed, prm6, spec)
    kernels.library()
    h, w = depth_m.shape
    kernels.check_cuda("build_face", depth_m, col_packed, prm6)
    kernels.check("build_face", depth_m, torch.float32, (h, w))
    kernels.check("build_face", col_packed, torch.int32, (h, w))
    kernels.check("build_face", prm6, torch.float32, (FACES, 16))
    dev = depth_m.device
    shape = (FACES, spec.stack_rows, spec.size)
    range_mm = torch.empty(shape, dtype=torch.int16, device=dev)
    color = torch.empty(shape, dtype=torch.int32, device=dev)
    r_max = torch.empty(FACES, dtype=torch.int32, device=dev)
    kernels.launch(
        "kinfu_build_faces",
        kernels.ptr(depth_m), kernels.ptr(col_packed), kernels.ptr(prm6),
        kernels.ptr(range_mm), kernels.ptr(color), kernels.ptr(r_max),
        h, w, spec.size, spec.levels, key="build_face",
    )
    return range_mm, color, r_max
