"""Streaming (moving) TSDF volume: shift the grid to follow the camera
(port of kinfu_tpu/volume/stream.py).

The reference's world is one cube fixed in space (kinectfusion.cpp:181-184).
Here the dense grid recentres itself by whole voxels when the camera nears a
boundary: content moves inside the arrays, the newly exposed slabs are
zero (voxels that scroll off the far side are discarded), and the volume's
world origin advances by the same amount, so fused geometry stays where it
was in the world.

The shift is a device tensor, so it cannot be a `torch.roll` (which takes
Python ints and would make the step wait for the device every frame). It is
index arithmetic on the device instead: `new[z, y, x] = old[z + sz, y + sy,
x + sx]`, zero where an index falls outside, as one gather per array with
three broadcast index vectors and one select against the product of three
1-D masks. The JAX package shifts x, then y, then z, each a roll and a mask
(L24-47); zero-filled shifts along different axes commute, so the one 3-D
gather gives its bits in one pass over the volume.

`shift_volume` is the plain version and makes new tensors. The step calls
`shift_volume_`, which moves the voxels inside the tensors it is given: on
the card one launch an axis of csrc/shift_volume.cu, which reads its
component of the shift and returns at once when it is 0; on the CPU the
plain version copied back. Each call adds to `SHIFT_COUNTS`.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from kinfu_tpu_torch.device import constant
from kinfu_tpu_torch.numerics import recip
from kinfu_tpu_torch.ops import kernels
from kinfu_tpu_torch.volume.tsdf import TSDFVolume


def _source_index(n: int, s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(index into the old axis, in range) of each new index k: k + s,
    clamped, and whether k + s lies in [0, n)."""
    k = torch.arange(n, dtype=torch.int64, device=s.device) + s.to(torch.int64)
    return k.clamp(0, n - 1), (k >= 0) & (k < n)


def shift_volume(vol: TSDFVolume, shift_xyz: torch.Tensor) -> TSDFVolume:
    """Shift volume content by whole voxels; new tensors, `vol` is left as
    it is. shift_xyz = (sx, sy, sz) int32 on the volume's device: the
    volume origin moves +s voxels along each world axis, so content moves
    -s inside the arrays. Arrays are [Z, Y, X]."""
    Z, Y, X = vol.tsdf.shape
    iz, vz = _source_index(Z, shift_xyz[2])
    iy, vy = _source_index(Y, shift_xyz[1])
    ix, vx = _source_index(X, shift_xyz[0])
    iz, iy, ix = iz[:, None, None], iy[None, :, None], ix[None, None, :]
    keep = vz[:, None, None] & (vy[:, None] & vx[None, :])[None]
    return TSDFVolume(*(torch.where(keep, a[iz, iy, ix], 0) for a in vol))


#: per device, int64 [2] on it: the `shift_volume_` calls, and the calls
#: whose shift had a component other than 0 (voxels moved); added to on the
#: device, so counting waits for nothing, and read once after a run
SHIFT_COUNTS: dict = {}


def shift_counts(device) -> torch.Tensor:
    """The counter of `device` in SHIFT_COUNTS, made at its first use (a
    step's first frame, before any capture)."""
    dev = torch.device(device)
    if dev not in SHIFT_COUNTS:
        SHIFT_COUNTS[dev] = torch.zeros(2, dtype=torch.int64, device=dev)
    return SHIFT_COUNTS[dev]


def shift_volume_(vol: TSDFVolume, shift_xyz: torch.Tensor,
                  counts: torch.Tensor | None = None) -> TSDFVolume:
    """`shift_volume` in place: moves the content of vol's own tensors and
    returns `vol`, so the caller's volume is the shifted one. Adds 1 to
    counts[0] and, where a component of the shift is not 0, to counts[1]
    (default: `shift_counts` of the volume's device). CPU tensors take the
    plain version and copy it back; CUDA tensors launch
    csrc/shift_volume.cu (x, then y, then z; a zero component returns
    without moving a voxel)."""
    dev = vol.tsdf.device
    counts = shift_counts(dev) if counts is None else counts
    if dev.type == "cpu":
        for a, b in zip(vol, shift_volume(vol, shift_xyz)):
            a.copy_(b)
        counts[0] += 1
        counts[1] += (shift_xyz != 0).any()
        return vol
    kernels.library()
    Z, Y, X = vol.tsdf.shape
    kernels.check_cuda("shift_volume", *vol, shift_xyz, counts)
    for name, a, dtype in zip(TSDFVolume._fields, vol, (torch.int16, torch.int16, torch.int32)):
        kernels.check(f"shift_volume {name}", a, dtype, (Z, Y, X))
    kernels.check("shift_volume", shift_xyz, torch.int32, (3,))
    kernels.check("shift_volume", counts, torch.int64, (2,))
    kernels.launch(
        "kinfu_shift_volume", *(kernels.ptr(a) for a in vol), kernels.ptr(shift_xyz),
        kernels.ptr(counts), Z, Y, X, kernels.lengths(*vol, shift_xyz, counts), count=3)
    return vol


@functools.lru_cache(maxsize=None)
def _centering_constants(dims_xyz, voxel_size, margin_frac: float, device):
    """(lo, hi, 1 / voxel size) per axis, float32 on `device`: lo and hi in
    Python floats rounded to float32 once, as JAX's weakly typed constants
    are; the reciprocal because JAX divides by the static voxel size."""
    lo, hi = [], []
    for c in range(3):
        rng = dims_xyz[c] * voxel_size[c]
        lo.append(margin_frac * rng)
        hi.append(rng - lo[-1])
    return (constant(lo, torch.float32, device), constant(hi, torch.float32, device),
            constant([recip(v) for v in voxel_size], torch.float32, device))


def camera_centering_shift(
    cam_pos_vol: torch.Tensor,
    dims_xyz: Tuple[int, int, int],
    voxel_size: Tuple[float, float, float],
    margin_frac: float = 0.25,
) -> torch.Tensor:
    """Whole-voxel shift (int32 [3], x y z) keeping a point inside the
    volume's central box.

    cam_pos_vol: the point in the volume frame (metres, float32 [3] on the
    device). When a coordinate leaves [margin, range - margin], shift by
    the excess, rounded half to even to voxels, so that it lands back on
    the nearest margin. A NaN coordinate fails both comparisons and gives
    a shift of 0."""
    lo, hi, inv_vs = _centering_constants(tuple(dims_xyz), tuple(voxel_size), margin_frac,
                                          cam_pos_vol.device)
    p = cam_pos_vol
    excess = torch.where(p < lo, p - lo, torch.where(p > hi, p - hi, 0.0))
    return torch.round(excess * inv_vs).to(torch.int32)
