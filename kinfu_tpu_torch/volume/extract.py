"""Surface point extraction from the TSDF volume (port of
kinfu_tpu/volume/extract.py).

The crossing rule of the reference (tsdf_volume.cu:330-421): along +x, +y
and +z, a crossing lies between two voxels that both have weight != 0 and
tsdf != 1 and opposite TSDF signs; the point interpolates by
|F| / (|F| + |F_neighbour|) from the voxel centre ((index + 0.5) *
voxel_size, the +0.5 convention of the reference's extraction) and is moved
into the world frame by the volume pose.

The order of the points is the JAX package's (DIVERGENCES 14): all
x-axis crossings, then y, then z, each in C order over [Z, Y, X], as
`jnp.nonzero(size=N)` compacts them; the output is padded to `max_points`
with zeros, with the count beside it. The port compacts first and computes
positions only for the crossings it keeps, which gives the same points
without a float position for every voxel of the volume (4.8 GB at 512^3).
It reads the number of crossings back to the host once per call: export is
not per-frame.
"""

from __future__ import annotations

from typing import Tuple

import torch

from kinfu_tpu_torch.config import KinFuParams
from kinfu_tpu_torch.geometry.se3 import Pose, transform_points
from kinfu_tpu_torch.volume.tsdf import TSDFVolume, tsdf_to_float

_AXES = ((0, (0, 0, 1)), (1, (0, 1, 0)), (2, (1, 0, 0)))  # (xyz axis, (dz, dy, dx))


def _crossings(vol: TSDFVolume, params: KinFuParams, max_points: int, with_colors: bool):
    """(positions [n, 3] volume frame, packed colours [n] or None, n) of the
    first n = min(total, max_points) crossings in the JAX package's order."""
    Z, Y, X = vol.tsdf.shape
    dev = vol.tsdf.device
    vs = torch.tensor(params.voxel_size, dtype=torch.float32, device=dev)
    F = tsdf_to_float(vol.tsdf)
    ok = (vol.weight != 0) & (F != 1.0)

    pts, cols, left = [], [], max_points
    for axis, (dz, dy, dx) in _AXES:
        sl_a = (slice(0, Z - dz), slice(0, Y - dy), slice(0, X - dx))
        sl_b = (slice(dz, Z), slice(dy, Y), slice(dx, X))
        Fa, Fb = F[sl_a], F[sl_b]
        crossing = ok[sl_a] & ok[sl_b] & (((Fa > 0) & (Fb < 0)) | ((Fa < 0) & (Fb > 0)))
        idx = torch.nonzero(crossing)[:left]  # [n, 3] (z, y, x), C order
        left -= idx.shape[0]
        iz, iy, ix = idx.unbind(-1)
        fa, fb = Fa[iz, iy, ix], Fb[iz, iy, ix]
        frac = fa.abs() / torch.clamp(fa.abs() + fb.abs(), min=1e-30)
        base = torch.stack([ix, iy, iz], dim=-1).to(torch.float32) + 0.5
        offset = torch.zeros(3, dtype=torch.float32, device=dev)
        offset[axis] = 1.0
        pts.append((base + frac[:, None] * offset) * vs)
        if with_colors:
            # colour of the voxel the crossing point is nearer to
            ca, cb = vol.color[sl_a][iz, iy, ix], vol.color[sl_b][iz, iy, ix]
            cols.append(torch.where(frac < 0.5, ca, cb))
    pts = torch.cat(pts)
    return pts, (torch.cat(cols) if with_colors else None), pts.shape[0]


def _padded(a: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + a.shape[1:], dtype=a.dtype, device=a.device)
    out[: a.shape[0]] = a
    return out


def _extract(vol, volume_pose, params, max_points, with_colors):
    if max_points is None:
        max_points = params.max_extracted_points
    pts, packed, n = _crossings(vol, params, max_points, with_colors)
    sel = _padded(transform_points(volume_pose, pts), max_points)
    count = torch.tensor(n, dtype=torch.int32, device=vol.tsdf.device)
    if not with_colors:
        return sel, count
    packed = _padded(packed, max_points)
    rgb = torch.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF], dim=-1)
    return sel, rgb.to(torch.uint8), count


def extract_points(
    vol: TSDFVolume,
    volume_pose: Pose,
    params: KinFuParams,
    max_points: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(points [N, 3] world frame, count int32). Padded entries are zero."""
    return _extract(vol, volume_pose, params, max_points, with_colors=False)


def extract_points_colored(
    vol: TSDFVolume,
    volume_pose: Pose,
    params: KinFuParams,
    max_points: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Like `extract_points`, with per-point RGB uint8 [N, 3] taken from the
    colour volume at the crossing voxel the point is nearer to."""
    return _extract(vol, volume_pose, params, max_points, with_colors=True)
